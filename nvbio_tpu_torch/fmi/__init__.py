"""FM-index: rank dictionary, index container, batched search (exact,
1- and k-mismatch), bidirectional extension, SMEMs and the protein
(wavelet-tree) FM index."""
