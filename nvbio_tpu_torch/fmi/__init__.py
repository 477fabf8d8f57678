"""FM-index: rank dictionary, index container and batched search."""
