// Native q-gram index builder: counting sort of text positions by q-gram key.
//
// Host-side counterpart of the reference's device q-gram index construction
// (nvbio/qgram/qgram.h:414-662 builds the sorted q-gram
// table with CUB radix sorts). The direct-address layout (4^q bucket
// offsets + positions sorted by key) needs no comparison sort at all: one
// histogram pass + one scatter pass over rolling 2-bit keys, O(n + 4^q).
//
// The numpy builder of the JAX package (nvbio_tpu/qgram.py) remains the
// golden model; this engine exists because a 100 Mbp genome takes minutes
// through numpy's comparison argsort but seconds through a counting sort.

#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// Build the sorted-position q-gram table.
//   codes     : n bytes, 2-bit DNA codes (values 0..3; anything else is
//               masked &3 — ambiguous bases must be marked via n_flags)
//   n_flags   : n bytes, nonzero = ambiguous base (may be nullptr); q-grams
//               overlapping a flagged base are excluded (DNA_N semantics)
//   offsets   : uint32[(1<<2q) + 1] out, bucket start offsets
//   positions : uint32[n - q + 1] out, text positions sorted by (key, pos)
// Returns the number of positions written, or a negative error code.
int64_t nvbio_tpu_qgram_build(const uint8_t* codes, int64_t n, int32_t q,
                              const uint8_t* n_flags, uint32_t* offsets,
                              uint32_t* positions) {
  if (q < 1 || q > 15) return -1;
  const int64_t npos = n - q + 1;
  const int64_t nb = int64_t(1) << (2 * q);
  if (npos <= 0) {
    std::memset(offsets, 0, size_t(nb + 1) * sizeof(uint32_t));
    return 0;
  }
  if (npos >= int64_t(1) << 32) return -2;  // uint32 position overflow

  const uint32_t mask = uint32_t((int64_t(1) << (2 * q)) - 1);

  uint32_t* counts = new (std::nothrow) uint32_t[size_t(nb)];
  if (!counts) return -3;
  std::memset(counts, 0, size_t(nb) * sizeof(uint32_t));

  // pass 1: histogram over rolling keys (big-endian: first symbol in the
  // high bits, matching qgram_keys in qgram.py)
  {
    uint32_t key = 0;
    int64_t last_n = -1;  // most recent flagged position seen
    for (int64_t j = 0; j < q - 1; ++j) {
      key = (key << 2) | uint32_t(codes[j] & 3);
      if (n_flags && n_flags[j]) last_n = j;
    }
    for (int64_t i = 0; i < npos; ++i) {
      const int64_t j = i + q - 1;  // window end
      key = ((key << 2) | uint32_t(codes[j] & 3)) & mask;
      if (n_flags && n_flags[j]) last_n = j;
      if (last_n < i) ++counts[key];
    }
  }

  // exclusive scan -> offsets
  {
    uint64_t run = 0;
    for (int64_t b = 0; b < nb; ++b) {
      offsets[b] = uint32_t(run);
      run += counts[b];
    }
    offsets[nb] = uint32_t(run);
  }

  // pass 2: scatter positions at each bucket's running cursor (positions
  // visited in increasing order => within-bucket positions come out sorted)
  uint32_t* cur = counts;  // reuse: cursor = offsets[b], rebuilt below
  std::memcpy(cur, offsets, size_t(nb) * sizeof(uint32_t));
  {
    uint32_t key = 0;
    int64_t last_n = -1;
    for (int64_t j = 0; j < q - 1; ++j) {
      key = (key << 2) | uint32_t(codes[j] & 3);
      if (n_flags && n_flags[j]) last_n = j;
    }
    for (int64_t i = 0; i < npos; ++i) {
      const int64_t j = i + q - 1;
      key = ((key << 2) | uint32_t(codes[j] & 3)) & mask;
      if (n_flags && n_flags[j]) last_n = j;
      if (last_n < i) positions[cur[key]++] = uint32_t(i);
    }
  }
  const int64_t written = int64_t(offsets[nb]);
  delete[] counts;
  return written;
}

}  // extern "C"
