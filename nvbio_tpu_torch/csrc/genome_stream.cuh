// Reading windows of the 2-bit packed genome (symbol j in bits 2*(j%16) of
// word j/16, LSB first), shared by the kernels that fetch their text from it:
// K1 (banded_score_cands.cu), K3's packed-window entry (banded_score.cu) and
// K4's (myers_semiglobal.cu).
//
// A word past the genome's last one reads as 0, so a window gives exactly
// the symbols that `packed.extract_window` (align/kernels.py's plain
// versions) gives, 0 past the last word included.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ words,
                                              int64_t n_words, int64_t wi) {
  return wi < n_words ? __ldg(words + wi) : 0u;
}

__device__ __forceinline__ int genome_sym(const uint32_t* __restrict__ words,
                                          int64_t n_words, int64_t j) {
  return int((load_word(words, n_words, j >> 4) >> ((j & 15) * 2)) & 3u);
}

// The symbols q, q+1, ... of one window: two words in registers, one load
// per 16 symbols taken, issued 16 symbols before it is needed.
struct SymStream {
  uint32_t lo, hi;
  int64_t wi;  // index of lo
  int s;       // position of the next symbol in lo
};

__device__ __forceinline__ SymStream stream_at(const uint32_t* __restrict__ words,
                                               int64_t n_words, int64_t q) {
  SymStream st;
  st.wi = q >> 4;
  st.s = int(q & 15);
  st.lo = load_word(words, n_words, st.wi);
  st.hi = load_word(words, n_words, st.wi + 1);
  return st;
}

// the next N (1..16) symbols, 2 bits each, the first in the low bits (bits
// past 2N hold the symbols after them)
template <int N>
__device__ __forceinline__ uint32_t stream_take(SymStream& st,
                                                const uint32_t* __restrict__ words,
                                                int64_t n_words) {
  static_assert(N >= 1 && N <= 16, "at most one word of symbols a take");
  const uint32_t bits = __funnelshift_r(st.lo, st.hi, 2 * st.s);
  st.s += N;
  if (st.s >= 16) {
    st.s -= 16;
    st.lo = st.hi;
    st.wi += 1;
    st.hi = load_word(words, n_words, st.wi + 1);
  }
  return bits;
}
