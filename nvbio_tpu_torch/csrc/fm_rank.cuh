// The rank step of the FM walks (fm_search.cu), over fmi/rank.py's
// interleaved rows: one 32-byte row per 64-symbol block,
//
//   row b = [occ_A, occ_C, occ_G, occ_T | the block's 4 packed BWT words]
//
// (uint32 bits in int32 storage; symbol s of a word in bits [2s, 2s+2)).
// A row is one 32-byte sector, read as two 16-byte __ldg's. Occurrences of
// c among a row's first rem symbols: each word XORed with c's 2-bit
// pattern, a match bit per symbol (the low bit of each all-zero field), cut
// at rem and counted with __popc — the SWAR sums of fmi/rank.py's
// _count_matches, bit for bit.
//
// Intervals and rows are uint32: a text has n < 2^31 - 1 symbols (the
// index's int32 counts), so every row and interval end (<= n + 1) fits.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fm {

constexpr uint32_t kEven = 0x55555555u;

struct Row {
  uint32_t occ[4];   // symbol counts of bwt[0 : 64 b)
  uint32_t w[4];     // bwt[64 b : 64 (b + 1)), 16 symbols a word
};

// The rank rows and what a step needs beside them: C[c] (count[0..3]),
// the primary row and the number of rows (blocks are clamped into it, as
// fmi/rank.py's _row clamps its gather).
struct Index {
  const int4* __restrict__ rows;
  uint32_t n_rows;
  uint32_t primary;
};

__device__ __forceinline__ Row load_row(const Index& ix, uint32_t block) {
  const int4* p = ix.rows + 2 * size_t(block);
  const int4 a = __ldg(p);
  const int4 b = __ldg(p + 1);
  Row r;
  r.occ[0] = uint32_t(a.x); r.occ[1] = uint32_t(a.y);
  r.occ[2] = uint32_t(a.z); r.occ[3] = uint32_t(a.w);
  r.w[0] = uint32_t(b.x); r.w[1] = uint32_t(b.y);
  r.w[2] = uint32_t(b.z); r.w[3] = uint32_t(b.w);
  return r;
}

// v[c] for c in 0..3 without a local-memory array
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], uint32_t c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}

// row of the full BWT -> position in the stored BWT ($ removed)
__device__ __forceinline__ uint32_t adjust(const Index& ix, uint32_t i) {
  return i - (i > ix.primary ? 1u : 0u);
}

// the block of stored position a, clamped to the last row, and a's offset
// in it (>= 64 only past a clamp, where every word counts whole)
__device__ __forceinline__ uint32_t block_of(const Index& ix, uint32_t a) {
  return min(a >> 6, ix.n_rows - 1);
}

// occurrences of c among the first rem symbols of the row's words
__device__ __forceinline__ uint32_t count_in_row(const Row& r, uint32_t c,
                                                 uint32_t rem) {
  const uint32_t pat = c * kEven;
  uint32_t n = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int m = min(max(int(min(rem, 64u)) - 16 * w, 0), 16);
    const uint32_t cut = m == 16 ? 0xFFFFFFFFu : (1u << (2 * m)) - 1u;
    const uint32_t x = r.w[w] ^ pat;
    n += __popc(~(x | (x >> 1)) & kEven & cut);
  }
  return n;
}

// rank(c, a) from a's row
__device__ __forceinline__ uint32_t rank_in_row(const Row& r, uint32_t c,
                                                uint32_t rem) {
  return pick4(r.occ, c) + count_in_row(r, c, rem);
}

// One backward-search step (fmi/search.py's step_backward): prepend c
// (in 0..3) to the matched suffix; C[c] + rank(c, .) at both ends, one
// row read when both ends fall in one block.
__device__ __forceinline__ void step(const Index& ix, const uint32_t* cnt,
                                     uint32_t c, uint32_t& lo, uint32_t& hi) {
  const uint32_t a = adjust(ix, lo), b = adjust(ix, hi);
  const uint32_t ba = block_of(ix, a), bb = block_of(ix, b);
  const Row ra = load_row(ix, ba);
  const uint32_t rlo = rank_in_row(ra, c, a - 64 * ba);
  uint32_t rhi;
  if (bb == ba) {
    rhi = rank_in_row(ra, c, b - 64 * bb);
  } else {
    const Row rb = load_row(ix, bb);
    rhi = rank_in_row(rb, c, b - 64 * bb);
  }
  lo = cnt[c] + rlo;
  hi = cnt[c] + rhi;
}

// ranks of all four symbols at stored position a (fmi/rank.py's rank_all)
__device__ __forceinline__ void rank_all(const Index& ix, uint32_t a,
                                         uint32_t (&out)[4]) {
  const uint32_t blk = block_of(ix, a);
  const Row r = load_row(ix, blk);
#pragma unroll
  for (uint32_t c = 0; c < 4; ++c) out[c] = rank_in_row(r, c, a - 64 * blk);
}

// (bwt[a], rank(bwt[a], a)) from one row: the LF step of locate
// (fmi/rank.py's symbol_and_rank); past the text the symbol reads 0
__device__ __forceinline__ uint32_t symbol_and_rank(const Index& ix,
                                                    uint32_t a, uint32_t& c) {
  const uint32_t blk = block_of(ix, a);
  const Row r = load_row(ix, blk);
  const uint32_t rem = a - 64 * blk;
  const uint32_t wi = rem >> 4;   // < 4 for every unclamped block
  const uint32_t word = wi == 0 ? r.w[0] : wi == 1 ? r.w[1]
                        : wi == 2 ? r.w[2] : r.w[3];
  c = (word >> (2 * (rem & 15))) & 3u;
  return rank_in_row(r, c, rem);
}

}  // namespace fm
