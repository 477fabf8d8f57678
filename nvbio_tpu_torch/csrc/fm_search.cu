// FM-index walks, one lane a thread: backward search, the sampled-SA locate
// and the reseed pass's 1-mismatch hybrid top-K search
// (nvbio_tpu_torch/fmi/search.py: backward_search_core, locate_core,
// search_1mm_hybrid_topk; the plain versions beside them there).
//
// Replaces no TPU kernel: the JAX package runs these walks as jnp scans
// (nvbio_tpu/fmi/search.py), and the port ran them as Python loops of a
// fixed trip count, ~20 torch ops over every lane a step, each writing its
// intermediate to device memory (int64 copies of every 32-byte row, masks,
// popcount partials), and lanes that were done or empty gathered at
// (0, 0) until the loop ended.
//
// Design: a thread owns a lane for its whole walk. Its interval (or row)
// stays in registers; each step reads the rank rows it needs as 32-byte
// sectors (fm_rank.cuh: two 16-byte __ldg's a row, one row when lo and hi
// share a block), counts with __popc on 2-bit match masks, and the lane
// leaves its loop as soon as it is done or empty. Results equal the plain
// versions' bit for bit, edge values included (clamps, rows 0, primary and
// n, lengths 0 and below the table's k, unresolved walks).
//
// What bounds it on an H100: dependent random reads. A step's row address
// comes from the previous step's ranks, so a lane has one read chain in
// flight, and the card hides the latency only by the lanes resident: the
// kernels keep few registers (36, 27 and 57, no spills) so that many
// 256-thread blocks share an SM. chip_smoke.py's [fm-kernels] sets each
// launch's time against the sectors the data needs x 32 B / 3.35 TB/s: at
// least one a step of a search, two a step of a locate (it counts the
// steps), plus the inputs and outputs. That is a floor only if every
// sector came from HBM, and it is not one: the rank rows of a 100 Mbp
// genome (50 MB) are about the L2's size, so many reads hit the L2, whose
// share no tool on the card reports; and it counts every query row whole,
// though lanes that leave early read less of theirs.
//
// Three entries (extern "C" below), each with an optional per-lane int16
// output of the steps the lane took (null: not counted):
//   * nvbt_fm_backward_search: queries (B, L) int32, lengths int32 or int64;
//     with a k-symbol table, lanes of length >= k start from their k-symbol
//     suffix's interval, the rest from the full range; at most n_steps
//     steps (the plain loop's trip count).
//   * nvbt_fm_locate: rows (B,) int64 clamped to [0, n]; an LF walk of at
//     most sa_interval steps to a marked row (the SSA marks word and its
//     exclusive popcount, one 8-byte row), then one sampled value.
//   * nvbt_fm_search_1mm_topk: the exact walk over L steps keeps its states
//     at the positions j < A (in a scratch of the wrapper's, [slot][lane]);
//     then, for j ascending, the 4-way extension of the state before j
//     (both ends' rows once) gives the three substituted branches in delta
//     order; each nonempty one is a survivor and walks its j remaining
//     symbols at once, until K are found. That is the plain version's
//     top_k_stable on score A - j (ties in index order): the first K
//     nonempty (j, delta) in index order; empty slots hold lo = hi = 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "fm_rank.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load_counts(const int64_t* count,
                                            uint32_t* cnt) {
  if (threadIdx.x < 4) cnt[threadIdx.x] = uint32_t(count[threadIdx.x]);
  __syncthreads();
}

__device__ __forceinline__ uint32_t sym(int32_t c) {
  return uint32_t(min(max(c, 0), 3));
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int64_t qlen_of(const void* qlens, int qlen64,
                                           int64_t b) {
  return qlen64 ? static_cast<const int64_t*>(qlens)[b]
                : int64_t(static_cast<const int32_t*>(qlens)[b]);
}

__device__ __forceinline__ void put_steps(int16_t* steps, int64_t b,
                                          int s) {
  if (steps) steps[b] = int16_t(min(s, 32767));
}

__global__ void __launch_bounds__(kThreads)
backward_search_kernel(const int32_t* __restrict__ q, int L,
                       const void* __restrict__ qlens, int qlen64, int64_t B,
                       fm::Index ix, const int64_t* __restrict__ count,
                       uint32_t n, const int32_t* __restrict__ ftab_lo,
                       const int32_t* __restrict__ ftab_hi, int k,
                       int n_steps, int64_t* __restrict__ out_lo,
                       int64_t* __restrict__ out_hi,
                       int16_t* __restrict__ steps) {
  __shared__ uint32_t cnt[4];
  load_counts(count, cnt);
  const int64_t b = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  const int32_t* qb = q + b * L;
  const int64_t qlen = qlen_of(qlens, qlen64, b);
  uint32_t lo = 0, hi = n + 1;
  int64_t qeff = qlen;
  if (k > 0 && qlen >= k) {
    // the key of the k-symbol suffix: leftmost symbol in the high bits,
    // symbols folded with min(., 3), the sum clamped into the table
    const int64_t j0 = clamp64(qlen - k, 0, L - k);
    int64_t key = 0;
    for (int u = 0; u < k; ++u)
      key += int64_t(min(__ldg(qb + j0 + u), 3)) *
             (int64_t(1) << (2 * (k - 1 - u)));
    key = clamp64(key, 0, (int64_t(1) << (2 * k)) - 1);
    lo = uint32_t(__ldg(ftab_lo + key));
    hi = uint32_t(__ldg(ftab_hi + key));
    qeff = qlen - k;
  }
  int s = 0;
  for (; s < n_steps && s < qeff && hi > lo; ++s) {
    const int64_t j = clamp64(qeff - 1 - s, 0, L - 1);
    fm::step(ix, cnt, sym(__ldg(qb + j)), lo, hi);
  }
  out_lo[b] = lo;
  out_hi[b] = hi;
  put_steps(steps, b, s);
}

__global__ void __launch_bounds__(kThreads)
locate_kernel(const int64_t* __restrict__ rows, int64_t B, fm::Index ix,
              const int64_t* __restrict__ count, uint32_t n,
              const int2* __restrict__ ssa, int64_t n_words,
              const int32_t* __restrict__ vals, int64_t n_vals,
              int sa_interval, int64_t* __restrict__ out_pos,
              bool* __restrict__ out_done, int16_t* __restrict__ steps) {
  __shared__ uint32_t cnt[4];
  load_counts(count, cnt);
  const int64_t b = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  uint32_t i = uint32_t(clamp64(rows[b], 0, n));
  int t = 0;
  bool done = false;
  int64_t mrank = 0;
  for (; t < sa_interval; ++t) {
    const int2 m = __ldg(ssa + clamp64(int64_t(i >> 5), 0, n_words - 1));
    const uint32_t w = uint32_t(m.x), bit = i & 31u;
    if ((w >> bit) & 1u) {
      mrank = int64_t(m.y) + __popc(w & ((1u << bit) - 1u));
      done = true;
      break;
    }
    uint32_t c;
    const uint32_t rk = fm::symbol_and_rank(ix, fm::adjust(ix, i), c);
    i = cnt[c] + rk;
  }
  out_pos[b] = done ? int64_t(__ldg(vals + clamp64(mrank, 0, n_vals - 1))) + t
                    : 0;
  out_done[b] = done;
  put_steps(steps, b, done ? t + 1 : t);
}

// The branch (j, delta) of a state (blo, bhi): C[x] + rank(x, .) at both
// ends for x = (q[j] + delta) mod 4 (Python's mod), from the ranks of all
// four symbols at both ends.
__global__ void __launch_bounds__(kThreads)
topk_kernel(const int32_t* __restrict__ q, int L,
            const void* __restrict__ qlens, int qlen64, int64_t B,
            fm::Index ix, const int64_t* __restrict__ count, uint32_t n,
            int A, int K, uint2* __restrict__ states,
            int64_t* __restrict__ exact_lo, int64_t* __restrict__ exact_hi,
            int64_t* __restrict__ mm_lo, int64_t* __restrict__ mm_hi,
            int16_t* __restrict__ steps) {
  __shared__ uint32_t cnt[4];
  load_counts(count, cnt);
  const int64_t b = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  const int32_t* qb = q + b * L;
  const int64_t qlen = qlen_of(qlens, qlen64, b);
  // the walk's states wanted: before step t_j = clamp(qlen-1-j, 0, L-1) for
  // j in [0, jn), kept at slot t - t_lo
  const int jn = int(clamp64(qlen, 0, A));
  const int64_t t_hi = clamp64(qlen - 1, 0, L - 1);
  const int64_t t_lo = clamp64(qlen - jn, 0, L - 1);
  uint32_t lo = 0, hi = n + 1;
  int s = 0;
  for (; s < L; ++s) {
    if (jn > 0 && s >= t_lo && s <= t_hi)
      states[(s - t_lo) * B + b] = make_uint2(lo, hi);
    if (!(s < qlen && hi > lo)) break;
    fm::step(ix, cnt, sym(__ldg(qb + clamp64(qlen - 1 - s, 0, L - 1))), lo,
             hi);
  }
  exact_lo[b] = lo;
  exact_hi[b] = hi;
  // states past the walk's end are its last one
  const int s_end = s;
  int n_steps = s;
  int found = 0;
  int64_t* olo = mm_lo + b * K;
  int64_t* ohi = mm_hi + b * K;
  for (int j = 0; j < jn && found < K; ++j) {
    const int64_t t = clamp64(qlen - 1 - j, 0, L - 1);
    uint32_t blo = lo, bhi = hi;
    if (t <= s_end && t < L) {
      const uint2 st = states[(t - t_lo) * B + b];
      blo = st.x;
      bhi = st.y;
    }
    if (!(bhi > blo)) continue;
    ++n_steps;
    uint32_t rlo[4], rhi[4];
    fm::rank_all(ix, fm::adjust(ix, blo), rlo);
    fm::rank_all(ix, fm::adjust(ix, bhi), rhi);
    const int32_t base = __ldg(qb + j);
    for (int d = 1; d <= 3 && found < K; ++d) {
      const uint32_t x = uint32_t(((base % 4) + d + 4) % 4);
      uint32_t clo = cnt[x] + fm::pick4(rlo, x);
      uint32_t chi = cnt[x] + fm::pick4(rhi, x);
      if (!(chi > clo)) continue;
      // a survivor: walk its j remaining symbols (j-1-u at step u)
      for (int u = 0; u < j && chi > clo; ++u, ++n_steps)
        fm::step(ix, cnt, sym(__ldg(qb + clamp64(j - 1 - u, 0, L - 1))),
                 clo, chi);
      const bool empty = chi <= clo;
      olo[found] = empty ? 0 : clo;
      ohi[found] = empty ? 0 : chi;
      ++found;
    }
  }
  for (; found < K; ++found) {
    olo[found] = 0;
    ohi[found] = 0;
  }
  put_steps(steps, b, n_steps);
}

unsigned grid_of(int64_t B) { return unsigned((B + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// queries: (B, L) int32; qlens: (B,) int32 (qlen64 = 0) or int64 (1);
// rank_rows: (n_rows, 8) int32, 16-byte aligned; count: int64[>= 4];
// ftab_lo/hi: int32[4^k] where k > 0 (the wrapper passes k = 0 where the
// plain version takes the full-range start); out_lo/hi: (B,) int64; steps:
// (B,) int16 or null. Returns 0, or the cudaError_t of a failed launch.
int nvbt_fm_backward_search(const void* q, int L, const void* qlens,
                            int qlen64, int64_t B, const void* rank_rows,
                            int64_t n_rows, const void* count, int64_t primary,
                            int64_t n, const void* ftab_lo,
                            const void* ftab_hi, int k, int n_steps,
                            void* out_lo, void* out_hi, void* steps,
                            void* stream) {
  const fm::Index ix{static_cast<const int4*>(rank_rows), uint32_t(n_rows),
                     uint32_t(primary)};
  backward_search_kernel<<<grid_of(B), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), L, qlens, qlen64, B, ix,
      static_cast<const int64_t*>(count), uint32_t(n),
      static_cast<const int32_t*>(ftab_lo),
      static_cast<const int32_t*>(ftab_hi), k, n_steps,
      static_cast<int64_t*>(out_lo), static_cast<int64_t*>(out_hi),
      static_cast<int16_t*>(steps));
  return cudaGetLastError();
}

// rows: (B,) int64; ssa_rows: (n_words, 2) int32; ssa_vals: int32[n_vals];
// out_pos: (B,) int64; out_done: (B,) bool.
int nvbt_fm_locate(const void* rows, int64_t B, const void* rank_rows,
                   int64_t n_rows, const void* count, int64_t primary,
                   int64_t n, const void* ssa_rows, int64_t n_words,
                   const void* ssa_vals, int64_t n_vals, int sa_interval,
                   void* out_pos, void* out_done, void* steps,
                   void* stream) {
  const fm::Index ix{static_cast<const int4*>(rank_rows), uint32_t(n_rows),
                     uint32_t(primary)};
  locate_kernel<<<grid_of(B), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rows), B, ix,
      static_cast<const int64_t*>(count), uint32_t(n),
      static_cast<const int2*>(ssa_rows), n_words,
      static_cast<const int32_t*>(ssa_vals), n_vals, sa_interval,
      static_cast<int64_t*>(out_pos), static_cast<bool*>(out_done),
      static_cast<int16_t*>(steps));
  return cudaGetLastError();
}

// queries/qlens as nvbt_fm_backward_search's; A = min(n_approx, L); K the
// output slots (min(K, 3A)); states: (max(A, 1), B) uint2 scratch;
// exact_lo/hi: (B,) int64; mm_lo/hi: (B, K) int64.
int nvbt_fm_search_1mm_topk(const void* q, int L, const void* qlens,
                            int qlen64, int64_t B, const void* rank_rows,
                            int64_t n_rows, const void* count,
                            int64_t primary, int64_t n, int A, int K,
                            void* states, void* exact_lo, void* exact_hi,
                            void* mm_lo, void* mm_hi, void* steps,
                            void* stream) {
  const fm::Index ix{static_cast<const int4*>(rank_rows), uint32_t(n_rows),
                     uint32_t(primary)};
  topk_kernel<<<grid_of(B), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), L, qlens, qlen64, B, ix,
      static_cast<const int64_t*>(count), uint32_t(n), A, K,
      static_cast<uint2*>(states), static_cast<int64_t*>(exact_lo),
      static_cast<int64_t*>(exact_hi), static_cast<int64_t*>(mm_lo),
      static_cast<int64_t*>(mm_hi), static_cast<int16_t*>(steps));
  return cudaGetLastError();
}

}  // extern "C"
