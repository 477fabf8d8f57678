// Candidate scoring kernel (K1): SEMI_GLOBAL banded affine-gap (Gotoh)
// scores of every (read, candidate slot) pair, text read straight from the
// 2-bit packed genome.
//
// Replaces the TPU kernel `banded_score_cands_regtile` / `_regtile_cand_kernel`
// (nvbio_tpu/align/pallas_kernels.py:963 / :886). Same function: for read b
// and slot c the pattern is the read when c < NCH, else its reverse
// complement; per-position mismatch penalties; the text window starts at
// w0[b, c] and cells at or past wlens[b, c] are masked to NEG_INF. Outputs
// are (B, C): the best final-row score and `kbest`, the first band index at
// which it is hit. The recurrence is the TPU kernel's, cell for cell
// (pallas_kernels.py:909-958): diag, then E from band k+1 (NEG_INF at the
// band edge), then the sequential same-row F when te >= to (the lazy
// prefix-max F otherwise), FIN = the row at plen, first-max kbest. A read
// whose length is 0 or over L has no FIN row: (NEG_INF, 0) without a DP.
//
// What bounds it on an H100: integer instructions. A cell needs at least 8
// (with the sm_90 DPX add-max; counted in chip_smoke.py) and the bytes are
// tiny, so the bound is the SMs' issue rate; min/max and DPX instructions
// issue at half the rate of adds (tools/int32_rate.py). The first design
// (one candidate per thread, one row per loop trip) spent 15.8 SASS per
// cell: a length-mask compare and select per cell, W-1 register moves a row
// to shift the text window, a clamped genome load a row. This design:
//   * Each thread scores the slot pair (c, c+1) of one read in one strand
//     half (an odd half pads its last pair), so the pattern symbol and
//     penalty loads are shared; warps hold 32 neighbouring reads of one pair.
//     Each thread reads its read's pattern and penalty rows in their (B, L)
//     layout, in order (a cache line serves 32 rows): no transposing copies.
//   * A pair of fast candidates -- each window spans every row's band (tlen
//     >= plen + W - 1) -- takes a loop without the length mask, unrolled by
//     kU rows so the text window rotates by register renaming ((W-1)/kU
//     moves a row), fed one packed genome word per 16 rows per window
//     (`SymStream`).
//   * The pair is scored in 16-bit halves of 32-bit registers with the DPX
//     u16x2 add-max (two cells per instruction), values biased by 2^15 so a
//     32-bit add of a broadcast constant is exact in each half, NEG_INF
//     replaced by NEG16 = -2^14. Exact because on a fast candidate every
//     diagonal is finite, H after i rows lies in [-S_i, S_i] for S_i the
//     running sum of max(|mismatch_r|, |match|), and the NEG-derived values
//     (E at the band edge, F[0]) reset every row, so each comparison falls
//     as in int32. The substitution score of both cells is one PRMT from a
//     per-row byte table (the text window holds PRMT selectors). The thread
//     keeps S and the largest per-row magnitude as it loads each penalty; a
//     pair that exceeds `k1_packed_limit` (align/kernels.py; passed in as
//     `lim`, -1 = never) is rescored by the int32 loop in the same thread.
//   * Everything else (a pair with a window at the genome's end, or one the
//     guard refuses) takes the int32 loop with the mask, one row a trip, as
//     the first design: no preset scoring fails the guard, so the packed
//     loop carries all but the genome-end windows.
//
// LOCAL (template flag; `banded_score_cands(..., local=True)`): the same
// slots and windows scored as the TPU kernel `banded_score_semiglobal_pallas`
// scores them with local=True (pallas_kernels.py:133, cell rules :81-115)
// over the local branch's extracted windows (nvbio_tpu/bowtie/pipeline.py:
// 546-581): H0 floored at 0, the score the best cell with i <= plen and
// i-1+k < tlen (a running max FIN[k] per band index), kbest its first k.
// This replaces the flat K3-LOCAL launch over (B*C, L) patterns and (B*C,
// L+W-1) windows that the local branch used to build: the text comes from
// the packed genome here as for K1, and no (B*C, .) operand exists.
//   * A read longer than L scores its first L rows (LOCAL has no FIN row to
//     lose); a read of length 0 gives (NEG_INF, 0).
//   * The floor makes the sequential and the lazy F give the same H: they
//     differ only in NEG_INF-derived terms and in open arms built from the
//     unfloored H0, all below 0. So both loops keep K1's F and feed it the
//     unfloored H0: H = max3(H0, F, 0) and FIN = max3(FIN, H0, F) (FIN >= 0
//     after the first row of a spanning window, so the floor is implied).
//   * The packed guard (align/kernels.py `k1_packed_limit`): in LOCAL every
//     H lies in [0, S] for S the running sum of max(match, mismatch_r, 0),
//     and every diagonal is at least -max|mismatch_r|; the pair keeps its
//     16-bit result when S and that largest magnitude are both within the
//     limit (and the magnitude within int8).

#include <cstdint>
#include <cuda_runtime.h>

#include "genome_stream.cuh"

namespace {

constexpr int kNegInf = -(1 << 24);
constexpr int kU = 8;                      // rows per trip of the packed loop
constexpr uint32_t kBias2 = 0x80008000u;   // 0 in both biased halves
constexpr uint32_t kNeg2 = 0x40004000u;    // NEG16 = -2^14 in both halves

struct Scoring {
  int match, po, pe, to, te;
};

// ---------------------------------------------------------------------------
// int32: any candidate, the length mask, one row a trip
// ---------------------------------------------------------------------------

template <int W, bool SEQ_F, bool LOCAL>
__device__ __forceinline__ void row32(int (&H)[W], int (&E)[W], int (&FIN)[W],
                                      const int (&T)[W], int p, int mmv,
                                      int tlim, const Scoring& s) {
  int fprev = 0, hprev = 0, g = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    int sub = (p == T[k]) ? s.match : mmv;
    sub = (k < tlim) ? sub : kNegInf;
    const int er = (k + 1 < W) ? __viaddmax_s32(H[k + 1], s.po, E[k + 1] + s.pe)
                               : min(E[k], kNegInf);
    const int h0 = __viaddmax_s32(H[k], sub, er);  // max(H + sub, E')
    int f;
    if (SEQ_F) {
      f = (k == 0) ? min(h0, kNegInf) : __viaddmax_s32(fprev, s.te, hprev + s.to);
      fprev = f;
      hprev = h0;
    } else {
      // lazy F: prefix max of G[k] = H0[k] + to - te*k across the band
      if (k == 0) {
        g = h0 + s.to;
        f = min(g, kNegInf);
      } else {
        f = g + s.te * (k - 1);
        g = max(g, h0 + s.to - s.te * k);
      }
    }
    if constexpr (LOCAL) {
      H[k] = __vimax3_s32(h0, f, 0);
      if (k < tlim) FIN[k] = max(FIN[k], H[k]);
    } else {
      H[k] = max(h0, f);
    }
    E[k] = er;
  }
}

template <int W, bool SEQ_F, bool LOCAL>
__device__ __forceinline__ void score32(
    const int32_t* __restrict__ prow, const int32_t* __restrict__ mrow,
    int rows, int64_t start, int tlen,
    const uint32_t* __restrict__ words, int64_t n_words, const Scoring& s,
    int& smax, int& kb) {
  int H[W], E[W], T[W], FIN[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    H[k] = 0;
    E[k] = kNegInf;
    FIN[k] = kNegInf;
    T[k] = genome_sym(words, n_words, start + k);
  }
  for (int im1 = 0; im1 < rows; ++im1) {
    row32<W, SEQ_F, LOCAL>(H, E, FIN, T, prow[im1], mrow[im1], tlen - im1, s);
#pragma unroll
    for (int k = 0; k + 1 < W; ++k) T[k] = T[k + 1];
    T[W - 1] = genome_sym(words, n_words, start + im1 + W);
  }
  if constexpr (!LOCAL) {
#pragma unroll
    for (int k = 0; k < W; ++k) FIN[k] = H[k];
  }
  smax = FIN[0];
#pragma unroll
  for (int k = 1; k < W; ++k) smax = max(smax, FIN[k]);
  kb = W;
#pragma unroll
  for (int k = W - 1; k >= 0; --k) kb = (FIN[k] == smax) ? k : kb;
}

// ---------------------------------------------------------------------------
// packed: two fast candidates of one read in the 16-bit halves
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(0u), "r"(sel));
  return d;
}

// PRMT selector of the text pair (t0, t1): each half is the sign-extended
// byte t of the row's table
__device__ __forceinline__ uint32_t pair_sel(uint32_t t0, uint32_t t1) {
  return (t0 * 0x11u + 0x80u) | ((t1 * 0x11u + 0x80u) << 8);
}

__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  return __viaddmax_u16x2(a, 0u, b);
}

template <int W, bool SEQ_F, bool LOCAL, int NT>
__device__ __forceinline__ void row16(uint32_t (&H)[W], uint32_t (&E)[W],
                                      uint32_t (&FIN)[W],
                                      const uint32_t (&T)[NT], int u,
                                      uint32_t tab, const Scoring& s) {
  // a constant added by a 32-bit add (exact per biased half: c * 0x10001),
  // or by the DPX per-half add (the 16-bit two's complement in each half)
  const uint32_t po_w = uint32_t(s.po) * 0x10001u;
  const uint32_t to_w = uint32_t(s.to) * 0x10001u;
  const uint32_t pe_h = (uint32_t(s.pe) & 0xffffu) * 0x10001u;
  const uint32_t te_h = (uint32_t(s.te) & 0xffffu) * 0x10001u;
  uint32_t fprev = 0, hprev = 0, g = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint32_t sub = prmt(tab, T[u + k]);
    const uint32_t er =
        (k + 1 < W) ? __viaddmax_u16x2(E[k + 1], pe_h, H[k + 1] + po_w) : kNeg2;
    const uint32_t h0 = __viaddmax_u16x2(H[k], sub, er);
    uint32_t f;
    if (SEQ_F) {
      f = (k == 0) ? kNeg2 : __viaddmax_u16x2(fprev, te_h, hprev + to_w);
      fprev = f;
      hprev = h0;
    } else if (k == 0) {
      g = h0 + to_w;
      f = kNeg2;
    } else {
      f = g + uint32_t(s.te * (k - 1)) * 0x10001u;
      g = __viaddmax_u16x2(h0, (uint32_t(s.to - s.te * k) & 0xffffu) * 0x10001u,
                           g);
    }
    if constexpr (LOCAL) {
      // the floor at 0 (kBias2) and the running max of H (FIN >= 0 here)
      H[k] = __vimax3_u16x2(h0, f, kBias2);
      FIN[k] = __vimax3_u16x2(FIN[k], h0, f);
    } else {
      H[k] = max2(h0, f);
    }
    E[k] = er;
  }
}

// Returns false when the pair's penalties fail the range guard (the halves
// may then have wrapped; the caller rescores in int32).
template <int W, bool SEQ_F, bool LOCAL>
__device__ __forceinline__ bool score_pair16(
    const int32_t* __restrict__ prow, const int32_t* __restrict__ mrow, int L,
    int rows, int64_t start0, int64_t start1,
    const uint32_t* __restrict__ words, int64_t n_words, const Scoring& s,
    int lim, int& s0, int& k0, int& s1, int& k1) {
  constexpr int NT = W + kU - 1;
  uint32_t H[W], E[W], T[NT], FIN[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    H[k] = kBias2;
    E[k] = kNeg2;
    FIN[k] = kBias2;  // LOCAL: every H is >= 0
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
    T[j] = pair_sel(genome_sym(words, n_words, start0 + j),
                    genome_sym(words, n_words, start1 + j));
  SymStream st0 = stream_at(words, n_words, start0 + NT);
  SymStream st1 = stream_at(words, n_words, start1 + NT);
  const uint32_t match_b = uint32_t(s.match) & 0xffu;
  const int amatch = abs(s.match);
  // the guard: a sum over the rows scored (of magnitudes; LOCAL: of each
  // row's largest gain) and the largest magnitude
  int sum = 0, big = amatch;
  for (int r0 = 0; r0 < rows; r0 += kU) {
    int p[kU], mm[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = min(r0 + u, L - 1);
      p[u] = prow[r];
      mm[u] = mrow[r];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (r0 + u < rows) {
        const int m = max(abs(mm[u]), amatch);
        if constexpr (LOCAL)
          sum += max(max(mm[u], s.match), 0);
        else
          sum += m;
        big = max(big, m);
        // byte t of the table: match where t is the pattern symbol, else
        // the row's mismatch score (a code >= 4 matches no text symbol)
        const uint32_t mm4 = (uint32_t(mm[u]) & 0xffu) * 0x01010101u;
        const uint32_t put =
            (unsigned(p[u]) < 4u) ? (0xffu << (8 * p[u])) : 0u;
        const uint32_t tab = (mm4 & ~put) | (match_b * 0x01010101u & put);
        row16<W, SEQ_F, LOCAL>(H, E, FIN, T, u, tab, s);
      }
    }
    const uint32_t bits0 = stream_take<kU>(st0, words, n_words);
    const uint32_t bits1 = stream_take<kU>(st1, words, n_words);
#pragma unroll
    for (int j = 0; j + 1 < W; ++j) T[j] = T[j + kU];
#pragma unroll
    for (int i = 0; i < kU; ++i)
      T[W - 1 + i] = pair_sel((bits0 >> (2 * i)) & 3u, (bits1 >> (2 * i)) & 3u);
  }
  if (sum > lim || big > 127) return false;
  if constexpr (LOCAL) {
    if (big > lim) return false;
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) FIN[k] = H[k];
  }
  int m0 = -65536, m1 = -65536;
  k0 = W;
  k1 = W;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int v0 = int(FIN[k] & 0xffffu) - 0x8000;
    const int v1 = int(FIN[k] >> 16) - 0x8000;
    if (v0 > m0) {
      m0 = v0;
      k0 = k;
    }
    if (v1 > m1) {
      m1 = v1;
      k1 = k;
    }
  }
  s0 = m0;
  s1 = m1;
  return true;
}

// ---------------------------------------------------------------------------

template <int W, bool SEQ_F, bool LOCAL>
__global__ void __launch_bounds__(128)
banded_score_cands_kernel(const int32_t* __restrict__ reads,     // (B, L)
                          const int32_t* __restrict__ rc,        // (B, L)
                          const int32_t* __restrict__ mm,        // (B, L)
                          const int32_t* __restrict__ mmrc,      // (B, L)
                          const int32_t* __restrict__ lens,      // (B,)
                          const int64_t* __restrict__ w0,        // (B, C)
                          const int32_t* __restrict__ wlens,     // (B, C)
                          const uint32_t* __restrict__ words, int64_t n_words,
                          int B, int C, int nch, int L, Scoring s, int lim,
                          int32_t* __restrict__ score,           // (B, C)
                          int32_t* __restrict__ kbest) {         // (B, C)
  const int pf = (nch + 1) >> 1;                 // pairs in the forward half
  const int npairs = pf + ((C - nch + 1) >> 1);
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= int64_t(B) * npairs) return;
  const int q = int(t / B);
  const int b = int(t % B);
  const bool is_rc = q >= pf;
  const int c0 = is_rc ? nch + 2 * (q - pf) : 2 * q;
  const bool has1 = c0 + 1 < (is_rc ? C : nch);
  const int64_t cand0 = int64_t(b) * C + c0;
  const int plen = lens[b];
  // SEMI_GLOBAL: no FIN row; LOCAL: no cell (a read over L scores L rows)
  if (plen < 1 || (!LOCAL && plen > L)) {
    score[cand0] = kNegInf;
    kbest[cand0] = 0;
    if (has1) {
      score[cand0 + 1] = kNegInf;
      kbest[cand0 + 1] = 0;
    }
    return;
  }
  // a read's pattern and penalty rows: each thread reads its own, in order
  const int32_t* __restrict__ prow = (is_rc ? rc : reads) + int64_t(b) * L;
  const int32_t* __restrict__ mrow = (is_rc ? mmrc : mm) + int64_t(b) * L;
  const int64_t start0 = w0[cand0];
  const int tlen0 = wlens[cand0];
  const int64_t start1 = has1 ? w0[cand0 + 1] : start0;
  const int tlen1 = has1 ? wlens[cand0 + 1] : tlen0;
  const int rows = LOCAL ? min(plen, L) : plen;
  const bool fast0 = tlen0 >= rows + W - 1;
  const bool fast1 = tlen1 >= rows + W - 1;
  int s0, k0, s1 = 0, k1 = 0;
  const bool packed = lim >= 0 && fast0 && fast1 &&
                      score_pair16<W, SEQ_F, LOCAL>(prow, mrow, L, rows,
                                                    start0, start1, words,
                                                    n_words, s, lim, s0, k0,
                                                    s1, k1);
  if (!packed) {
    score32<W, SEQ_F, LOCAL>(prow, mrow, rows, start0, tlen0, words, n_words,
                             s, s0, k0);
    if (has1)
      score32<W, SEQ_F, LOCAL>(prow, mrow, rows, start1, tlen1, words,
                               n_words, s, s1, k1);
  }
  score[cand0] = s0;
  kbest[cand0] = k0;
  if (has1) {
    score[cand0 + 1] = s1;
    kbest[cand0 + 1] = k1;
  }
}

template <int W, bool LOCAL>
cudaError_t launch(const void* reads, const void* rc, const void* mm,
                   const void* mmrc, const void* lens, const void* w0,
                   const void* wlens, const void* words, int64_t n_words,
                   int B, int C, int nch, int L, const Scoring& s, int lim,
                   void* score, void* kbest, cudaStream_t stream) {
  const int threads = 128;
  const int npairs = (nch + 1) / 2 + (C - nch + 1) / 2;
  const int64_t n = int64_t(B) * npairs;
  const unsigned blocks = unsigned((n + threads - 1) / threads);
#define NVBT_ARGS                                                        \
  static_cast<const int32_t*>(reads), static_cast<const int32_t*>(rc),     \
      static_cast<const int32_t*>(mm), static_cast<const int32_t*>(mmrc),  \
      static_cast<const int32_t*>(lens),                                   \
      static_cast<const int64_t*>(w0), static_cast<const int32_t*>(wlens), \
      static_cast<const uint32_t*>(words), n_words, B, C, nch, L, s, lim,  \
      static_cast<int32_t*>(score), static_cast<int32_t*>(kbest)
  if (s.te >= s.to)
    banded_score_cands_kernel<W, true, LOCAL>
        <<<blocks, threads, 0, stream>>>(NVBT_ARGS);
  else
    banded_score_cands_kernel<W, false, LOCAL>
        <<<blocks, threads, 0, stream>>>(NVBT_ARGS);
#undef NVBT_ARGS
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// lim: the packed path's guard (`k1_packed_limit`), -1 to score every
// candidate in int32; local selects the LOCAL variant. Returns 0 on
// success, a cudaError_t code after a failed launch, or -1 for a band width
// without an instantiation. The library holds the bands 7, 9, 11, 17 and
// 31, or with -DNVBT_EXTRA_BAND=W that band alone (align/kernels.py builds
// one at the first use of a band outside the five).
int nvbt_banded_score_cands(const void* reads, const void* rc,
                            const void* mm, const void* mmrc,
                            const void* lens, const void* w0,
                            const void* wlens, const void* words,
                            int64_t n_words, int B, int C, int nch, int L,
                            int W, int match, int po, int pe, int to, int te,
                            int lim, int local, void* score, void* kbest,
                            void* stream) {
  if (int64_t(B) * C == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const Scoring s{match, po, pe, to, te};
#define NVBT_CALL(WW)                                                       \
  case WW:                                                                  \
    return int(local ? launch<WW, true>(reads, rc, mm, mmrc, lens, w0,     \
                                        wlens, words, n_words, B, C, nch, \
                                        L, s, lim, score, kbest, st)      \
                     : launch<WW, false>(reads, rc, mm, mmrc, lens, w0,    \
                                         wlens, words, n_words, B, C, nch, \
                                         L, s, lim, score, kbest, st));
  switch (W) {
#ifdef NVBT_EXTRA_BAND
    NVBT_CALL(NVBT_EXTRA_BAND)
#else
    NVBT_CALL(7)
    NVBT_CALL(9)
    NVBT_CALL(11)
    NVBT_CALL(17)
    NVBT_CALL(31)
#endif
    default:
      return -1;
  }
#undef NVBT_CALL
}

}  // extern "C"
