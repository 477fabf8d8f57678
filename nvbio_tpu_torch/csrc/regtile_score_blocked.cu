// Register-tiled scorer over pre-blocked operands (K5): SEMI_GLOBAL banded
// affine-gap (Gotoh) score and first-max band index of every alignment of
// a (G, rows, 8, 128) blocked batch.
//
// Replaces the TPU kernel `regtile_score_blocked` / `_regtile_kernel`
// (nvbio_tpu/align/pallas_kernels.py:839 / :696), the pure DP engine that
// the repo's GCUPS figure is measured on (bench.py:421-467). Same function:
// alignment a = g*1024 + s*128 + l reads element [g][row][s][l] of the
// pattern, text and mismatch planes and [g][0][s][l] of the two length
// planes; L = `length` rows; outputs are (G, 1, 8, 128). The recurrence is
// the TPU kernel's, cell for cell (pallas_kernels.py:723-787): diag; E from
// band k+1 with E = min(E, NEG_INF) at the band edge; with SEQ_F the
// sequential F[k] = max(F[k-1] + te, H0[k-1] + to) from F[0] =
// min(H0[0], NEG_INF), else the lazy prefix-max F with F[0] =
// min(H0[0] + to, NEG_INF); FIN the row at plen (with UNIFORM_PLEN the last
// row); first-max kbest. FULL_TEXT drops the text-length mask and reads the
// padded text as it is. The TPU's `unroll` and `t_regs` schedule its VLIW
// bundles and change no result; they have no counterpart here.
//
// What bounds it on an H100: integer instructions, at least 8 per cell with
// the sm_90 DPX add-max (as K1; counted in chip_smoke.py), against ~5.6 GB
// of int32 operands at the GCUPS shape (G = 4096, L = 100, W = 31), which
// HBM moves in ~1.7 ms: nearly balanced at W = 17. Design: one alignment
// per thread, the band state H/E and the rolling text window in registers
// (templated on W and on the three flags, as K1 is); in the blocked layout
// neighbouring threads read neighbouring addresses of every row, so the
// loads coalesce with no transposing copy. Rows past the pattern's length
// are skipped unless UNIFORM_PLEN (they cannot change FIN).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNegInf = -(1 << 24);

template <int W, bool SEQ_F, bool FULL_TEXT, bool UNIFORM_PLEN>
__global__ void __launch_bounds__(128)
regtile_score_blocked_kernel(const int32_t* __restrict__ pats,   // (G,Lp,1024)
                             const int32_t* __restrict__ plens,  // (G,1,1024)
                             const int32_t* __restrict__ txts,   // (G,TWp,1024)
                             const int32_t* __restrict__ tlens,  // (G,1,1024)
                             const int32_t* __restrict__ mms,    // (G,Lp,1024)
                             int G, int Lp, int TWp, int L, int match, int po,
                             int pe, int to, int te,
                             int32_t* __restrict__ score,        // (G,1,1024)
                             int32_t* __restrict__ kbest) {      // (G,1,1024)
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= int64_t(G) * 1024) return;
  const int64_t g = t >> 10;
  const int64_t a = t & 1023;
  const int32_t* __restrict__ pat = pats + g * Lp * 1024 + a;
  const int32_t* __restrict__ mm = mms + g * Lp * 1024 + a;
  const int32_t* __restrict__ txt = txts + g * TWp * 1024 + a;
  const int plen = plens[t];
  const int tlen = FULL_TEXT ? 0 : tlens[t];
  const int rows = UNIFORM_PLEN ? L : (plen < L ? plen : L);

  int H[W], E[W], T[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    H[k] = 0;
    E[k] = kNegInf;
    T[k] = txt[int64_t(k) * 1024];
  }

  for (int im1 = 0; im1 < rows; ++im1) {
    const int p = pat[int64_t(im1) * 1024];
    const int mmv = mm[int64_t(im1) * 1024];
    int H0[W], Er[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      int sub = (p == T[k]) ? match : mmv;
      if (!FULL_TEXT) sub = (im1 + k < tlen) ? sub : kNegInf;
      const int diag = H[k] + sub;
      Er[k] = (k + 1 < W) ? max(E[k + 1] + pe, H[k + 1] + po)
                          : min(E[k], kNegInf);
      H0[k] = max(diag, Er[k]);
    }
    int F[W];
    if (SEQ_F) {
      F[0] = min(H0[0], kNegInf);
#pragma unroll
      for (int k = 1; k < W; ++k) F[k] = max(F[k - 1] + te, H0[k - 1] + to);
    } else {
      // lazy F: prefix max of G[k] = H0[k] + to - te*k across the band
      int gm = H0[0] + to;
      F[0] = min(gm, kNegInf);
#pragma unroll
      for (int k = 1; k < W; ++k) {
        F[k] = gm + te * (k - 1);
        gm = max(gm, H0[k] + to - te * k);
      }
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      H[k] = max(H0[k], F[k]);
      E[k] = Er[k];
    }
#pragma unroll
    for (int k = 0; k + 1 < W; ++k) T[k] = T[k + 1];
    if (im1 + 1 < rows) T[W - 1] = txt[int64_t(im1 + W) * 1024];
  }

  // FIN: the row at plen (NEG_INF when plen is 0 or exceeds L), or with
  // UNIFORM_PLEN the last row
  const bool has_fin = UNIFORM_PLEN || (plen >= 1 && plen <= L);
  int smax = has_fin ? H[0] : kNegInf;
#pragma unroll
  for (int k = 1; k < W; ++k) smax = max(smax, has_fin ? H[k] : kNegInf);
  int kb = W;
#pragma unroll
  for (int k = W - 1; k >= 0; --k)
    kb = ((has_fin ? H[k] : kNegInf) == smax) ? k : kb;
  score[t] = smax;
  kbest[t] = kb;
}

template <int W, bool SEQ_F, bool FULL_TEXT, bool UNIFORM_PLEN>
cudaError_t launch4(const void* pats, const void* plens, const void* txts,
                    const void* tlens, const void* mms, int G, int Lp,
                    int TWp, int L, int match, int po, int pe, int to, int te,
                    void* score, void* kbest, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = unsigned(int64_t(G) * 1024 / threads);
  regtile_score_blocked_kernel<W, SEQ_F, FULL_TEXT, UNIFORM_PLEN>
      <<<blocks, threads, 0, stream>>>(
          static_cast<const int32_t*>(pats),
          static_cast<const int32_t*>(plens),
          static_cast<const int32_t*>(txts),
          static_cast<const int32_t*>(tlens),
          static_cast<const int32_t*>(mms), G, Lp, TWp, L, match, po, pe, to,
          te, static_cast<int32_t*>(score), static_cast<int32_t*>(kbest));
  return cudaGetLastError();
}

template <int W>
cudaError_t launch(int flags, const void* pats, const void* plens,
                   const void* txts, const void* tlens, const void* mms,
                   int G, int Lp, int TWp, int L, int match, int po, int pe,
                   int to, int te, void* score, void* kbest,
                   cudaStream_t stream) {
#define NVBT_FLAGS(S, F, U)                                                  \
  case (S) | ((F) << 1) | ((U) << 2):                                        \
    return launch4<W, bool(S), bool(F), bool(U)>(                            \
        pats, plens, txts, tlens, mms, G, Lp, TWp, L, match, po, pe, to, te, \
        score, kbest, stream);
  switch (flags) {
    NVBT_FLAGS(0, 0, 0)
    NVBT_FLAGS(1, 0, 0)
    NVBT_FLAGS(0, 1, 0)
    NVBT_FLAGS(1, 1, 0)
    NVBT_FLAGS(0, 0, 1)
    NVBT_FLAGS(1, 0, 1)
    NVBT_FLAGS(0, 1, 1)
    NVBT_FLAGS(1, 1, 1)
    default:
      return cudaErrorInvalidValue;
  }
#undef NVBT_FLAGS
}

}  // namespace

extern "C" {

// flags: bit 0 seq_f, bit 1 full_text, bit 2 uniform_plen. Returns 0 on
// success, a cudaError_t code after a failed launch, or -1 for a band width
// without an instantiation. The library holds the bands 7, 9, 11, 17 and
// 31, or with -DNVBT_EXTRA_BAND=W that band alone (align/kernels.py builds
// one at the first use of a band outside the five).
int nvbt_regtile_score_blocked(const void* pats, const void* plens,
                               const void* txts, const void* tlens,
                               const void* mms, int G, int Lp, int TWp, int L,
                               int W, int flags, int match, int po, int pe,
                               int to, int te, void* score, void* kbest,
                               void* stream) {
  if (G == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
#define NVBT_CALL(WW)                                                       \
  case WW:                                                                  \
    return int(launch<WW>(flags, pats, plens, txts, tlens, mms, G, Lp, TWp, \
                          L, match, po, pe, to, te, score, kbest, st));
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
