// Banded affine-gap (Gotoh) scores of flat (pattern, text) pairs,
// SEMI_GLOBAL or LOCAL.
//
// Replaces the TPU kernel `banded_score_semiglobal_pallas` / `_banded_kernel`
// (nvbio_tpu/align/pallas_kernels.py:133 / :35), both variants. Same
// function, cell for cell (:81-115): diag, then E from band k+1 (both arms
// NEG_INF + gap at the band edge), H0 = max(diag, E), floored at 0 for
// LOCAL (:93-94); the lazy F as the prefix max of H0[k] + to - te*k with
// NEG_INF shifted in (the TPU's doubling loop, :96-103), so F[k] =
// te*(k-1) + max(NEG_INF, max_{k'<k} ...); H = max(H0, F). SEMI_GLOBAL
// keeps the row at plen; LOCAL a running max over the cells with i <= plen
// and i-1+k < tlen (:108-112). The score is the max over the band, k_best
// the first k that reaches it.
//
// What bounds it on an H100: integer instructions (at least 7 per cell,
// 9 for LOCAL, counted in chip_smoke.py); per row a thread reads one pattern symbol,
// one penalty and one text symbol. Design: K1's core without the packed
// genome fetch: one alignment per thread, the band state H/E, the LOCAL
// running max and the rolling text window in registers, templated on the
// band W and on LOCAL. Patterns, penalties and texts are read in place,
// row-major: a thread walks its own rows, so its 32-byte sectors serve 8
// consecutive rows from L1; no transposing copy of the (B*C, 130) local
// texts (409 MB at B*C = 786432) is made. Rows past the pattern's length
// are skipped (they change neither variant's result).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNegInf = -(1 << 24);

template <int W, bool LOCAL>
__global__ void __launch_bounds__(128)
banded_score_kernel(const int32_t* __restrict__ pats,    // (B, M)
                    const int32_t* __restrict__ plens,   // (B,)
                    const int32_t* __restrict__ texts,   // (B, TW)
                    const int32_t* __restrict__ tlens,   // (B,)
                    const int32_t* __restrict__ mm,      // (B, M)
                    int B, int M, int TW, int match, int po, int pe, int to,
                    int te, int32_t* __restrict__ score,
                    int32_t* __restrict__ kbest) {
  const int b = int(int64_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (b >= B) return;
  const int plen = plens[b];
  const int tlen = tlens[b];
  const int32_t* __restrict__ pat = pats + int64_t(b) * M;
  const int32_t* __restrict__ mmp = mm + int64_t(b) * M;
  const int32_t* __restrict__ txt = texts + int64_t(b) * TW;
  const int rows = plen < M ? plen : M;

  int H[W], E[W], T[W], FIN[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    H[k] = 0;
    E[k] = kNegInf;
    FIN[k] = kNegInf;
    T[k] = txt[k];
  }

  for (int im1 = 0; im1 < rows; ++im1) {
    const int p = pat[im1];
    const int mmv = mmp[im1];
    int H0[W], Er[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      int sub = (p == T[k]) ? match : mmv;
      sub = (im1 + k < tlen) ? sub : kNegInf;
      const int diag = H[k] + sub;
      const int ep = ((k + 1 < W) ? E[k + 1] : kNegInf) + pe;
      const int hp = ((k + 1 < W) ? H[k + 1] : kNegInf) + po;
      Er[k] = max(ep, hp);
      H0[k] = max(diag, Er[k]);
      if (LOCAL) H0[k] = max(H0[k], 0);
    }
    int g = kNegInf;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int f = g + te * (k - 1);
      g = max(g, H0[k] + to - te * k);
      H[k] = max(H0[k], f);
      E[k] = Er[k];
      if (LOCAL) FIN[k] = (im1 + k < tlen) ? max(FIN[k], H[k]) : FIN[k];
    }
#pragma unroll
    for (int k = 0; k + 1 < W; ++k) T[k] = T[k + 1];
    if (im1 + W < TW) T[W - 1] = txt[im1 + W];
  }

  if (!LOCAL) {
    // the row at plen; NEG_INF when plen is 0 or exceeds M
    const bool has_fin = plen >= 1 && plen <= M;
#pragma unroll
    for (int k = 0; k < W; ++k) FIN[k] = has_fin ? H[k] : kNegInf;
  }
  int smax = FIN[0];
#pragma unroll
  for (int k = 1; k < W; ++k) smax = max(smax, FIN[k]);
  int kb = W;
#pragma unroll
  for (int k = W - 1; k >= 0; --k) kb = (FIN[k] == smax) ? k : kb;
  score[b] = smax;
  kbest[b] = kb;
}

template <int W, bool LOCAL>
cudaError_t launch_t(const void* pats, const void* plens, const void* texts,
                     const void* tlens, const void* mm, int B, int M, int TW,
                     int match, int po, int pe, int to, int te, void* score,
                     void* kbest, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = unsigned((B + threads - 1) / threads);
  banded_score_kernel<W, LOCAL><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(pats), static_cast<const int32_t*>(plens),
      static_cast<const int32_t*>(texts), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(mm), B, M, TW, match, po, pe, to, te,
      static_cast<int32_t*>(score), static_cast<int32_t*>(kbest));
  return cudaGetLastError();
}

template <int W>
cudaError_t launch(int local, const void* pats, const void* plens,
                   const void* texts, const void* tlens, const void* mm,
                   int B, int M, int TW, int match, int po, int pe, int to,
                   int te, void* score, void* kbest, cudaStream_t stream) {
  if (local)
    return launch_t<W, true>(pats, plens, texts, tlens, mm, B, M, TW, match,
                             po, pe, to, te, score, kbest, stream);
  return launch_t<W, false>(pats, plens, texts, tlens, mm, B, M, TW, match,
                            po, pe, to, te, score, kbest, stream);
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for
// a band width without an instantiation.
int nvbt_banded_score(const void* pats, const void* plens, const void* texts,
                      const void* tlens, const void* mm, int B, int M, int TW,
                      int W, int local, int match, int po, int pe, int to,
                      int te, void* score, void* kbest, void* stream) {
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
#define NVBT_CALL(WW)                                                      \
  case WW:                                                                 \
    return int(launch<WW>(local, pats, plens, texts, tlens, mm, B, M, TW,  \
                          match, po, pe, to, te, score, kbest, st));
  switch (W) {
    NVBT_CALL(7)
    NVBT_CALL(9)
    NVBT_CALL(11)
    NVBT_CALL(17)
    NVBT_CALL(31)
    default:
      return -1;
  }
#undef NVBT_CALL
}

}  // extern "C"
