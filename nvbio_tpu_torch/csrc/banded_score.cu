// Banded affine-gap (Gotoh) scores of flat (pattern, text) pairs,
// SEMI_GLOBAL or LOCAL, with the text given as rows (the contract form) or
// read from the packed genome (the packed-window entry).
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
// Two entries, one body (`score_one`):
//   * nvbt_banded_score: texts (B, TW) int32, TW = M + W - 1, row-major.
//   * nvbt_banded_score_windows: the text of pair b is the TW symbols of the
//     packed genome from starts[b] (`packed.extract_window`'s window, 0 past
//     the genome's last word): the mate-rescue rescore reads its window
//     straight from the genome, so no (B, TW) window is built around it.
//     The symbols come from K1's fetch (genome_stream.cuh): one word load
//     per 16 rows, issued 16 rows ahead.
// Both take a per-row penalty plane or, with mm = nullptr, the scalar
// mismatch score: no constant plane is built for the usual case.
//
// What bounds it on an H100: integer instructions (at least 7 per cell,
// 9 for LOCAL, counted in chip_smoke.py); per row a thread reads one pattern
// symbol and one penalty, and one text symbol (a 16th of a word packed).
// Design: K1's core: one alignment per thread, the band state H/E, the LOCAL
// running max and the rolling text window in registers, templated on the
// band W and on LOCAL. Patterns and penalties are read in place, row-major:
// a thread walks its own rows, so its 32-byte sectors serve 8 consecutive
// rows from L1; no transposing copy is made. Rows past the pattern's length
// are skipped (they change neither variant's result).
//
// The library holds the bands 7, 9, 11, 17 and 31, or with
// -DNVBT_EXTRA_BAND=W that band alone (align/kernels.py builds one at the
// first use of a band outside the five).

#include <cstdint>
#include <cuda_runtime.h>

#include "genome_stream.cuh"

namespace {

constexpr int kNegInf = -(1 << 24);

struct Scoring {
  int match, mismatch, po, pe, to, te;
};

// text given as a row of int32 codes (TW of them)
struct RowText {
  const int32_t* __restrict__ txt;
  int TW;
  __device__ __forceinline__ int first(int k) const { return txt[k]; }
  // the symbol of column x = im1 + W (the window's next one), for x < TW
  __device__ __forceinline__ int next(int x) { return x < TW ? txt[x] : 0; }
};

// text streamed from the packed genome, one symbol a row
struct PackedText {
  const uint32_t* __restrict__ words;
  int64_t n_words, start;
  SymStream st;
  uint32_t bits;
  int left;
  __device__ __forceinline__ int first(int k) const {
    return genome_sym(words, n_words, start + k);
  }
  __device__ __forceinline__ void begin(int W) {
    st = stream_at(words, n_words, start + W);
    bits = stream_take<16>(st, words, n_words);
    left = 16;
  }
  __device__ __forceinline__ int next(int) {
    const int s = int(bits & 3u);
    bits >>= 2;
    if (--left == 0) {
      bits = stream_take<16>(st, words, n_words);
      left = 16;
    }
    return s;
  }
};

template <int W, bool LOCAL, class Text>
__device__ __forceinline__ void score_one(const int32_t* __restrict__ pat,
                                          const int32_t* __restrict__ mmp,
                                          int plen, int tlen, int M,
                                          Text& text, const Scoring& s,
                                          int& smax, int& kb) {
  const int rows = plen < M ? plen : M;
  int H[W], E[W], T[W], FIN[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    H[k] = 0;
    E[k] = kNegInf;
    FIN[k] = kNegInf;
    T[k] = text.first(k);
  }

  for (int im1 = 0; im1 < rows; ++im1) {
    const int p = pat[im1];
    const int mmv = mmp ? mmp[im1] : s.mismatch;
    int H0[W], Er[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      int sub = (p == T[k]) ? s.match : mmv;
      sub = (im1 + k < tlen) ? sub : kNegInf;
      const int diag = H[k] + sub;
      const int ep = ((k + 1 < W) ? E[k + 1] : kNegInf) + s.pe;
      const int hp = ((k + 1 < W) ? H[k + 1] : kNegInf) + s.po;
      Er[k] = max(ep, hp);
      H0[k] = max(diag, Er[k]);
      if (LOCAL) H0[k] = max(H0[k], 0);
    }
    int g = kNegInf;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int f = g + s.te * (k - 1);
      g = max(g, H0[k] + s.to - s.te * k);
      H[k] = max(H0[k], f);
      E[k] = Er[k];
      if (LOCAL) FIN[k] = (im1 + k < tlen) ? max(FIN[k], H[k]) : FIN[k];
    }
#pragma unroll
    for (int k = 0; k + 1 < W; ++k) T[k] = T[k + 1];
    T[W - 1] = text.next(im1 + W);
  }

  if (!LOCAL) {
    // the row at plen; NEG_INF when plen is 0 or exceeds M
    const bool has_fin = plen >= 1 && plen <= M;
#pragma unroll
    for (int k = 0; k < W; ++k) FIN[k] = has_fin ? H[k] : kNegInf;
  }
  smax = FIN[0];
#pragma unroll
  for (int k = 1; k < W; ++k) smax = max(smax, FIN[k]);
  kb = W;
#pragma unroll
  for (int k = W - 1; k >= 0; --k) kb = (FIN[k] == smax) ? k : kb;
}

template <int W, bool LOCAL>
__global__ void __launch_bounds__(128)
banded_score_kernel(const int32_t* __restrict__ pats,    // (B, M)
                    const int32_t* __restrict__ plens,   // (B,)
                    const int32_t* __restrict__ texts,   // (B, TW)
                    const int32_t* __restrict__ tlens,   // (B,)
                    const int32_t* __restrict__ mm,      // (B, M) or null
                    int B, int M, int TW, Scoring s,
                    int32_t* __restrict__ score,
                    int32_t* __restrict__ kbest) {
  const int b = int(int64_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (b >= B) return;
  RowText text{texts + int64_t(b) * TW, TW};
  int smax, kb;
  score_one<W, LOCAL>(pats + int64_t(b) * M, mm ? mm + int64_t(b) * M : mm,
                      plens[b], tlens[b], M, text, s, smax, kb);
  score[b] = smax;
  kbest[b] = kb;
}

template <int W, bool LOCAL>
__global__ void __launch_bounds__(128)
banded_score_windows_kernel(const int32_t* __restrict__ pats,    // (B, M)
                            const int32_t* __restrict__ plens,   // (B,)
                            const uint32_t* __restrict__ words,
                            int64_t n_words,
                            const int64_t* __restrict__ starts,  // (B,)
                            const int32_t* __restrict__ tlens,   // (B,)
                            const int32_t* __restrict__ mm,      // (B, M) or null
                            int B, int M, Scoring s,
                            int32_t* __restrict__ score,
                            int32_t* __restrict__ kbest) {
  const int b = int(int64_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (b >= B) return;
  PackedText text;
  text.words = words;
  text.n_words = n_words;
  text.start = starts[b];
  text.begin(W);
  int smax, kb;
  score_one<W, LOCAL>(pats + int64_t(b) * M, mm ? mm + int64_t(b) * M : mm,
                      plens[b], tlens[b], M, text, s, smax, kb);
  score[b] = smax;
  kbest[b] = kb;
}

template <int W>
cudaError_t launch(int local, const void* pats, const void* plens,
                   const void* texts, const void* tlens, const void* mm,
                   int B, int M, int TW, const Scoring& s, void* score,
                   void* kbest, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = unsigned((B + threads - 1) / threads);
#define NVBT_ARGS                                                          \
  static_cast<const int32_t*>(pats), static_cast<const int32_t*>(plens),   \
      static_cast<const int32_t*>(texts), static_cast<const int32_t*>(tlens), \
      static_cast<const int32_t*>(mm), B, M, TW, s,                        \
      static_cast<int32_t*>(score), static_cast<int32_t*>(kbest)
  if (local)
    banded_score_kernel<W, true><<<blocks, threads, 0, stream>>>(NVBT_ARGS);
  else
    banded_score_kernel<W, false><<<blocks, threads, 0, stream>>>(NVBT_ARGS);
#undef NVBT_ARGS
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_windows(int local, const void* pats, const void* plens,
                           const void* words, int64_t n_words,
                           const void* starts, const void* tlens,
                           const void* mm, int B, int M, const Scoring& s,
                           void* score, void* kbest, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = unsigned((B + threads - 1) / threads);
#define NVBT_ARGS                                                          \
  static_cast<const int32_t*>(pats), static_cast<const int32_t*>(plens),   \
      static_cast<const uint32_t*>(words), n_words,                        \
      static_cast<const int64_t*>(starts),                                 \
      static_cast<const int32_t*>(tlens),                                  \
      static_cast<const int32_t*>(mm), B, M, s,                            \
      static_cast<int32_t*>(score), static_cast<int32_t*>(kbest)
  if (local)
    banded_score_windows_kernel<W, true>
        <<<blocks, threads, 0, stream>>>(NVBT_ARGS);
  else
    banded_score_windows_kernel<W, false>
        <<<blocks, threads, 0, stream>>>(NVBT_ARGS);
#undef NVBT_ARGS
  return cudaGetLastError();
}

}  // namespace

// the band widths this library holds
#ifdef NVBT_EXTRA_BAND
#define NVBT_BANDS(X) X(NVBT_EXTRA_BAND)
#else
#define NVBT_BANDS(X) X(7) X(9) X(11) X(17) X(31)
#endif

extern "C" {

// mm: (B, M) penalties, or null for the scalar mismatch. Returns 0 on
// success, a cudaError_t code after a failed launch, or -1 for a band width
// without an instantiation.
int nvbt_banded_score(const void* pats, const void* plens, const void* texts,
                      const void* tlens, const void* mm, int B, int M, int TW,
                      int W, int local, int match, int mismatch, int po,
                      int pe, int to, int te, void* score, void* kbest,
                      void* stream) {
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const Scoring s{match, mismatch, po, pe, to, te};
#define NVBT_CALL(WW)                                                      \
  case WW:                                                                 \
    return int(launch<WW>(local, pats, plens, texts, tlens, mm, B, M, TW,  \
                          s, score, kbest, st));
  switch (W) {
    NVBT_BANDS(NVBT_CALL)
    default:
      return -1;
  }
#undef NVBT_CALL
}

// The packed-window entry: the text of pair b is the M + W - 1 symbols of
// the packed genome (words, n_words) from starts[b] (int64).
int nvbt_banded_score_windows(const void* pats, const void* plens,
                              const void* words, int64_t n_words,
                              const void* starts, const void* tlens,
                              const void* mm, int B, int M, int W, int local,
                              int match, int mismatch, int po, int pe, int to,
                              int te, void* score, void* kbest,
                              void* stream) {
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const Scoring s{match, mismatch, po, pe, to, te};
#define NVBT_CALL(WW)                                                        \
  case WW:                                                                   \
    return int(launch_windows<WW>(local, pats, plens, words, n_words,        \
                                  starts, tlens, mm, B, M, s, score, kbest,  \
                                  st));
  switch (W) {
    NVBT_BANDS(NVBT_CALL)
    default:
      return -1;
  }
#undef NVBT_CALL
}

}  // extern "C"
