// Fused banded traceback kernel: banded Gotoh forward pass, SEMI_GLOBAL or
// LOCAL, that records one direction byte per cell, then each read's
// traceback walk.
//
// Replaces the TPU kernel `banded_traceback_semiglobal_pallas` /
// `_banded_tb_kernel` (nvbio_tpu/align/pallas_kernels.py:568 / :245), both
// variants (K2 with local=False, K2-LOCAL with local=True). Same function
// and the same 8 outputs: score, k_best, ops (packed entries
// op | mism<<2 | refsym<<3, END->START), n_ops, k_final, nm, i_end, i_start.
// The forward recurrence is the TPU kernel's (pallas_kernels.py:307-332):
// E from band k+1 (both arms NEG_INF at the band edge), the lazy prefix-max F
// with NEG_INF folded into the prefix, and the tie rules of its direction
// byte: hdir prefers diag, then E, then F (:335-336); e_ext is
// Ep+pe >= Hp+po (:318); f_ext is F == F[k-1]+te (:331); the walk starts at
// k0 = min(first-max k, W-1) (:405-407); NM counts mismatching M cells plus
// every gap op (:446-448).
// LOCAL (:320-321, :337-338, :354-372, :436-443, :502-506): H0 floored at
// 0; a cell whose H is 0 gets direction 3; the sink is the best cell with
// i <= plen and i-1+k < tlen, tracked from (0, 0, 0) and replaced only by
// a row whose best is strictly greater (the first row wins; k is that
// row's first max, clipped to W-1); the walk starts there and stops in the
// H state on a zero cell, leaving i_start/k_final at that cell (a read
// whose best is 0 walks nothing).
//
// What bounds it on an H100: integer instructions of the forward pass (at
// least 17 per cell, 22 for LOCAL, counted in chip_smoke.py) and the walk's
// dependent loads. The TPU kept the direction plane in VMEM and walked all lanes
// row-synchronously (:469), a SIMD measure; here each thread owns one read,
// keeps H/E and a rolling text window in registers (templated on W and on
// LOCAL), writes its direction bytes to a global scratch laid out
// [row][k][read] so the 32 threads of a warp write 32 neighbouring bytes,
// and then walks on its own. Five bits per cell suffice (hdir, e_ext,
// f_ext, mism); the MD reference symbol is re-read from the text window
// during the walk. The walk is bounded by 2*(M+W) steps, longer than any
// walk that ends (a walk that never reaches row 0 would not end on the TPU
// either).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNegInf = -(1 << 24);

template <int W, bool LOCAL>
__global__ void __launch_bounds__(128)
banded_traceback_kernel(const int32_t* __restrict__ pat_t,   // (M, B)
                        const int32_t* __restrict__ lens,    // (B,)
                        const int32_t* __restrict__ texts,   // (B, TW)
                        const int32_t* __restrict__ tlens,   // (B,)
                        const int32_t* __restrict__ mm_t,    // (M, B)
                        int B, int M, int TW, int MAXS, int match, int po,
                        int pe, int to, int te,
                        uint8_t* __restrict__ dirs,          // (M, W, B)
                        int32_t* __restrict__ score, int32_t* __restrict__ kbest,
                        int32_t* __restrict__ ops,           // (B, MAXS)
                        int32_t* __restrict__ n_ops, int32_t* __restrict__ k_final,
                        int32_t* __restrict__ nm_out, int32_t* __restrict__ i_end,
                        int32_t* __restrict__ i_start) {
  const int b = int(int64_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (b >= B) return;
  const int plen = lens[b];
  const int tlen = tlens[b];
  const int32_t* __restrict__ txt = texts + int64_t(b) * TW;
  const int rows = plen < M ? plen : M;

  int H[W], E[W], T[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    H[k] = 0;
    E[k] = kNegInf;
    T[k] = txt[k];
  }

  // LOCAL sink: best in-range cell, its row and band index
  int bst = 0, bi = 0, bk = 0;

  // ---- forward pass: rows 1..plen (later rows are never walked) ----------
  for (int im1 = 0; im1 < rows; ++im1) {
    const int p = pat_t[int64_t(im1) * B + b];
    const int mmv = mm_t[int64_t(im1) * B + b];
    int diag[W], Er[W], H0[W], ee[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      int sub = (p == T[k]) ? match : mmv;
      sub = (im1 + k < tlen) ? sub : kNegInf;
      diag[k] = H[k] + sub;
      const int ep = ((k + 1 < W) ? E[k + 1] : kNegInf) + pe;
      const int hp = ((k + 1 < W) ? H[k + 1] : kNegInf) + po;
      Er[k] = max(ep, hp);
      ee[k] = ep >= hp;
      H0[k] = max(diag[k], Er[k]);
      if (LOCAL) H0[k] = max(H0[k], 0);
    }
    // lazy F: F[k] = te*(k-1) + max(NEG_INF, max_{k'<k} H0[k'] + to - te*k')
    uint8_t* __restrict__ drow = dirs + int64_t(im1) * W * B + b;
    int g = kNegInf;
    int fprev = kNegInf;
    int rb = kNegInf, rk = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int f = (k == 0) ? kNegInf - te : g + te * (k - 1);
      g = max(g, H0[k] + to - te * k);
      const int fe = f == fprev + te;
      fprev = f;
      const int h = max(H0[k], f);
      int hdir = (h == diag[k]) ? 0 : ((h == Er[k]) ? 1 : 2);
      if (LOCAL) {
        hdir = (h == 0) ? 3 : hdir;  // zero-stop cell
        if (im1 + k < tlen && h > rb) {
          rb = h;
          rk = k;
        }
      }
      const int mism = p != T[k];
      drow[int64_t(k) * B] =
          uint8_t(hdir | (ee[k] << 2) | (fe << 3) | (mism << 4));
      H[k] = h;
      E[k] = Er[k];
    }
    if (LOCAL && rb > bst) {
      bst = rb;
      bi = im1 + 1;
      bk = rk;
    }
#pragma unroll
    for (int k = 0; k + 1 < W; ++k) T[k] = T[k + 1];
    if (im1 + W < TW) T[W - 1] = txt[im1 + W];
  }

  int smax, k0, i0;
  if (LOCAL) {
    smax = bst;
    k0 = bk;
    i0 = bi;
  } else {
    const bool has_fin = plen >= 1 && plen <= M;
    smax = has_fin ? H[0] : kNegInf;
#pragma unroll
    for (int k = 1; k < W; ++k) smax = max(smax, has_fin ? H[k] : kNegInf);
    k0 = W;
#pragma unroll
    for (int k = W - 1; k >= 0; --k)
      k0 = ((has_fin ? H[k] : kNegInf) == smax) ? k : k0;
    k0 = min(k0, W - 1);
    i0 = plen;
  }

  // ---- traceback walk, END -> START --------------------------------------
  int i = i0, k = k0, st = 0, cursor = 0, nm = 0;
  int32_t* __restrict__ orow = ops + int64_t(b) * MAXS;
  if (LOCAL || plen <= M) {
    const int cap = 2 * (M + W);
    for (int step = 0; step < cap && i >= 1; ++step) {
      const int cell = dirs[(int64_t(i - 1) * W + k) * B + b];
      const int hdir = cell & 3;
      if (LOCAL && st == 0 && hdir == 3) break;  // zero-stop: (i, k) stay
      const int e_ext = (cell >> 2) & 1;
      const int f_ext = (cell >> 3) & 1;
      const int mism = (cell >> 4) & 1;
      const int sym = txt[i - 1 + k] & 15;
      const int sel = (st == 1) ? 1 : ((st == 2) ? 2 : hdir);
      const int op = (sel == 0) ? 1 : ((sel == 1) ? 2 : 3);
      nm += (sel == 0) ? mism : 1;
      if (cursor < MAXS)
        orow[cursor] = op | (((sel == 0) ? mism : 0) << 2) | (sym << 3);
      ++cursor;
      const int di = (sel == 2) ? 0 : 1;
      const int dk = (sel == 0) ? 0 : ((sel == 1) ? 1 : -1);
      st = (sel == 0) ? 0 : ((sel == 1) ? (e_ext ? 1 : 0) : (f_ext ? 2 : 0));
      i -= di;
      k = min(max(k + dk, 0), W - 1);
    }
  }
  for (int c = cursor < MAXS ? cursor : MAXS; c < MAXS; ++c) orow[c] = 0;
  score[b] = smax;
  kbest[b] = k0;
  n_ops[b] = cursor;
  k_final[b] = k;
  nm_out[b] = nm;
  i_end[b] = i0;
  i_start[b] = i;
}

template <int W, bool LOCAL>
cudaError_t launch(const void* pat_t, const void* lens, const void* texts,
                   const void* tlens, const void* mm_t, int B, int M, int TW,
                   int MAXS, int match, int po, int pe, int to, int te,
                   void* dirs, void* const* outs, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = unsigned((B + threads - 1) / threads);
  banded_traceback_kernel<W, LOCAL><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(pat_t), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(texts), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(mm_t), B, M, TW, MAXS, match, po, pe, to,
      te, static_cast<uint8_t*>(dirs), static_cast<int32_t*>(outs[0]),
      static_cast<int32_t*>(outs[1]), static_cast<int32_t*>(outs[2]),
      static_cast<int32_t*>(outs[3]), static_cast<int32_t*>(outs[4]),
      static_cast<int32_t*>(outs[5]), static_cast<int32_t*>(outs[6]),
      static_cast<int32_t*>(outs[7]));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// outs: score, k_best, ops, n_ops, k_final, nm, i_end, i_start (device
// pointers); local selects the LOCAL variant. Returns 0 on success, a
// cudaError_t code after a failed launch, or -1 for a band width without an
// instantiation.
int nvbt_banded_traceback(const void* pat_t, const void* lens,
                          const void* texts, const void* tlens,
                          const void* mm_t, int B, int M, int TW, int MAXS,
                          int W, int local, int match, int po, int pe, int to,
                          int te, void* dirs, void* const* outs,
                          void* stream) {
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
#define NVBT_CALL(WW)                                                      \
  case WW:                                                                 \
    return int(local ? launch<WW, true>(pat_t, lens, texts, tlens, mm_t, B, \
                                        M, TW, MAXS, match, po, pe, to, te, \
                                        dirs, outs, st)                     \
                     : launch<WW, false>(pat_t, lens, texts, tlens, mm_t,   \
                                         B, M, TW, MAXS, match, po, pe, to, \
                                         te, dirs, outs, st));
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
