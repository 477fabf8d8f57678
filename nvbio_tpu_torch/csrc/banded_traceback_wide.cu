// Wide banded traceback kernel (K2-WIDE): K2's fused banded Gotoh forward
// pass + traceback walk, SEMI_GLOBAL or LOCAL, for bands too wide for one
// thread's registers (W up to 32 * 36 = 1152).
//
// Replaces the TPU kernel `banded_traceback_semiglobal_pallas` /
// `_banded_tb_kernel` (nvbio_tpu/align/pallas_kernels.py:568 / :245) where
// `traceback.batch_traceback_full` (nvbio_tpu/align/traceback.py:436) runs
// it at band W = T + M over text left-padded by M never-match symbols: the
// full-matrix mate traceback of `pe_full_traceback`. At the operating point
// (M = 100, T = L + W - 1 = 130) that is W = 230; 286 at --max-read-len 128
// and 1054 at MapParams' documented cap of 512. Same function and the same
// 8 outputs as K2 (csrc/banded_traceback.cu): score, k_best, ops (packed
// entries op | mism<<2 | refsym<<3, END->START), n_ops, k_final, nm, i_end,
// i_start; the same recurrence and tie rules (pallas_kernels.py:307-365):
// E from band k+1 (both arms NEG_INF at the band edge), the lazy prefix-max
// F floored at NEG_INF with F[0] = NEG_INF - te, f_ext = (F == F[k-1] + te),
// hdir preferring diag, then E, then F; LOCAL floors H0 at 0, marks zero
// cells 3, sinks at the best in-range cell of the first row that reaches it
// and stops the walk in the H state on a zero cell.
//
// What bounds it on an H100: integer instructions of the forward pass
// (at least 17 per cell, 22 for LOCAL, as K2; counted in chip_smoke.py);
// the direction bytes it writes, M * W per read (754 MB at B = 32768,
// W = 230), are scratch, not inputs or outputs. K2 keeps a read's band in
// one thread's registers, which already takes 254 registers at W = 31.
// Design: one warp per read. Lane j holds the contiguous run of NC band
// cells [j*NC, j*NC + NC) (NC a template constant: 32*NC >= W; the cells
// past W in the last lanes are computed and never read). A row:
//   1. E's k+1 neighbour is in the lane except at the run's last cell,
//      which takes lane j+1's first cell (one __shfl_down_sync each for H
//      and E, taken before the row overwrites them);
//   2. the lazy F's prefix max: an in-lane running max, then a 5-step
//      __shfl_up_sync max-scan of the lane totals, made exclusive with one
//      more shuffle; f_ext at cell k is P[k-1] == P[k-2] for the floored
//      prefix max P (the same integer test as F[k] == F[k-1] + te), so each
//      lane also takes P[j*NC - 2] from lane j-1;
//   3. one direction byte per cell (hdir, e_ext, f_ext, mism; the MD symbol
//      is re-read from the text during the walk), packed four to a word and
//      stored to a [B][M][32*NC] byte scratch, so a warp's row is one
//      contiguous run;
//   4. the LOCAL sink by a warp max (__reduce_max_sync) and a ballot for the
//      first lane holding it.
// The text window rolls by one shuffle per row. After the forward pass,
// the SEMI_GLOBAL sink is the FIN row's warp max and its first k; then lane
// 0 walks the read's directions from the scratch, END -> START, bounded by
// 2*(M+W) steps as K2.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNegInf = -(1 << 24);
constexpr unsigned kFull = 0xffffffffu;

template <int NC, bool LOCAL>
__global__ void __launch_bounds__(128)
banded_traceback_wide_kernel(const int32_t* __restrict__ pats,    // (B, M)
                             const int32_t* __restrict__ lens,    // (B,)
                             const int32_t* __restrict__ texts,   // (B, TW)
                             const int32_t* __restrict__ tlens,   // (B,)
                             const int32_t* __restrict__ mms,     // (B, M)
                             int B, int M, int TW, int MAXS, int W,
                             int match, int po, int pe, int to, int te,
                             uint32_t* __restrict__ dirs,  // (B, M, 8*NC)
                             int32_t* __restrict__ score,
                             int32_t* __restrict__ kbest,
                             int32_t* __restrict__ ops,    // (B, MAXS)
                             int32_t* __restrict__ n_ops,
                             int32_t* __restrict__ k_final,
                             int32_t* __restrict__ nm_out,
                             int32_t* __restrict__ i_end,
                             int32_t* __restrict__ i_start) {
  static_assert(NC % 4 == 0 && NC <= 64, "NC: whole words, one e_ext mask");
  const int lane = threadIdx.x & 31;
  const int b = int((int64_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  if (b >= B) return;  // b is the same for the whole warp
  const int plen = lens[b];
  const int tlen = tlens[b];
  const int32_t* __restrict__ txt = texts + int64_t(b) * TW;
  const int32_t* __restrict__ pat = pats + int64_t(b) * M;
  const int32_t* __restrict__ mmr = mms + int64_t(b) * M;
  const int rows = plen < M ? plen : M;
  const int kl = lane * NC;          // this lane's first band cell
  constexpr int kRowWords = 8 * NC;  // 32 lanes * NC bytes / 4
  uint32_t* __restrict__ dread = dirs + int64_t(b) * M * kRowWords;

  int H[NC], E[NC], T[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    H[c] = 0;
    E[c] = kNegInf;
    T[c] = (kl + c < TW) ? txt[kl + c] : 0;
  }
  int bst = 0, bi = 0, bk = 0;  // LOCAL sink: best in-range cell, row, k

  // ---- forward pass: rows 1..plen (later rows are never walked) ----------
  for (int im1 = 0; im1 < rows; ++im1) {
    const int p = pat[im1];
    const int mmv = mmr[im1];
    // cell k+1 of the run's last cell, from the previous row
    const int hn = __shfl_down_sync(kFull, H[0], 1);
    const int en = __shfl_down_sync(kFull, E[0], 1);
    uint64_t ee = 0;     // e_ext bit of each cell
    int gl = kNegInf;    // in-lane running max of G[k] = H0[k] + to - te*k
    int gl2 = kNegInf;   // the same over all but the run's last cell
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int k = kl + c;
      int sub = (p == T[c]) ? match : mmv;
      sub = (im1 + k < tlen) ? sub : kNegInf;
      const int diag = H[c] + sub;
      const bool nb = k + 1 < W;
      const int ep = (nb ? ((c + 1 < NC) ? E[c + 1] : en) : kNegInf) + pe;
      const int hp = (nb ? ((c + 1 < NC) ? H[c + 1] : hn) : kNegInf) + po;
      const int er = max(ep, hp);
      ee |= uint64_t(ep >= hp) << c;
      int h0 = max(diag, er);
      if (LOCAL) h0 = max(h0, 0);
      if (c + 1 == NC) gl2 = gl;
      gl = max(gl, h0 + to - te * k);
      H[c] = diag;  // the previous row's H[c] is no longer needed
      E[c] = er;
    }
    // exclusive max-scan of the lane totals: g = P[kl - 1], floored at
    // NEG_INF (gl starts there, as the TPU's shift-in does)
    int x = gl;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = max(x, y);
    }
    int g = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) g = kNegInf;
    // P[kl - 2]: lane j-1's prefix before its last cell
    int gp = __shfl_up_sync(kFull, max(g, gl2), 1);
    if (lane == 0) gp = kNegInf;

    uint32_t* __restrict__ drow = dread + int64_t(im1) * kRowWords +
                                  lane * (NC / 4);
    uint32_t word = 0;
    int rb = kNegInf, rk = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int k = kl + c;
      const int diag = H[c];
      const int er = E[c];
      int h0 = max(diag, er);
      if (LOCAL) h0 = max(h0, 0);
      const int f = (k == 0) ? kNegInf - te : g + te * (k - 1);
      const int fe = (k == 0) ? int(kNegInf - te == kNegInf + te)
                              : int(g == gp);
      gp = g;
      g = max(g, h0 + to - te * k);
      const int h = max(h0, f);
      int hdir = (h == diag) ? 0 : ((h == er) ? 1 : 2);
      if (LOCAL) {
        hdir = (h == 0) ? 3 : hdir;  // zero-stop cell
        if (k < W && im1 + k < tlen && h > rb) {
          rb = h;
          rk = k;
        }
      }
      const int mism = p != T[c];
      word |= uint32_t(hdir | (int((ee >> c) & 1) << 2) | (fe << 3) |
                       (mism << 4))
              << (8 * (c & 3));
      if ((c & 3) == 3) {
        drow[c >> 2] = word;
        word = 0;
      }
      H[c] = h;
    }
    if (LOCAL) {
      const int wb = __reduce_max_sync(kFull, rb);
      if (wb > bst) {  // the same on every lane
        const int src = __ffs(__ballot_sync(kFull, rb == wb)) - 1;
        bk = __shfl_sync(kFull, rk, src);
        bst = wb;
        bi = im1 + 1;
      }
    }
    // roll the text window one column
    const int tn = __shfl_down_sync(kFull, T[0], 1);
#pragma unroll
    for (int c = 0; c + 1 < NC; ++c) T[c] = T[c + 1];
    const int nxt = im1 + 1 + kl + NC - 1;
    T[NC - 1] = (lane < 31) ? tn : ((nxt < TW) ? txt[nxt] : 0);
  }

  int smax, k0, i0;
  if (LOCAL) {
    smax = bst;
    k0 = bk;
    i0 = bi;
  } else {
    // FIN is the row at plen; NEG_INF everywhere when plen is 0 or past M
    const bool has_fin = plen >= 1 && plen <= M;
    int lm = INT_MIN, lk = 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int v = (kl + c < W) ? (has_fin ? H[c] : kNegInf) : INT_MIN;
      if (v > lm) {
        lm = v;
        lk = kl + c;
      }
    }
    smax = __reduce_max_sync(kFull, lm);
    const int src = __ffs(__ballot_sync(kFull, lm == smax)) - 1;
    k0 = min(__shfl_sync(kFull, lk, src), W - 1);
    i0 = plen;
  }

  // ---- traceback walk, END -> START, by lane 0 ----------------------------
  int32_t* __restrict__ orow = ops + int64_t(b) * MAXS;
  for (int c = lane; c < MAXS; c += 32) orow[c] = 0;
  __syncwarp();  // the warp's direction and zero stores before lane 0 reads
  if (lane != 0) return;
  const uint8_t* __restrict__ dbytes =
      reinterpret_cast<const uint8_t*>(dread);
  int i = i0, k = k0, st = 0, cursor = 0, nm = 0;
  if (LOCAL || plen <= M) {
    const int cap = 2 * (M + W);
    for (int step = 0; step < cap && i >= 1; ++step) {
      const int cell = dbytes[int64_t(i - 1) * (4 * kRowWords) + k];
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
  score[b] = smax;
  kbest[b] = k0;
  n_ops[b] = cursor;
  k_final[b] = k;
  nm_out[b] = nm;
  i_end[b] = i0;
  i_start[b] = i;
}

template <int NC, bool LOCAL>
cudaError_t launch(const void* pats, const void* lens, const void* texts,
                   const void* tlens, const void* mms, int B, int M, int TW,
                   int MAXS, int W, int match, int po, int pe, int to, int te,
                   void* dirs, void* const* outs, cudaStream_t stream) {
  const int threads = 128;  // four reads per block, one warp each
  const unsigned blocks = unsigned((int64_t(B) * 32 + threads - 1) / threads);
  banded_traceback_wide_kernel<NC, LOCAL><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(pats), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(texts), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(mms), B, M, TW, MAXS, W, match, po, pe, to,
      te, static_cast<uint32_t*>(dirs), static_cast<int32_t*>(outs[0]),
      static_cast<int32_t*>(outs[1]), static_cast<int32_t*>(outs[2]),
      static_cast<int32_t*>(outs[3]), static_cast<int32_t*>(outs[4]),
      static_cast<int32_t*>(outs[5]), static_cast<int32_t*>(outs[6]),
      static_cast<int32_t*>(outs[7]));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// nc: band cells per lane (an instantiated value with 32*nc >= W); dirs:
// B*M*32*nc bytes of scratch; outs: score, k_best, ops, n_ops, k_final, nm,
// i_end, i_start (device pointers). Returns 0 on success, a cudaError_t code
// after a failed launch, or -1 for an nc without an instantiation or too
// small for W.
int nvbt_banded_traceback_wide(const void* pats, const void* lens,
                               const void* texts, const void* tlens,
                               const void* mms, int B, int M, int TW,
                               int MAXS, int W, int nc, int local, int match,
                               int po, int pe, int to, int te, void* dirs,
                               void* const* outs, void* stream) {
  if (W < 1 || 32 * nc < W) return -1;
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
#define NVBT_CALL(NN)                                                       \
  case NN:                                                                  \
    return int(local ? launch<NN, true>(pats, lens, texts, tlens, mms, B, M, \
                                        TW, MAXS, W, match, po, pe, to, te,  \
                                        dirs, outs, st)                      \
                     : launch<NN, false>(pats, lens, texts, tlens, mms, B,   \
                                         M, TW, MAXS, W, match, po, pe, to,  \
                                         te, dirs, outs, st));
  // the bands T + M = 2L + W - 1 of the documented read lengths: 230 (L =
  // 100) -> 8, 286 (the CLI's 128) -> 12, 1054 (MapParams' cap of 512) ->
  // 36, the cap; any W <= 1152 takes the smallest that holds it
  switch (nc) {
    NVBT_CALL(8)
    NVBT_CALL(12)
    NVBT_CALL(36)
    default:
      return -1;
  }
#undef NVBT_CALL
}

}  // extern "C"
