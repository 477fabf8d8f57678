// Fused banded traceback kernel (K2): banded Gotoh forward pass, SEMI_GLOBAL
// or LOCAL, that records one direction nibble per cell, then each read's
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
// bits: hdir prefers diag, then E, then F (:335-336); e_ext is
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
// chain of dependent steps. The first design (one thread per read, two
// passes over the band per row) kept six band arrays live (254 registers, 8
// warps per SM), stored 31 single bytes a row into a [row][k][read] scratch,
// walked it one dependent byte load a step and wrote one 4-byte op entry a
// step, 544 bytes from its neighbour's. This design:
//   * One pass over the band per row: diag, E, H0, e_ext, F, f_ext, H and
//     the direction of each cell are made and consumed there; only H, E and
//     the text window persist across rows, within 128 registers (launch
//     bounds; the one-lane LOCAL variant spills a few bytes to L1). A
//     window that spans every row's band (tlen >= plen + W - 1, almost every
//     read) takes a row loop without the length mask.
//   * Four direction bits per cell (hdir 2, e_ext, f_ext), eight cells to a
//     32-bit word and a read's row to one 16-byte vector (DV of them past
//     band 32), scratch laid out [row][read] so a warp's row stores
//     coalesce (one store a row, not W).
//     The walk recomputes the mismatch bit from the pattern row and the text
//     symbol. Patterns and penalties are read in their (B, M) layout: no
//     transposing copies.
//   * The walk moves up or left only, so it loads the direction rows three
//     rows ahead; it buffers four op entries (7 bits each) in one register
//     and writes them, and the zero fill, as 16-byte stores.
//   * A group of R lanes per read (template R, 1 or 4; `k2_group` in
//     align/kernels.py picks it from the batch): lane j owns the contiguous
//     cells [j*NC, j*NC + NC), NC = ceil(W/R). The k+1 neighbour's H and E
//     cross the lane boundary by one shuffle each; F's prefix max is an
//     in-lane running max plus a log2(R)-step shuffle scan (f_ext at a
//     lane's first cell also takes the prefix two cells back from lane
//     j-1); LOCAL's row sink and the FIN max are group reductions that keep
//     the first k; lane 0 walks. Every per-cell constant of k = kl + c is
//     hoisted out of the row loop, and the band edge (cell W-1) is one
//     compile-time cell of one lane, so no cell tests k at run time.
// Any band compiles: the band arrays grow with W and spill past the 128
// registers of the launch bounds (PERF.md lists registers and spills by
// band); 4 lanes a read need W >= 5.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kNegInf = -(1 << 24);

template <int R>
__device__ __forceinline__ int shfl_down(unsigned mask, int v) {
  return __shfl_down_sync(mask, v, 1, R);
}

// the group's max of v and, among lanes holding it, the least k
template <int R>
__device__ __forceinline__ void group_argmax(unsigned mask, int& v, int& k) {
  int m = v;
#pragma unroll
  for (int d = R / 2; d >= 1; d >>= 1) m = max(m, __shfl_xor_sync(mask, m, d, R));
  int kk = (v == m) ? k : INT_MAX;
#pragma unroll
  for (int d = R / 2; d >= 1; d >>= 1)
    kk = min(kk, __shfl_xor_sync(mask, kk, d, R));
  v = m;
  k = kk;
}

// a lane's N direction words at p (16-byte aligned where N % 4 == 0, 8-byte
// where N % 2 == 0)
template <int N>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ p,
                                            const uint32_t (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<uint4*>(p + i) =
          make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      *reinterpret_cast<uint2*>(p + i) = make_uint2(w[i], w[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = w[i];
  }
}

// a read's row of directions: R * NWL words in DV 16-byte vectors
template <int DV>
struct DirRow {
  uint4 v[DV];
};

// at most 128 registers a thread: four blocks (16 warps) per SM
template <int W, int R, bool LOCAL>
__global__ void __launch_bounds__(128, 4)
banded_traceback_kernel(const int32_t* __restrict__ pats,    // (B, M)
                        const int32_t* __restrict__ lens,    // (B,)
                        const int32_t* __restrict__ texts,   // (B, TW)
                        const int32_t* __restrict__ tlens,   // (B,)
                        const int32_t* __restrict__ mms,     // (B, M)
                        int B, int M, int TW, int MAXS, int match, int po,
                        int pe, int to, int te,
                        uint32_t* __restrict__ dirs,         // (M, B, 4)
                        int32_t* __restrict__ score, int32_t* __restrict__ kbest,
                        int32_t* __restrict__ ops,           // (B, MAXS)
                        int32_t* __restrict__ n_ops, int32_t* __restrict__ k_final,
                        int32_t* __restrict__ nm_out, int32_t* __restrict__ i_end,
                        int32_t* __restrict__ i_start) {
  constexpr int NC = (W + R - 1) / R;  // band cells per lane
  constexpr int NWL = (NC + 7) / 8;    // direction words per lane and row
  constexpr int DV = (R * NWL + 3) / 4;  // 16-byte vectors per read and row
  static_assert(R == 1 || NC >= 2, "f_ext at a lane's first cell");
  const int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const int b = int(t / R);
  const int lane = int(t % R);
  if (b >= B) return;  // the whole group
  const unsigned gmask =
      R == 32 ? 0xffffffffu
              : ((1u << R) - 1) << ((threadIdx.x & 31) & ~unsigned(R - 1));
  const int plen = lens[b];
  const int tlen = tlens[b];
  const int32_t* __restrict__ txt = texts + int64_t(b) * TW;
  const int32_t* __restrict__ prow = pats + int64_t(b) * M;
  const int32_t* __restrict__ mrow = mms + int64_t(b) * M;
  // this read's direction row of pattern row r (DV 16-byte vectors):
  // dread + r * rstride
  const int64_t rstride = int64_t(B) * 4 * DV;
  uint32_t* __restrict__ dread = dirs + int64_t(b) * 4 * DV;
  const int rows = plen < M ? plen : M;
  const int kl = lane * NC;  // this lane's first band cell

  int H[NC], E[NC], T[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    H[c] = 0;
    E[c] = kNegInf;
    T[c] = (kl + c < TW) ? txt[kl + c] : 0;
  }
  int bst = 0, bi = 0, bk = 0;  // LOCAL sink: best in-range cell, row, k
  // Per-lane constants, so that no cell tests its band index k = kl + c at
  // run time: band index W-1 (whose k+1 neighbour is the band edge) is cell
  // CL of lane JL; cells past it (k >= W) are computed and never read; F's
  // per-cell offsets te*(k-1) and to - te*k; the cells with k < W.
  constexpr int JL = (W - 1) / NC, CL = (W - 1) % NC;
  const bool edge_lane = lane == JL;
  int fk[NC], gk[NC];
  uint32_t real = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    fk[c] = te * (kl + c - 1);
    gk[c] = to - te * (kl + c);
    real |= uint32_t(kl + c < W) << c;
  }

  // one row of the forward pass; MASK: cells past the text are NEG_INF
  // (a window that spans every row's band has none)
  auto row = [&](int im1, int p, int mmv, auto masked) {
    constexpr bool MASK = decltype(masked)::value;
    // the previous row's H and E at cell k+1 of this lane's last cell
    int hn = kNegInf, en = kNegInf;
    if (R > 1) {
      hn = shfl_down<R>(gmask, H[0]);
      en = shfl_down<R>(gmask, E[0]);
    }
    uint32_t ee = 0;  // e_ext of each cell (R > 1: kept for the second loop)
    // F's floored prefix max P through the cell before this one (g) and
    // two before (gp); for R > 1 the first loop gathers the lane's own
    int g = kNegInf, gp = kNegInf, gl2 = kNegInf;
    int rb = kNegInf, rk = 0;  // LOCAL: this row's best in-range cell
    uint32_t wv[NWL];
#pragma unroll
    for (int i = 0; i < NWL; ++i) wv[i] = 0u;

    // one cell's F, H, direction and sink from its diag, E and e_ext
    auto finish = [&](int c, int diag, int er, uint32_t eb) {
      int h0 = max(diag, er);
      if (LOCAL) h0 = max(h0, 0);
      // cell k = 0 (c = 0 of lane 0): F = NEG_INF - te, f_ext = (te == 0)
      const bool k0 = c == 0 && lane == 0;
      const int f = k0 ? kNegInf - te : g + fk[c];
      const int fe = k0 ? int(kNegInf - te == kNegInf + te) : int(g == gp);
      gp = g;
      g = __viaddmax_s32(h0, gk[c], g);
      const int h = max(h0, f);
      int hdir = (h == diag) ? 0 : ((h == er) ? 1 : 2);
      if (LOCAL) {
        hdir = (h == 0) ? 3 : hdir;  // zero-stop cell
        if (((real >> c) & 1u) && (!MASK || im1 + kl + c < tlen) && h > rb) {
          rb = h;
          rk = kl + c;
        }
      }
      wv[c >> 3] |= uint32_t(hdir | (eb << 2) | (fe << 3)) << (4 * (c & 7));
      H[c] = h;
    };

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      int sub = (p == T[c]) ? match : mmv;
      if (MASK) sub = (im1 + kl + c < tlen) ? sub : kNegInf;
      const int diag = H[c] + sub;
      int en1 = (c + 1 < NC) ? E[c + 1] : en;
      int hn1 = (c + 1 < NC) ? H[c + 1] : hn;
      if (c == CL) {  // band index W-1 in the edge lane: both arms NEG_INF
        en1 = edge_lane ? kNegInf : en1;
        hn1 = edge_lane ? kNegInf : hn1;
      }
      const int ep = en1 + pe;
      const int hp = hn1 + po;
      const int er = max(ep, hp);
      const uint32_t eb = ep >= hp;
      E[c] = er;
      if (R == 1) {
        finish(c, diag, er, eb);
      } else {
        ee |= eb << c;
        int h0 = max(diag, er);
        if (LOCAL) h0 = max(h0, 0);
        if (c + 1 == NC) gl2 = g;
        g = __viaddmax_s32(h0, gk[c], g);
        H[c] = diag;  // the previous row's H[c] is no longer needed
      }
    }
    if (R > 1) {
      // exclusive max-scan of the lane totals over the group: P[kl - 1],
      // floored at NEG_INF; and P[kl - 2] from lane j-1
      int x = g;
#pragma unroll
      for (int d = 1; d < R; d <<= 1) {
        const int y = __shfl_up_sync(gmask, x, d, R);
        if (lane >= d) x = max(x, y);
      }
      g = __shfl_up_sync(gmask, x, 1, R);
      if (lane == 0) g = kNegInf;
      gp = __shfl_up_sync(gmask, max(g, gl2), 1, R);
      if (lane == 0) gp = kNegInf;
#pragma unroll
      for (int c = 0; c < NC; ++c) finish(c, H[c], E[c], (ee >> c) & 1u);
    }
    store_words<NWL>(dread + im1 * rstride + lane * NWL, wv);
    if (LOCAL) {
      if (R > 1) group_argmax<R>(gmask, rb, rk);
      if (rb > bst) {  // the same on every lane
        bst = rb;
        bi = im1 + 1;
        bk = rk;
      }
    }
    // roll the text window one column
    int tn = 0;
    if (R > 1) tn = shfl_down<R>(gmask, T[0]);
#pragma unroll
    for (int c = 0; c + 1 < NC; ++c) T[c] = T[c + 1];
    const int nxt = im1 + 1 + kl + NC - 1;
    T[NC - 1] = (lane + 1 < R) ? tn : ((nxt < TW) ? txt[nxt] : 0);
  };

  // ---- forward pass: rows 1..plen (later rows are never walked) ----------
  auto rows_loop = [&](auto masked) {
    int p_next = rows > 0 ? prow[0] : 0;
    int mm_next = rows > 0 ? mrow[0] : 0;
    for (int im1 = 0; im1 < rows; ++im1) {
      const int p = p_next;
      const int mmv = mm_next;
      if (im1 + 1 < rows) {  // the next row's loads, a row ahead
        p_next = prow[im1 + 1];
        mm_next = mrow[im1 + 1];
      }
      row(im1, p, mmv, masked);
    }
  };
  if (tlen >= rows + W - 1)  // the window spans every row's band
    rows_loop(std::false_type{});
  else
    rows_loop(std::true_type{});

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
    if (R > 1) group_argmax<R>(gmask, lm, lk);
    smax = lm;
    k0 = min(lk, W - 1);
    i0 = plen;
  }
  if (R > 1) __syncwarp(gmask);  // the group's direction stores, then the walk
  if (lane != 0) return;

  // ---- traceback walk, END -> START, by lane 0 ----------------------------
  // A step moves up a row (M, I) or left (D): the text index i-1+k falls by
  // 0 or 1, the row by 0 or 1. So the direction rows, pattern symbols and
  // text symbols the next steps need are loaded three ahead, and no step
  // waits on a load.
  auto drow = [&](int r) {
    const uint4* p = reinterpret_cast<const uint4*>(dread + max(r, 0) * rstride);
    DirRow<DV> x;
#pragma unroll
    for (int d = 0; d < DV; ++d) x.v[d] = p[d];
    return x;
  };
  auto pat_at = [&](int r) { return prow[max(r, 0)]; };
  auto txt_at = [&](int x) { return txt[max(x, 0)]; };
  int i = i0, k = k0, st = 0, cursor = 0, nm = 0;
  DirRow<DV> cur = drow(i - 1), n1 = drow(i - 2), n2 = drow(i - 3);
  int pc = pat_at(i - 1), p1 = pat_at(i - 2), p2 = pat_at(i - 3);
  int x = i - 1 + k;
  int tc = txt_at(x), t1 = txt_at(x - 1), t2 = txt_at(x - 2);
  uint32_t acc = 0;  // up to four 7-bit op entries, one per byte
  int4* __restrict__ orow = reinterpret_cast<int4*>(ops + int64_t(b) * MAXS);
  if (LOCAL || plen <= M) {
    const int cap = 2 * (M + W);
    for (int step = 0; step < cap && i >= 1; ++step) {
      // cell k is cell c of lane j: word j*NWL + c/8, nibble c%8
      const int j = R == 1 ? 0 : k / NC, c = k - j * NC;
      const int wi = j * NWL + (c >> 3);
      uint4 q = cur.v[0];
#pragma unroll
      for (int d = 1; d < DV; ++d) q = ((wi >> 2) == d) ? cur.v[d] : q;
      const uint32_t w = (wi & 2) ? ((wi & 1) ? q.w : q.z)
                                  : ((wi & 1) ? q.y : q.x);
      const int cell = int(w >> (4 * (c & 7))) & 15;
      const int hdir = cell & 3;
      if (LOCAL && st == 0 && hdir == 3) break;  // zero-stop: (i, k) stay
      // the op: M (sel 0), I (1, from E) or D (2, from F); the state stays
      // in a gap while its extension bit is set
      const int sel = st ? st : hdir;
      const int mism = (sel == 0) & (pc != tc);
      nm += sel ? 1 : mism;
      if (cursor < MAXS) {
        acc |= uint32_t((sel + 1) | (mism << 2) | ((tc & 15) << 3))
               << (8 * (cursor & 3));
        if ((cursor & 3) == 3) {
          orow[cursor >> 2] = make_int4(acc & 0xff, (acc >> 8) & 0xff,
                                        (acc >> 16) & 0xff, acc >> 24);
          acc = 0;
        }
      }
      ++cursor;
      st = sel == 1 ? ((cell >> 2) & 1) : (sel == 2 ? ((cell >> 2) & 2) : 0);
      if (sel != 2) {  // up a row
        --i;
        cur = n1;
        n1 = n2;
        n2 = drow(i - 3);
        pc = p1;
        p1 = p2;
        p2 = pat_at(i - 3);
      }
      k = min(max(k + (sel == 1) - (sel == 2), 0), W - 1);
      const int xn = i - 1 + k;
      if (xn == x - 1) {
        tc = t1;
        t1 = t2;
        t2 = txt_at(xn - 2);
      } else if (xn != x) {  // k was clamped at the band's edge
        tc = txt_at(xn);
        t1 = txt_at(xn - 1);
        t2 = txt_at(xn - 2);
      }
      x = xn;
    }
  }
  // the open group of four (zeros past the cursor), then zeros to MAXS
  if (cursor < MAXS) {
    orow[cursor >> 2] = make_int4(acc & 0xff, (acc >> 8) & 0xff,
                                  (acc >> 16) & 0xff, acc >> 24);
    for (int q = (cursor >> 2) + 1; q < MAXS / 4; ++q)
      orow[q] = make_int4(0, 0, 0, 0);
  }
  score[b] = smax;
  kbest[b] = k0;
  n_ops[b] = cursor;
  k_final[b] = k;
  nm_out[b] = nm;
  i_end[b] = i0;
  i_start[b] = i;
}

template <int W, int R, bool LOCAL>
int launch(const void* pats, const void* lens, const void* texts,
           const void* tlens, const void* mms, int B, int M, int TW,
           int MAXS, int match, int po, int pe, int to, int te,
           void* dirs, void* const* outs, cudaStream_t stream) {
  // a lane group needs two band cells a lane (W >= 5 at 4 lanes)
  if constexpr (R > 1 && (W + R - 1) / R < 2) {
    return -1;
  } else {
    const int threads = 128;
    const unsigned blocks = unsigned((int64_t(B) * R + threads - 1) / threads);
    banded_traceback_kernel<W, R, LOCAL><<<blocks, threads, 0, stream>>>(
        static_cast<const int32_t*>(pats), static_cast<const int32_t*>(lens),
        static_cast<const int32_t*>(texts), static_cast<const int32_t*>(tlens),
        static_cast<const int32_t*>(mms), B, M, TW, MAXS, match, po, pe, to,
        te, static_cast<uint32_t*>(dirs), static_cast<int32_t*>(outs[0]),
        static_cast<int32_t*>(outs[1]), static_cast<int32_t*>(outs[2]),
        static_cast<int32_t*>(outs[3]), static_cast<int32_t*>(outs[4]),
        static_cast<int32_t*>(outs[5]), static_cast<int32_t*>(outs[6]),
        static_cast<int32_t*>(outs[7]));
    return int(cudaGetLastError());
  }
}

template <int W, int R>
int launch_r(int local, const void* pats, const void* lens, const void* texts,
             const void* tlens, const void* mms, int B, int M, int TW,
             int MAXS, int match, int po, int pe, int to, int te, void* dirs,
             void* const* outs, cudaStream_t st) {
  return local ? launch<W, R, true>(pats, lens, texts, tlens, mms, B, M, TW,
                                    MAXS, match, po, pe, to, te, dirs, outs,
                                    st)
               : launch<W, R, false>(pats, lens, texts, tlens, mms, B, M,
                                     TW, MAXS, match, po, pe, to, te, dirs,
                                     outs, st);
}

}  // namespace

extern "C" {

// pats, mms: (B, M); group: lanes per read (1 or 4; 4 needs W >= 5); dirs:
// M * B * 4 * DV words of scratch, DV = ceil(group * ceil(ceil(W/group)/8)
// / 4) (`kernels.k2_row_words`); outs: score, k_best, ops, n_ops, k_final,
// nm, i_end, i_start (device pointers); local selects the LOCAL variant.
// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for
// a band width or group without an instantiation. The library holds the
// bands 7, 9, 11, 17 and 31, or with -DNVBT_EXTRA_BAND=W that band alone
// (align/kernels.py builds one at the first use of a band outside the five).
int nvbt_banded_traceback(const void* pats, const void* lens,
                          const void* texts, const void* tlens,
                          const void* mms, int B, int M, int TW, int MAXS,
                          int W, int group, int local, int match, int po,
                          int pe, int to, int te, void* dirs,
                          void* const* outs, void* stream) {
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
#define NVBT_R(WW, RR)                                                      \
  case RR:                                                                  \
    return int(launch_r<WW, RR>(local, pats, lens, texts, tlens, mms, B, M, \
                                TW, MAXS, match, po, pe, to, te, dirs,      \
                                outs, st));
#define NVBT_CALL(WW)   \
  case WW:              \
    switch (group) {    \
      NVBT_R(WW, 1)     \
      NVBT_R(WW, 4)     \
      default:          \
        return -1;      \
    }
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
#undef NVBT_R
}

}  // extern "C"
