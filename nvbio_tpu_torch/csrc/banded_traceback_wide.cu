// Wide banded traceback kernel (K2-WIDE): K2's fused banded Gotoh forward
// pass + traceback walk, SEMI_GLOBAL or LOCAL, for bands too wide for one
// thread's registers: any W, the widths up to 32 * 36 = 1152 from three
// compiled cells-per-lane counts, a wider band from a library of its own
// that align/kernels.py builds at its first use (-DNVBT_EXTRA_BAND=W
// -DNVBT_EXTRA_NC=nc).
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
// What bounds it on an H100: integer instructions of the forward pass (at
// least 17 per cell, 22 for LOCAL, as K2; counted in chip_smoke.py). The
// first design (one warp per read, 8 cells a lane at W = 230) wrote one
// direction byte per cell to a 839 MB global scratch (B = 32768), walked it
// one dependent global byte load a step by lane 0, made two full passes
// over a lane's cells per row with a runtime band-edge test in both, and
// rolled the text window through seven register moves and a shuffle. This
// design:
//   * One warp per read, two reads per block: lane j owns the contiguous
//     band cells [j*NC, j*NC + NC) (template NC, 32*NC >= W; cells past W
//     are computed and never read). Sixteen lanes of 16 cells at W = 230
//     were slower on an H100 (PERF.md).
//   * Four direction bits per cell (hdir 2, e_ext, f_ext); the walk
//     recomputes the mismatch bit from the pattern and text symbols, as K2.
//     A read's row of directions is its band's nibbles in band order (RB
//     bytes: the lanes that hold band cells), so the walk reads cell k of
//     row r at byte r*RB + k/2.
//   * The directions live in shared memory wherever a read's rows fit
//     (route SMEM; `kernels.wide_route` picks it from (M, W): 11.6 KB a read
//     at W = 230, M = 100); only bands that do not fit (1054 at M = 512,
//     276 KB a read) write them to a global scratch of the same layout. The
//     read's pattern and text are staged in shared memory in both routes, so
//     the walk touches global memory only for its op stores.
//   * DPX: the lazy F's prefix max is one __viaddmax_s32 a cell, LOCAL's
//     floored H0 one __vimax3_s32. Its per-cell offsets (to - te*c and
//     te*(c-1), relative to the lane's first cell) are the same for every
//     lane, kernel parameters in the constant bank; the cross-lane scan
//     works in absolute values, moved by te*j*NC at the lane boundary.
//   * One full pass per row (diag, E, e_ext, H0 and the lane's prefix) and
//     a light second one (F, f_ext, H, hdir) after the cross-lane scan:
//     K2's R-lane row (csrc/banded_traceback.cu). Each direction bit is a
//     compare and an OR into the row's nibble word.
//   * The band edge (cell W-1, whose E arms are NEG_INF) costs a test per
//     cell at run time; the bands of the documented read lengths (230,
//     286, 1054) are compiled in, so only one cell of one lane tests it.
//   * The text window advances by one shared-memory load a row per lane.
// The warp-level work per row: two shuffles for the k+1 neighbour, a
// 5-step scan plus two shuffles for F, and in LOCAL the row's sink (two
// warp reductions). After the forward pass the warp walks END -> START from
// shared memory, bounded by 2*(M+W) steps as K2: 32 diagonal steps at a time
// (lane j reads the cell j rows up; a ballot ends the run; the run's op
// entries go out as one coalesced store), the other steps one at a time, so
// a read's walk takes one warp step per run where one lane took a step per
// op.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kNegInf = -(1 << 24);
constexpr int kLanes = 32;    // a warp per read
constexpr int kThreads = 64;  // two reads per block
constexpr unsigned kFull = 0xffffffffu;

// per band cell c of a lane: te*(c-1) (F) and to - te*c (the prefix's G),
// both relative to the lane's first cell
template <int NC>
struct CellConsts {
  int fk[NC];
  int gk[NC];
};

// bytes of one read's staged pattern and text (int32, the text zero-padded
// to M + 32*NC so the last lane's window needs no bound)
__host__ __device__ constexpr int64_t stage_bytes(int M, int NC) {
  return ((int64_t(M) + M + kLanes * NC) * 4 + 15) / 16 * 16;
}

// bytes of one row of a read's directions: the nibbles of the lanes that
// hold band cells (lanes past W store nothing)
__host__ __device__ constexpr int row_bytes(int W, int NC) {
  return (W + NC - 1) / NC * NC / 2;
}

// one read's shared memory: its staged pattern and text, and its rows of
// directions in the SMEM route
__host__ __device__ constexpr int64_t read_bytes(int M, int W, int NC,
                                                 bool smem) {
  return (stage_bytes(M, NC) + (smem ? int64_t(M) * row_bytes(W, NC) : 0) +
          15) / 16 * 16;
}

// the warp's max of v and, among lanes holding it, the least k
__device__ __forceinline__ void warp_argmax(int& v, int& k) {
  const int m = __reduce_max_sync(kFull, v);
  k = __reduce_min_sync(kFull, v == m ? k : INT_MAX);
  v = m;
}

// a lane's NC nibbles (NC/8 words or NC/4 half-words) at byte lane*NC/2
template <int NC>
__device__ __forceinline__ void store_row(unsigned char* row, int lane,
                                          const uint32_t (&w)[(NC + 7) / 8]) {
  unsigned char* p = row + lane * (NC / 2);
  if constexpr (NC % 8 == 0) {
#pragma unroll
    for (int i = 0; i < NC / 8; ++i) reinterpret_cast<uint32_t*>(p)[i] = w[i];
  } else {
#pragma unroll
    for (int i = 0; i < NC / 4; ++i)
      reinterpret_cast<uint16_t*>(p)[i] = uint16_t(w[i >> 1] >> (16 * (i & 1)));
  }
}

template <int NC, int WT, bool LOCAL, bool SMEM>
__global__ void __launch_bounds__(kThreads)
banded_traceback_wide_kernel(const int32_t* __restrict__ pats,    // (B, M)
                             const int32_t* __restrict__ lens,    // (B,)
                             const int32_t* __restrict__ texts,   // (B, TW)
                             const int32_t* __restrict__ tlens,   // (B,)
                             const int32_t* __restrict__ mms,     // (B, M)
                             int B, int M, int TW, int MAXS, int W_arg,
                             int match, int po, int pe, int to, int te,
                             const CellConsts<NC> cc,
                             unsigned char* __restrict__ gdirs,  // B*M*RB
                             int32_t* __restrict__ score,
                             int32_t* __restrict__ kbest,
                             int32_t* __restrict__ ops,    // (B, MAXS)
                             int32_t* __restrict__ n_ops,
                             int32_t* __restrict__ k_final,
                             int32_t* __restrict__ nm_out,
                             int32_t* __restrict__ i_end,
                             int32_t* __restrict__ i_start) {
  static_assert(NC % 4 == 0, "NC: whole half-words of nibbles");
  static_assert(WT <= kLanes * NC, "a compiled band fits its lanes");
  constexpr int RPB = kThreads / kLanes;  // reads per block
  constexpr int NW = (NC + 7) / 8;        // direction words per lane, row
  const int W = WT ? WT : W_arg;
  const int RB = row_bytes(W, NC);        // direction bytes per read, row
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = int(threadIdx.x) / kLanes;
  const int lane = int(threadIdx.x) % kLanes;
  const int b = int(blockIdx.x) * RPB + grp;
  if (b >= B) return;  // the whole warp
  const int plen = lens[b];
  const int tlen = tlens[b];
  const int32_t* __restrict__ txt = texts + int64_t(b) * TW;
  const int32_t* __restrict__ pat = pats + int64_t(b) * M;
  const int32_t* __restrict__ mmr = mms + int64_t(b) * M;
  const int rows = plen < M ? plen : M;
  const int kl = lane * NC;  // this lane's first band cell

  // ---- stage the pattern and the text (zero past TW) ----------------------
  const int64_t stage = stage_bytes(M, NC);
  unsigned char* mine = smem + grp * read_bytes(M, W, NC, SMEM);
  int32_t* spat = reinterpret_cast<int32_t*>(mine);
  int32_t* stxt = spat + M;
  const int tws = M + kLanes * NC;
  for (int x = lane; x < M; x += kLanes) spat[x] = pat[x];
  for (int x = lane; x < tws; x += kLanes) stxt[x] = x < TW ? txt[x] : 0;
  unsigned char* dirs = SMEM ? mine + stage : gdirs + int64_t(b) * M * RB;
  __syncwarp();

  // H: the previous row's H, then this row's H0; D: this row's diagonal
  int H[NC], E[NC], D[NC], T[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    H[c] = 0;
    E[c] = kNegInf;
    T[c] = stxt[kl + c];
  }
  int bst = 0, bi = 0, bk = 0;  // LOCAL sink: best in-range cell, row, k
  // band index W-1, whose E arms are both NEG_INF, is cell CL of lane JL:
  // a compile-time cell for a compiled band, else a runtime test per cell
  const int JL = (W - 1) / NC, CL = (W - 1) % NC;
  const bool edge_lane = lane == JL;
  const int er_edge = max(kNegInf + pe, kNegInf + po);
  const bool eb_edge = kNegInf + pe >= kNegInf + po;
  const int off = te * kl;  // relative prefix values = absolute + off
  const int nreal = W - kl;  // this lane's cells with k < W: c < nreal

  // ---- forward pass: rows 1..plen (later rows are never walked) ----------
  int p_next = rows > 0 ? spat[0] : 0;
  int mm_next = rows > 0 ? mmr[0] : 0;
  for (int im1 = 0; im1 < rows; ++im1) {
    const int p = p_next;
    const int mmv = mm_next;
    if (im1 + 1 < rows) {  // the next row's loads, a row ahead
      p_next = spat[im1 + 1];
      mm_next = mmr[im1 + 1];
    }
    // the previous row's H and E at cell k+1 of this lane's last cell
    const int hn = __shfl_down_sync(kFull, H[0], 1);
    const int en = __shfl_down_sync(kFull, E[0], 1);
    const int tl = tlen - im1 - kl;  // cells c < tl lie in the text
    uint32_t wv[NW];                 // this row's direction nibbles
#pragma unroll
    for (int i = 0; i < NW; ++i) wv[i] = 0;
    int gl = kNegInf + off;  // the lane's floored prefix max (relative)
    int gl2 = gl;            // the same over all but its last cell
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t& w = wv[c >> 3];
      const int sh = 4 * (c & 7);
      int sub = (p == T[c]) ? match : mmv;
      sub = (c < tl) ? sub : kNegInf;
      const int diag = H[c] + sub;
      const int ep = ((c + 1 < NC) ? E[c + 1] : en) + pe;
      const int hp = ((c + 1 < NC) ? H[c + 1] : hn) + po;
      int er = max(ep, hp);
      bool eb = ep >= hp;
      if (c == CL && edge_lane) {
        er = er_edge;
        eb = eb_edge;
      }
      if (eb) w |= 4u << sh;  // e_ext
      const int h0 = LOCAL ? __vimax3_s32(diag, er, 0) : max(diag, er);
      if (c + 1 == NC) gl2 = gl;
      gl = __viaddmax_s32(h0, cc.gk[c], gl);
      H[c] = h0;  // the previous row's H[c] is no longer needed
      E[c] = er;
      D[c] = diag;
    }
    // exclusive max-scan of the lane totals (absolute): P[kl - 1], floored
    // at NEG_INF; and P[kl - 2] from lane j-1 (for cell 0, NEG_INF + 2te,
    // so that f_ext there is (te == 0), as F[0] = NEG_INF - te gives)
    int x = gl - off;
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1)  // lanes below d get their own x
      x = max(x, __shfl_up_sync(kFull, x, d));
    int gin = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) gin = kNegInf;
    int gpa = __shfl_up_sync(kFull, max(gin, gl2 - off), 1);
    if (lane == 0) gpa = kNegInf + 2 * te;
    int g = gin + off, gp = gpa + off;

    int rb = kNegInf, rk = 0;  // LOCAL: this lane's best in-range cell
    const int lim = min(nreal, tl);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t& w = wv[c >> 3];
      const int sh = 4 * (c & 7);
      const int h0 = H[c];
      const int f = g + cc.fk[c];
      if (g == gp) w |= 8u << sh;  // f_ext
      gp = g;
      g = __viaddmax_s32(h0, cc.gk[c], g);
      const int h = max(h0, f);
      // hdir: diag (0) where h is H0 and diag reaches E, E (1) where h is
      // H0 above diag, F (2) where F is above H0; LOCAL: 3 on a zero cell
      const bool fw = h != h0;
      if (fw) w |= 2u << sh;
      if (!fw && D[c] < E[c]) w |= 1u << sh;
      if (LOCAL) {
        if (h == 0) w |= 3u << sh;  // zero-stop cell
        if (c < lim && h > rb) {
          rb = h;
          rk = kl + c;
        }
      }
      H[c] = h;
    }
    if (kl < W) store_row<NC>(dirs + int64_t(im1) * RB, lane, wv);
    if (LOCAL) {
      warp_argmax(rb, rk);
      if (rb > bst) {  // the same on every lane
        bst = rb;
        bi = im1 + 1;
        bk = rk;
      }
    }
    // the text window moves one column
#pragma unroll
    for (int c = 0; c + 1 < NC; ++c) T[c] = T[c + 1];
    T[NC - 1] = stxt[im1 + 1 + kl + NC - 1];
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
      const int v = (c < nreal) ? (has_fin ? H[c] : kNegInf) : INT_MIN;
      if (v > lm) {
        lm = v;
        lk = kl + c;
      }
    }
    warp_argmax(lm, lk);
    smax = lm;
    k0 = min(lk, W - 1);
    i0 = plen;
  }
  __syncwarp();  // the warp's direction stores, then the walk

  // ---- traceback walk, END -> START, by the whole warp ------------------
  // A step reads cell k of row i-1 (byte (i-1)*RB + k/2), the pattern
  // symbol i-1 and the text symbol x = i-1+k from shared memory. In the H
  // state a run of diagonal (M) steps moves up one row at a time with k
  // fixed, so the warp takes 32 of them at once: lane j reads the cell j
  // rows up, a ballot finds the first that is not diagonal, and the lanes
  // before it write their op entries and count their mismatches. Every
  // other step (a gap, the step that ends a run, a zero-stop) is taken by
  // all lanes alike, one at a time.
  int32_t* __restrict__ orow = ops + int64_t(b) * MAXS;
  int i = i0, k = k0, st = 0, nm = 0, cursor = 0;
  if (LOCAL || plen <= M) {
    const int cap = 2 * (M + W);
    int x = i - 1 + k;
    auto nibble = [&](int r) {
      return (dirs[int64_t(r) * RB + (k >> 1)] >> ((k & 1) << 2)) & 15;
    };
    while (cursor < cap && i >= 1) {
      if (st == 0) {
        const bool ok = i - lane >= 1 && cursor + lane < cap;
        const bool dg = ok && (nibble(i - 1 - lane) & 3) == 0;
        const unsigned run = ~__ballot_sync(kFull, dg);
        const int n = run ? __ffs(run) - 1 : kLanes;  // diagonal steps
        bool mism = false;
        if (lane < n) {
          const int tc = stxt[x - lane];
          mism = spat[i - 1 - lane] != tc;
          if (cursor + lane < MAXS)
            orow[cursor + lane] = 1 | (int(mism) << 2) | ((tc & 15) << 3);
        }
        nm += __popc(__ballot_sync(kFull, mism));
        cursor += n;
        i -= n;
        x -= n;
        if (n == kLanes || !(cursor < cap && i >= 1)) continue;
      }
      const int cell = nibble(i - 1);
      const int hdir = cell & 3;
      if (LOCAL && st == 0 && hdir == 3) break;  // zero-stop: (i, k) stay
      // the op: M (sel 0), I (1, from E) or D (2, from F); the state stays
      // in a gap while its extension bit is set
      const int sel = st ? st : hdir;
      const int tc = stxt[x];
      const int mism = (sel == 0) & (spat[i - 1] != tc);
      nm += sel ? 1 : mism;
      if (lane == 0 && cursor < MAXS)
        orow[cursor] = (sel + 1) | (mism << 2) | ((tc & 15) << 3);
      ++cursor;
      st = sel == 1 ? ((cell >> 2) & 1) : (sel == 2 ? ((cell >> 2) & 2) : 0);
      const int up = sel != 2;
      const int kn = min(max(k + (sel == 1) - (sel == 2), 0), W - 1);
      i -= up;
      x += kn - k - up;
      k = kn;
    }
  }
  if (lane == 0) {
    score[b] = smax;
    kbest[b] = k0;
    n_ops[b] = cursor;
    k_final[b] = k;
    nm_out[b] = nm;
    i_end[b] = i0;
    i_start[b] = i;
  }
  // the rest of the op row, zeros
  for (int q = cursor + lane; q < MAXS; q += kLanes) orow[q] = 0;
}

template <int NC, int WT, bool LOCAL, bool SMEM>
cudaError_t launch(const void* pats, const void* lens, const void* texts,
                   const void* tlens, const void* mms, int B, int M, int TW,
                   int MAXS, int W, int match, int po, int pe, int to, int te,
                   void* dirs, void* const* outs, cudaStream_t stream) {
  constexpr int RPB = kThreads / kLanes;
  const int64_t shmem = RPB * read_bytes(M, W, NC, SMEM);
  auto kern = banded_traceback_wide_kernel<NC, WT, LOCAL, SMEM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shmem));
  if (err != cudaSuccess) return err;
  CellConsts<NC> cc;
  for (int c = 0; c < NC; ++c) {
    cc.fk[c] = te * (c - 1);
    cc.gk[c] = to - te * c;
  }
  const unsigned blocks = unsigned((int64_t(B) + RPB - 1) / RPB);
  kern<<<blocks, kThreads, size_t(shmem), stream>>>(
      static_cast<const int32_t*>(pats), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(texts), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(mms), B, M, TW, MAXS, W, match, po, pe, to,
      te, cc, static_cast<unsigned char*>(dirs),
      static_cast<int32_t*>(outs[0]), static_cast<int32_t*>(outs[1]),
      static_cast<int32_t*>(outs[2]), static_cast<int32_t*>(outs[3]),
      static_cast<int32_t*>(outs[4]), static_cast<int32_t*>(outs[5]),
      static_cast<int32_t*>(outs[6]), static_cast<int32_t*>(outs[7]));
  return cudaGetLastError();
}

// WB: the band compiled in for this NC; any other W tests its band edge at
// run time
template <int NC, int WB>
cudaError_t launch_v(int local, int smem, const void* pats, const void* lens,
                     const void* texts, const void* tlens, const void* mms,
                     int B, int M, int TW, int MAXS, int W, int match, int po,
                     int pe, int to, int te, void* dirs, void* const* outs,
                     cudaStream_t st) {
#define NVBT_ARGS                                                          \
  pats, lens, texts, tlens, mms, B, M, TW, MAXS, W, match, po, pe, to, te, \
      dirs, outs, st
#define NVBT_W(WT)                                            \
  if (local)                                                 \
    return smem ? launch<NC, WT, true, true>(NVBT_ARGS)      \
                : launch<NC, WT, true, false>(NVBT_ARGS);    \
  return smem ? launch<NC, WT, false, true>(NVBT_ARGS)       \
              : launch<NC, WT, false, false>(NVBT_ARGS);
  if (W == WB) {
    NVBT_W(WB)
  }
  NVBT_W(0)
#undef NVBT_W
#undef NVBT_ARGS
}

}  // namespace

extern "C" {

// nc: band cells per lane (an instantiated value with 32*nc >= W); smem:
// 1 keeps the directions in shared memory, 0 writes them to dirs (B*M*16*nc
// bytes of scratch; unused with 1); outs: score, k_best, ops, n_ops,
// k_final, nm, i_end, i_start (device pointers). Returns 0 on success, a
// cudaError_t code after a failed launch, or -1 for an nc without an
// instantiation or too small for W.
int nvbt_banded_traceback_wide(const void* pats, const void* lens,
                               const void* texts, const void* tlens,
                               const void* mms, int B, int M, int TW,
                               int MAXS, int W, int nc, int smem, int local,
                               int match, int po, int pe, int to, int te,
                               void* dirs, void* const* outs, void* stream) {
  if (W < 1 || kLanes * nc < W) return -1;
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
#define NVBT_CALL(NN, WB)                                                   \
  case NN:                                                                  \
    return int(launch_v<NN, WB>(local, smem, pats, lens, texts, tlens, mms, \
                                B, M, TW, MAXS, W, match, po, pe, to, te,   \
                                dirs, outs, st));
  // the bands T + M = 2L + W - 1 of the documented read lengths, each
  // compiled in: 230 (L = 100) -> 8 cells a lane, 286 (the CLI's 128) ->
  // 12, 1054 (MapParams' cap of 512) -> 36, the cap
  switch (nc) {
#ifdef NVBT_EXTRA_BAND
    // a band past 32 * 36: its own cells per lane (ceil(W/32) rounded up to
    // whole half-words of nibbles), the band compiled in
    NVBT_CALL(NVBT_EXTRA_NC, NVBT_EXTRA_BAND)
#else
    NVBT_CALL(8, 230)
    NVBT_CALL(12, 286)
    NVBT_CALL(36, 1054)
#endif
    default:
      return -1;
  }
#undef NVBT_CALL
}

}  // extern "C"
