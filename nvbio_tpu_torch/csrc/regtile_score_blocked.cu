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
// row; none when plen is 0 or over L: (NEG_INF, 0)); first-max kbest.
// FULL_TEXT drops the text-length mask and reads the padded text as it is.
// The TPU's `unroll` and `t_regs` schedule its VLIW bundles and change no
// result; they have no counterpart here.
//
// What bounds it on an H100: bytes. The function reads L rows of patterns
// and penalties and L+W-1 of texts, int32, per alignment, and writes two
// int32 (the length planes only where the flags ask for them): 1328 B at
// W = 31 with the GCUPS leg's flags, 5.57 GB at its shape (G = 4096, L =
// 100), 1.66 ms at 3.35 TB/s, against 1.56 ms for its cells at two per
// instruction (chip_smoke.py).
// The first design (one alignment per thread, int32 arithmetic, one row a
// trip) lost on both sides: ~14 instructions a cell, W-1 register moves a
// row to slide the text window, and each row's three loads issued in the
// row that consumed them, with nothing in flight while a row computed.
// This design:
//   * Each thread scores the alignments 2j and 2j+1 of a block row in the
//     16-bit halves of 32-bit registers with the DPX u16x2 add-max (two
//     cells an instruction), values biased by 2^15, NEG_INF replaced by
//     NEG16 = -2^14, as K1's packed loop (banded_score_cands.cu). One 8-byte
//     load a plane a row fetches the pair; a warp reads 256 contiguous bytes
//     of each plane a row.
//   * The substitution score of both cells is one PRMT over two per-row byte
//     tables, one a half (byte c: match where c is the half's pattern code,
//     else its penalty), selected by the text pair (the window holds PRMT
//     selectors, made once per text row). Exact for text codes in [0, 4);
//     any pattern code works.
//   * The guard (align/kernels.py `k5_packed_pairs`): both halves have a FIN
//     row and a text that spans it (FULL_TEXT, or tlen >= rows + W - 1);
//     over the rows run, the sum of max(|mm_lo|, |mm_hi|, |match|) is within
//     `k1_packed_limit` (passed in as `lim`, -1 = never) and each term
//     within int8; every text code read lies in [0, 4). Penalties and codes
//     are folded in as they load; a pair that fails is rescored by the
//     int32 loop (the first design, length mask included) in the same
//     thread, as K1 keeps its own.
//   * Halves of different lengths run to the longer one; the shorter half's
//     FIN is reduced once, at its own row.
//   * The row loop is unrolled by kU rows, so the text window moves by
//     (W-1)/kU register copies a row, and each trip issues the next trip's
//     loads (pattern, penalty and text rows, kU each) before it computes its
//     own: 3 KB a warp in flight behind every trip (register double buffer).
//     A ring of 3 trips in shared memory filled by cp.async was no faster at
//     W = 31 and 5% slower at W = 17 on an H100 (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNegInf = -(1 << 24);
constexpr int kU = 4;                      // rows per trip of the packed loop
constexpr int kThreads = 128;
constexpr int kPlane = 1024;               // alignments of a block row
constexpr int kRow = kPlane / 2;           // pairs (int2) of a block row
constexpr uint32_t kBias2 = 0x80008000u;   // 0 in both biased halves
constexpr uint32_t kNeg2 = 0x40004000u;    // NEG16 = -2^14 in both halves

// blocks of kThreads an SM holds at W: registers at most 65536 / (128 n)
constexpr int min_blocks(int W) {
  return W <= 17 ? 4 : W <= 31 ? 3 : 2;
}

struct Scoring {
  int match, po, pe, to, te;
};

// ---------------------------------------------------------------------------
// int32: one alignment, the length mask, one row a trip
// ---------------------------------------------------------------------------

template <int W, bool SEQ_F, bool FULL_TEXT>
__device__ __forceinline__ void score32(const int32_t* __restrict__ pat,
                                        const int32_t* __restrict__ mm,
                                        const int32_t* __restrict__ txt,
                                        int rows, int tlen,
                                        const Scoring& s, int& smax,
                                        int& kb) {
  int H[W], E[W], T[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    H[k] = 0;
    E[k] = kNegInf;
    T[k] = txt[int64_t(k) * kPlane];
  }
  for (int im1 = 0; im1 < rows; ++im1) {
    const int p = pat[int64_t(im1) * kPlane];
    const int mmv = mm[int64_t(im1) * kPlane];
    int H0[W], Er[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      int sub = (p == T[k]) ? s.match : mmv;
      if (!FULL_TEXT) sub = (im1 + k < tlen) ? sub : kNegInf;
      const int diag = H[k] + sub;
      Er[k] = (k + 1 < W) ? max(E[k + 1] + s.pe, H[k + 1] + s.po)
                          : min(E[k], kNegInf);
      H0[k] = max(diag, Er[k]);
    }
    int F[W];
    if (SEQ_F) {
      F[0] = min(H0[0], kNegInf);
#pragma unroll
      for (int k = 1; k < W; ++k)
        F[k] = max(F[k - 1] + s.te, H0[k - 1] + s.to);
    } else {
      // lazy F: prefix max of G[k] = H0[k] + to - te*k across the band
      int gm = H0[0] + s.to;
      F[0] = min(gm, kNegInf);
#pragma unroll
      for (int k = 1; k < W; ++k) {
        F[k] = gm + s.te * (k - 1);
        gm = max(gm, H0[k] + s.to - s.te * k);
      }
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
      H[k] = max(H0[k], F[k]);
      E[k] = Er[k];
    }
#pragma unroll
    for (int k = 0; k + 1 < W; ++k) T[k] = T[k + 1];
    if (im1 + 1 < rows) T[W - 1] = txt[int64_t(im1 + W) * kPlane];
  }
  // FIN: the last row scored; NEG_INF without a FIN row (rows = 0)
  const bool has_fin = rows > 0;
  smax = has_fin ? H[0] : kNegInf;
#pragma unroll
  for (int k = 1; k < W; ++k) smax = max(smax, has_fin ? H[k] : kNegInf);
  kb = W;
#pragma unroll
  for (int k = W - 1; k >= 0; --k)
    kb = ((has_fin ? H[k] : kNegInf) == smax) ? k : kb;
}

// ---------------------------------------------------------------------------
// packed: the pair (2j, 2j+1) in the 16-bit halves
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// PRMT selector of the text pair (t_lo, t_hi), codes in [0, 4): the low half
// is byte t_lo of the first operand (the low half's table) sign-extended,
// the high half byte 4 + t_hi (the second operand, the high half's table)
__device__ __forceinline__ uint32_t text_sel(int2 t) {
  return uint32_t(t.x) * 0x11u + uint32_t(t.y) * 0x1100u + 0xC480u;
}

// a half's byte table of one row: byte c is match where c is its pattern
// code, else its penalty (a code outside [0, 4) matches no text)
__device__ __forceinline__ uint32_t sub_table(int p, int mmv,
                                              uint32_t match4) {
  const uint32_t mm4 = (uint32_t(mmv) & 0xffu) * 0x01010101u;
  const uint32_t put = (unsigned(p) < 4u) ? (0xffu << (8 * p)) : 0u;
  return (mm4 & ~put) | (match4 & put);
}

__device__ __forceinline__ uint32_t uabs(int x) {
  return x < 0 ? 0u - uint32_t(x) : uint32_t(x);
}

__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  return __viaddmax_u16x2(a, 0u, b);
}

// the first-max band index and score of one half (shift 0 or 16)
template <int W>
__device__ __forceinline__ void reduce_half(const uint32_t (&H)[W], int sh,
                                            int& smax, int& kb) {
  int m = -65536;
  kb = W;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int v = int((H[k] >> sh) & 0xffffu) - 0x8000;
    if (v > m) {
      m = v;
      kb = k;
    }
  }
  smax = m;
}

struct Consts {
  uint32_t po_w, to_w, pe_h, te_h;
};

template <int W, bool SEQ_F, int NT>
__device__ __forceinline__ void row16(uint32_t (&H)[W], uint32_t (&E)[W],
                                      const uint32_t (&T)[NT], int u,
                                      uint32_t tlo, uint32_t thi,
                                      const Consts& c, const Scoring& s) {
  uint32_t fprev = 0, hprev = 0, g = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint32_t sub = prmt(tlo, thi, T[u + k]);
    const uint32_t er =
        (k + 1 < W) ? __viaddmax_u16x2(E[k + 1], c.pe_h, H[k + 1] + c.po_w)
                    : kNeg2;
    const uint32_t h0 = __viaddmax_u16x2(H[k], sub, er);
    uint32_t f;
    if (SEQ_F) {
      f = (k == 0) ? kNeg2 : __viaddmax_u16x2(fprev, c.te_h, hprev + c.to_w);
      fprev = f;
      hprev = h0;
    } else if (k == 0) {
      g = h0 + c.to_w;
      f = kNeg2;
    } else {
      f = g + uint32_t(s.te * (k - 1)) * 0x10001u;
      g = __viaddmax_u16x2(h0, (uint32_t(s.to - s.te * k) & 0xffffu) * 0x10001u,
                           g);
    }
    H[k] = max2(h0, f);
    E[k] = er;
  }
}

// The rows of one trip that start at r0 into registers: pattern and penalty
// row r0+u, text position r0+u+W-1, for r0+u < rows.
template <int W>
__device__ __forceinline__ void fetch(const int2* __restrict__ pat,
                                      const int2* __restrict__ mm,
                                      const int2* __restrict__ txt, int r0,
                                      int rows, int2 (&rp)[kU],
                                      int2 (&rm)[kU], int2 (&rt)[kU]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int r = r0 + u;
    if (r < rows) {
      const int64_t o = int64_t(r) * kRow;
      rp[u] = __ldg(pat + o);
      rm[u] = __ldg(mm + o);
      rt[u] = __ldg(txt + int64_t(r + W - 1) * kRow);
    }
  }
}

// Scores the pair to `rows` rows (the longer half's); with cap > 0 the
// shorter half (the high one if cap_hi) takes its FIN after cap rows.
// Returns false when the guard refuses the pair (the halves may then have
// wrapped; the caller rescores both in int32).
template <int W, bool SEQ_F, bool UNIFORM_PLEN>
__device__ __forceinline__ bool score_pair16(
    const int2* __restrict__ pat, const int2* __restrict__ mm,
    const int2* __restrict__ txt, int rows, int cap, bool cap_hi,
    const Scoring& s, int lim, int& s0, int& k0, int& s1, int& k1) {
  constexpr int NT = W + kU - 1;
  uint32_t H[W], E[W], T[NT];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    H[k] = kBias2;
    E[k] = kNeg2;
  }
  // text positions 0..W-2; each trip shifts the window by kU and appends
  // its own rows' positions
  uint32_t tor = 0;
#pragma unroll
  for (int j = 0; j + 1 < W; ++j) {
    const int2 v = __ldg(txt + int64_t(j) * kRow);
    tor |= uint32_t(v.x) | uint32_t(v.y);
    T[kU + j] = text_sel(v);
  }
  const Consts c{uint32_t(s.po) * 0x10001u, uint32_t(s.to) * 0x10001u,
                 (uint32_t(s.pe) & 0xffffu) * 0x10001u,
                 (uint32_t(s.te) & 0xffffu) * 0x10001u};
  const uint32_t match4 = (uint32_t(s.match) & 0xffu) * 0x01010101u;
  const uint32_t amatch = uabs(s.match);
  uint32_t sum = 0, big = amatch;
  int cs = 0, ck = 0;
  int2 rp[kU], rm[kU], rt[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) rp[u] = rm[u] = rt[u] = make_int2(0, 0);
  fetch<W>(pat, mm, txt, 0, rows, rp, rm, rt);
  for (int r0 = 0; r0 < rows; r0 += kU) {
#pragma unroll
    for (int j = 0; j + 1 < W; ++j) T[j] = T[j + kU];
    uint32_t tlo[kU], thi[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      T[W - 1 + u] = text_sel(rt[u]);
      tlo[u] = sub_table(rp[u].x, rm[u].x, match4);
      thi[u] = sub_table(rp[u].y, rm[u].y, match4);
      if (r0 + u < rows) {
        tor |= uint32_t(rt[u].x) | uint32_t(rt[u].y);
        const uint32_t m = max(max(uabs(rm[u].x), uabs(rm[u].y)), amatch);
        sum += m;
        big = max(big, m);
      }
    }
    // the next trip's loads fly while this one computes
    fetch<W>(pat, mm, txt, r0 + kU, rows, rp, rm, rt);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (r0 + u < rows) {
        row16<W, SEQ_F>(H, E, T, u, tlo[u], thi[u], c, s);
        if constexpr (!UNIFORM_PLEN) {
          if (r0 + u + 1 == cap) reduce_half<W>(H, cap_hi ? 16 : 0, cs, ck);
        }
      }
    }
  }
  if (sum > uint32_t(lim) || big > 127u || (tor & ~3u) != 0u) return false;
  reduce_half<W>(H, 0, s0, k0);
  reduce_half<W>(H, 16, s1, k1);
  if constexpr (!UNIFORM_PLEN) {
    if (cap > 0) {
      if (cap_hi) {
        s1 = cs;
        k1 = ck;
      } else {
        s0 = cs;
        k0 = ck;
      }
    }
  }
  return true;
}

// ---------------------------------------------------------------------------

template <int W, bool SEQ_F, bool FULL_TEXT, bool UNIFORM_PLEN>
__global__ void __launch_bounds__(kThreads, min_blocks(W))
regtile_score_blocked_kernel(const int32_t* __restrict__ pats,   // (G,Lp,1024)
                             const int32_t* __restrict__ plens,  // (G,1,1024)
                             const int32_t* __restrict__ txts,   // (G,TWp,1024)
                             const int32_t* __restrict__ tlens,  // (G,1,1024)
                             const int32_t* __restrict__ mms,    // (G,Lp,1024)
                             int Lp, int TWp, int L, Scoring s, int lim,
                             int32_t* __restrict__ score,        // (G,1,1024)
                             int32_t* __restrict__ kbest,        // (G,1,1024)
                             unsigned* __restrict__ count) {
  // one pair a thread; the grid holds exactly G * 512 pairs
  const int64_t t = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t g = t / kRow;
  const int64_t a = (t % kRow) * 2;     // the pair's first alignment
  const int64_t base = g * kPlane + a;
  const int2 pl = UNIFORM_PLEN
                      ? make_int2(L, L)
                      : *reinterpret_cast<const int2*>(plens + base);
  const int2 tl = FULL_TEXT ? make_int2(0, 0)
                            : *reinterpret_cast<const int2*>(tlens + base);
  const bool fin0 = UNIFORM_PLEN || (pl.x >= 1 && pl.x <= L);
  const bool fin1 = UNIFORM_PLEN || (pl.y >= 1 && pl.y <= L);
  const int rows0 = fin0 ? pl.x : 0;
  const int rows1 = fin1 ? pl.y : 0;
  const bool span =
      FULL_TEXT || (tl.x >= rows0 + W - 1 && tl.y >= rows1 + W - 1);
  const int32_t* pat = pats + g * Lp * kPlane + a;
  const int32_t* mm = mms + g * Lp * kPlane + a;
  const int32_t* txt = txts + g * TWp * kPlane + a;
  int s0, k0, s1, k1;
  const bool packed =
      lim >= 0 && fin0 && fin1 && span &&
      score_pair16<W, SEQ_F, UNIFORM_PLEN>(
          reinterpret_cast<const int2*>(pat), reinterpret_cast<const int2*>(mm),
          reinterpret_cast<const int2*>(txt), max(rows0, rows1),
          rows0 == rows1 ? 0 : min(rows0, rows1), rows1 < rows0, s, lim, s0,
          k0, s1, k1);
  if (!packed) {
    score32<W, SEQ_F, FULL_TEXT>(pat, mm, txt, rows0, tl.x, s, s0, k0);
    score32<W, SEQ_F, FULL_TEXT>(pat + 1, mm + 1, txt + 1, rows1, tl.y, s, s1,
                                 k1);
  }
  *reinterpret_cast<int2*>(score + base) = make_int2(s0, s1);
  *reinterpret_cast<int2*>(kbest + base) = make_int2(k0, k1);
  if (count != nullptr) {
    const unsigned b = __ballot_sync(0xffffffffu, packed);
    if ((threadIdx.x & 31) == 0) atomicAdd(count, unsigned(__popc(b)));
  }
}

template <int W, bool SEQ_F, bool FULL_TEXT, bool UNIFORM_PLEN>
cudaError_t launch4(const void* pats, const void* plens, const void* txts,
                    const void* tlens, const void* mms, int G, int Lp,
                    int TWp, int L, const Scoring& s, int lim, void* score,
                    void* kbest, void* count, cudaStream_t stream) {
  const unsigned blocks = unsigned(int64_t(G) * kRow / kThreads);
  regtile_score_blocked_kernel<W, SEQ_F, FULL_TEXT, UNIFORM_PLEN>
      <<<blocks, kThreads, 0, stream>>>(
          static_cast<const int32_t*>(pats),
          static_cast<const int32_t*>(plens),
          static_cast<const int32_t*>(txts),
          static_cast<const int32_t*>(tlens),
          static_cast<const int32_t*>(mms), Lp, TWp, L, s, lim,
          static_cast<int32_t*>(score), static_cast<int32_t*>(kbest),
          static_cast<unsigned*>(count));
  return cudaGetLastError();
}

template <int W>
cudaError_t launch(int flags, const void* pats, const void* plens,
                   const void* txts, const void* tlens, const void* mms,
                   int G, int Lp, int TWp, int L, const Scoring& s, int lim,
                   void* score, void* kbest, void* count,
                   cudaStream_t stream) {
#define NVBT_FLAGS(S, F, U)                                               \
  case (S) | ((F) << 1) | ((U) << 2):                                     \
    return launch4<W, bool(S), bool(F), bool(U)>(                         \
        pats, plens, txts, tlens, mms, G, Lp, TWp, L, s, lim, score, kbest, \
        count, stream);
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

// flags: bit 0 seq_f, bit 1 full_text, bit 2 uniform_plen. lim: the packed
// loop's guard (`k1_packed_limit`), -1 to score every alignment in int32.
// count: null, or a counter to which the launch adds the pairs its packed
// loop kept. Returns 0 on success, a cudaError_t code after a failed
// launch, or -1 for a band width without an instantiation. The library
// holds the bands 7, 9, 11, 17 and 31, or with -DNVBT_EXTRA_BAND=W that
// band alone (align/kernels.py builds one at the first use of a band
// outside the five).
int nvbt_regtile_score_blocked(const void* pats, const void* plens,
                               const void* txts, const void* tlens,
                               const void* mms, int G, int Lp, int TWp, int L,
                               int W, int flags, int match, int po, int pe,
                               int to, int te, int lim, void* score,
                               void* kbest, void* count, void* stream) {
  if (G == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const Scoring s{match, po, pe, to, te};
#define NVBT_CALL(WW)                                                       \
  case WW:                                                                  \
    return int(launch<WW>(flags, pats, plens, txts, tlens, mms, G, Lp, TWp, \
                          L, s, lim, score, kbest, count, st));
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
