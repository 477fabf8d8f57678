// Myers bit-parallel semi-global edit distance: pattern global, text local
// (free text prefix and suffix). Returns the least distance and the first
// 1-based text end at which it is reached.
//
// Replaces the TPU kernel `myers_semiglobal_pallas` / `_myers_kernel`
// (nvbio_tpu/align/pallas_kernels.py:1132 / :1047). Same function and the
// same recurrence, word for word (:1067-1118), for any pattern width M
// (NW = ceil(M/32) words) and any alphabet size NSYM: Peq[c][w] holds bit
// i%32 of word i/32 where pattern[i] == c and i < plen (a pattern code
// outside 0..NSYM-1, a read N, matches nothing); a text code outside
// 1..NSYM-1 selects Peq[0] (:1071-1075); the multi-word add (Eq & PV) + PV
// carries word to word; Hp and Hn shift left by one with carry-in 0; the
// score moves by the Hp/Hn bits at bit (plen-1) mod 32 of word
// floor((plen-1)/32), in floor arithmetic, so plen = 0 reads bit 31 of word
// 0 as the TPU kernel does, and a last word past the pattern's words reads
// word 0 too (:1063-1065, :1094-1101); best/bend update only when j < tlen
// and score < best strictly (the first minimum wins), bend = j + 1.
//
// Loop length: a pattern runs min(T, tlen) text steps. The TPU kernel runs
// all T, but a step j >= tlen changes neither best nor bend, and nothing
// after it is read, so the results are the same.
//
// Two entries, one kernel body each:
//   * nvbt_myers_semiglobal: texts (B, T) int32, read row-major in place
//     (no transposing copy): each thread packs the 2-bit codes of 16 steps
//     from 16 independent loads.
//   * nvbt_myers_semiglobal_windows: the text of read b is the T symbols of
//     the packed genome from starts[b] (`packed.extract_window`'s window,
//     0 past the genome's last word): the mate-locate step reads its 531-
//     base window straight from the genome. One word load per 16 steps,
//     issued 16 steps ahead (genome_stream.cuh, K1's fetch).
//
// What bounds it on an H100: integer instructions (about 15 per 32-bit word
// per text step and 9 per step, plus the fetch's shift and mask; counted in
// chip_smoke.py); the bytes are the patterns and a 16th of a word a step.
// The first design made one dependent global load per text step with about
// two warps per scheduler to hide it, and its wrapper transposed the
// patterns and texts on every call. This design:
//   * One read per thread for NW = 1..16 (M <= 512, the reference's read
//     cap) with DNA (NSYM = 4), templated on NW so Peq[4][NW], PV and MV
//     live in registers; the text arrives 16 steps at a time in one
//     register, so no step waits on memory.
//     A group of lanes per read (one word a lane, the add's carry resolved
//     by two ballots, the shift bits by a shuffle) was timed beside it on
//     an H100 and was 5x slower at 4 and 5 words, so it was dropped
//     (PERF.md).
//   * Any other width or alphabet takes one generic kernel with Peq, PV
//     and MV in a global scratch of the wrapper's ([row][read], so a warp's
//     loads coalesce). It is right, not fast.

#include <cstdint>
#include <cuda_runtime.h>

#include "genome_stream.cuh"

namespace {

constexpr int kMaxRegWords = 16;

// floor((plen-1)/32) and (plen-1) mod 32, as Python's // and %
__device__ __forceinline__ void last_pos(int plen, int& lw, int& lb) {
  const int last = plen - 1;
  lw = (last >= 0) ? last / 32 : -((31 - last) / 32);
  lb = last - 32 * lw;
}

// ---- text sources: 16 steps of 2-bit codes at a time ----------------------

// the contract form: a row of int32 codes; a code outside 1..3 reads as 0
struct RowText {
  const int32_t* __restrict__ row;
  int T;
  __device__ __forceinline__ uint32_t take16(int j) const {
    uint32_t bits = 0;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int x = j + u;
      const int c = x < T ? row[x] : 0;
      bits |= uint32_t(unsigned(c - 1) < 3u ? c : 0) << (2 * u);
    }
    return bits;
  }
  __device__ __forceinline__ int sym(int j) const { return row[j]; }
};

// the packed-window form
struct PackedText {
  const uint32_t* __restrict__ words;
  int64_t n_words, start;
  SymStream st;
  __device__ __forceinline__ void begin() { st = stream_at(words, n_words, start); }
  __device__ __forceinline__ uint32_t take16(int) {
    return stream_take<16>(st, words, n_words);
  }
  __device__ __forceinline__ int sym(int j) const {
    return genome_sym(words, n_words, start + j);
  }
};

// run n steps of `step(j, code)` from the 2-bit codes of `text`
template <class Text, class Step>
__device__ __forceinline__ void run_steps(Text& text, int n, Step& step) {
  int j = 0;
  for (; j + 16 <= n; j += 16) {
    const uint32_t bits = text.take16(j);
#pragma unroll
    for (int u = 0; u < 16; ++u) step(j + u, (bits >> (2 * u)) & 3u);
  }
  if (j < n) {
    const uint32_t bits = text.take16(j);
    for (int u = 0; j + u < n; ++u) step(j + u, (bits >> (2 * u)) & 3u);
  }
}

// ---- one read per thread, NW words in registers ---------------------------

template <int NW, class Text>
__device__ __forceinline__ void myers_regs(const int32_t* __restrict__ pat,
                                           int M, int plen, int n, Text& text,
                                           int& best, int& bend) {
  uint32_t peq[4][NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
#pragma unroll
    for (int c = 0; c < 4; ++c) peq[c][w] = 0u;
    for (int ii = 0; ii < 32; ++ii) {
      const int i = w * 32 + ii;
      if (i >= M) break;
      const int p = pat[i];
      const uint32_t bit = (i < plen) ? (1u << ii) : 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) peq[c][w] |= (p == c) ? bit : 0u;
    }
  }
  int lw, lb;
  last_pos(plen, lw, lb);
  uint32_t PV[NW], MV[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    PV[w] = 0xFFFFFFFFu;
    MV[w] = 0u;
  }
  int score = plen;
  best = plen;
  bend = 0;
  auto step = [&](int j, uint32_t tch) {
    uint32_t carry = 0u, cp = 0u, cn = 0u, phl = 0u, mhl = 0u;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint32_t e = peq[0][w];
      e = (tch == 1u) ? peq[1][w] : e;
      e = (tch == 2u) ? peq[2][w] : e;
      e = (tch == 3u) ? peq[3][w] : e;
      const uint32_t a = e & PV[w];
      const uint32_t t = a + PV[w];
      const uint32_t c1 = t < a;
      const uint32_t s = t + carry;
      carry = (w == 0) ? c1 : (c1 | (s < t));
      const uint32_t d0 = (s ^ PV[w]) | e | MV[w];
      const uint32_t hp = MV[w] | ~(d0 | PV[w]);
      const uint32_t hn = PV[w] & d0;
      if (w == 0 || lw == w) {
        phl = hp;
        mhl = hn;
      }
      const uint32_t hps = (hp << 1) | cp;
      const uint32_t hns = (hn << 1) | cn;
      cp = hp >> 31;
      cn = hn >> 31;
      PV[w] = hns | ~(d0 | hps);
      MV[w] = d0 & hps;
    }
    score += int((phl >> lb) & 1u) - int((mhl >> lb) & 1u);
    if (score < best) {
      best = score;
      bend = j + 1;
    }
  };
  run_steps(text, n, step);
}

template <int NW>
__global__ void __launch_bounds__(64)
myers_regs_kernel(const int32_t* __restrict__ pats,   // (B, M)
                  const int32_t* __restrict__ plens,  // (B,)
                  const int32_t* __restrict__ texts,  // (B, T)
                  const int32_t* __restrict__ tlens,  // (B,)
                  int B, int M, int T, int32_t* __restrict__ dist,
                  int32_t* __restrict__ tend) {
  const int b = int(int64_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (b >= B) return;
  RowText text{texts + int64_t(b) * T, T};
  int best, bend;
  myers_regs<NW>(pats + int64_t(b) * M, M, plens[b], min(T, tlens[b]), text,
                 best, bend);
  dist[b] = best;
  tend[b] = bend;
}

template <int NW>
__global__ void __launch_bounds__(64)
myers_regs_windows_kernel(const int32_t* __restrict__ pats,    // (B, M)
                          const int32_t* __restrict__ plens,   // (B,)
                          const uint32_t* __restrict__ words, int64_t n_words,
                          const int64_t* __restrict__ starts,  // (B,)
                          const int32_t* __restrict__ tlens,   // (B,)
                          int B, int M, int T, int32_t* __restrict__ dist,
                          int32_t* __restrict__ tend) {
  const int b = int(int64_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (b >= B) return;
  PackedText text{words, n_words, starts[b], {}};
  text.begin();
  int best, bend;
  myers_regs<NW>(pats + int64_t(b) * M, M, plens[b], min(T, tlens[b]), text,
                 best, bend);
  dist[b] = best;
  tend[b] = bend;
}

// ---- any width, any alphabet: state in a global scratch --------------------

// scratch: (NSYM*NW + 2*NW, B) words: Peq[c][w], then PV[w], then MV[w]
template <bool PACKED>
__global__ void __launch_bounds__(128)
myers_generic_kernel(const int32_t* __restrict__ pats,    // (B, M)
                     const int32_t* __restrict__ plens,   // (B,)
                     const int32_t* __restrict__ texts,   // (B, T) or null
                     const uint32_t* __restrict__ words, int64_t n_words,
                     const int64_t* __restrict__ starts,  // (B,) or null
                     const int32_t* __restrict__ tlens,   // (B,)
                     int B, int M, int T, int nsym,
                     uint32_t* __restrict__ scratch,
                     int32_t* __restrict__ dist, int32_t* __restrict__ tend) {
  const int b = int(int64_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (b >= B) return;
  const int NW = (M + 31) / 32;
  const int32_t* __restrict__ pat = pats + int64_t(b) * M;
  const int plen = plens[b];
  uint32_t* __restrict__ peq = scratch + b;
  uint32_t* __restrict__ pv = scratch + int64_t(nsym) * NW * B + b;
  uint32_t* __restrict__ mv = pv + int64_t(NW) * B;
  for (int w = 0; w < NW; ++w) {
    for (int c = 0; c < nsym; ++c) {
      uint32_t word = 0u;
      for (int ii = 0; ii < 32 && w * 32 + ii < M; ++ii) {
        const int i = w * 32 + ii;
        word |= (pat[i] == c && i < plen) ? (1u << ii) : 0u;
      }
      peq[(int64_t(c) * NW + w) * B] = word;
    }
    pv[int64_t(w) * B] = 0xFFFFFFFFu;
    mv[int64_t(w) * B] = 0u;
  }
  int lw, lb;
  last_pos(plen, lw, lb);
  PackedText ptext{words, n_words, PACKED ? starts[b] : 0, {}};
  const int32_t* __restrict__ row = PACKED ? nullptr : texts + int64_t(b) * T;
  const int n = min(T, tlens[b]);
  int score = plen, best = plen, bend = 0;
  for (int j = 0; j < n; ++j) {
    const int tch = PACKED ? ptext.sym(j) : row[j];
    const int sel = (tch >= 1 && tch < nsym) ? tch : 0;
    const uint32_t* __restrict__ eq = peq + int64_t(sel) * NW * B;
    uint32_t carry = 0u, cp = 0u, cn = 0u, phl = 0u, mhl = 0u;
    for (int w = 0; w < NW; ++w) {
      const uint32_t e = eq[int64_t(w) * B];
      const uint32_t P = pv[int64_t(w) * B];
      const uint32_t Mv = mv[int64_t(w) * B];
      const uint32_t a = e & P;
      const uint32_t t = a + P;
      const uint32_t c1 = t < a;
      const uint32_t s = t + carry;
      carry = (w == 0) ? c1 : (c1 | (s < t));
      const uint32_t d0 = (s ^ P) | e | Mv;
      const uint32_t hp = Mv | ~(d0 | P);
      const uint32_t hn = P & d0;
      if (w == 0 || lw == w) {
        phl = hp;
        mhl = hn;
      }
      const uint32_t hps = (hp << 1) | cp;
      const uint32_t hns = (hn << 1) | cn;
      cp = hp >> 31;
      cn = hn >> 31;
      pv[int64_t(w) * B] = hns | ~(d0 | hps);
      mv[int64_t(w) * B] = d0 & hps;
    }
    score += int((phl >> lb) & 1u) - int((mhl >> lb) & 1u);
    if (score < best) {
      best = score;
      bend = j + 1;
    }
  }
  dist[b] = best;
  tend[b] = bend;
}

// ---- dispatch ---------------------------------------------------------------

struct Args {
  const int32_t* pats;
  const int32_t* plens;
  const int32_t* texts;     // contract form, else null
  const uint32_t* words;    // packed-window form, else null
  int64_t n_words;
  const int64_t* starts;
  const int32_t* tlens;
  int B, M, T, nsym;
  uint32_t* scratch;
  int32_t* dist;
  int32_t* tend;
};

template <int NW>
cudaError_t launch_regs(const Args& a, cudaStream_t st) {
  const int threads = 64;
  const unsigned blocks = unsigned((a.B + threads - 1) / threads);
  if (a.texts)
    myers_regs_kernel<NW><<<blocks, threads, 0, st>>>(
        a.pats, a.plens, a.texts, a.tlens, a.B, a.M, a.T, a.dist, a.tend);
  else
    myers_regs_windows_kernel<NW><<<blocks, threads, 0, st>>>(
        a.pats, a.plens, a.words, a.n_words, a.starts, a.tlens, a.B, a.M,
        a.T, a.dist, a.tend);
  return cudaGetLastError();
}

cudaError_t launch_generic(const Args& a, cudaStream_t st) {
  const int threads = 128;
  const unsigned blocks = unsigned((a.B + threads - 1) / threads);
  if (a.texts)
    myers_generic_kernel<false><<<blocks, threads, 0, st>>>(
        a.pats, a.plens, a.texts, a.words, a.n_words, a.starts, a.tlens, a.B,
        a.M, a.T, a.nsym, a.scratch, a.dist, a.tend);
  else
    myers_generic_kernel<true><<<blocks, threads, 0, st>>>(
        a.pats, a.plens, a.texts, a.words, a.n_words, a.starts, a.tlens, a.B,
        a.M, a.T, a.nsym, a.scratch, a.dist, a.tend);
  return cudaGetLastError();
}

int dispatch(const Args& a, cudaStream_t st) {
  if (a.B == 0) return 0;
  const int NW = (a.M + 31) / 32 > 0 ? (a.M + 31) / 32 : 1;
  if (a.nsym != 4 || NW > kMaxRegWords) {
    if (!a.scratch) return -1;
    return int(launch_generic(a, st));
  }
  switch (NW) {
#define NVBT_NW(N) \
  case N:          \
    return int(launch_regs<N>(a, st));
    NVBT_NW(1) NVBT_NW(2) NVBT_NW(3) NVBT_NW(4) NVBT_NW(5) NVBT_NW(6)
    NVBT_NW(7) NVBT_NW(8) NVBT_NW(9) NVBT_NW(10) NVBT_NW(11) NVBT_NW(12)
    NVBT_NW(13) NVBT_NW(14) NVBT_NW(15) NVBT_NW(16)
#undef NVBT_NW
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// texts: (B, T) int32; scratch: (nsym*NW + 2*NW) * B words, used (and
// required) where nsym != 4 or M > 512. Returns 0 on success, a
// cudaError_t code after a failed launch, or -1 for arguments no kernel
// takes.
int nvbt_myers_semiglobal(const void* pats, const void* plens,
                          const void* texts, const void* tlens, int B, int M,
                          int T, int nsym, void* scratch, void* dist,
                          void* tend, void* stream) {
  const Args a{static_cast<const int32_t*>(pats),
               static_cast<const int32_t*>(plens),
               static_cast<const int32_t*>(texts), nullptr, 0, nullptr,
               static_cast<const int32_t*>(tlens), B, M, T, nsym,
               static_cast<uint32_t*>(scratch), static_cast<int32_t*>(dist),
               static_cast<int32_t*>(tend)};
  return dispatch(a, static_cast<cudaStream_t>(stream));
}

// The packed-window entry: the text of read b is the T symbols of the packed
// genome (words, n_words) from starts[b] (int64); DNA (nsym 4).
int nvbt_myers_semiglobal_windows(const void* pats, const void* plens,
                                  const void* words, int64_t n_words,
                                  const void* starts, const void* tlens,
                                  int B, int M, int T, void* scratch,
                                  void* dist, void* tend, void* stream) {
  const Args a{static_cast<const int32_t*>(pats),
               static_cast<const int32_t*>(plens), nullptr,
               static_cast<const uint32_t*>(words), n_words,
               static_cast<const int64_t*>(starts),
               static_cast<const int32_t*>(tlens), B, M, T, 4,
               static_cast<uint32_t*>(scratch), static_cast<int32_t*>(dist),
               static_cast<int32_t*>(tend)};
  return dispatch(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
