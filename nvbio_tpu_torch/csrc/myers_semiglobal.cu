// Myers bit-parallel semi-global edit distance: pattern global, text local
// (free text prefix and suffix). Returns the least distance and the first
// 1-based text end at which it is reached.
//
// Replaces the TPU kernel `myers_semiglobal_pallas` / `_myers_kernel`
// (nvbio_tpu/align/pallas_kernels.py:1132 / :1047). Same function and the
// same recurrence, word for word (:1067-1118): Peq[c][w] holds bit i%32 of
// word i/32 where pattern[i] == c and i < plen (a read N, code 4, matches
// nothing); a text code outside 1..3 selects Peq[0] (:1071-1075); the
// multi-word add (Eq & PV) + PV carries word to word; Hp and Hn shift left
// by one with carry-in 0; the score moves by the Hp/Hn bits at bit
// (plen-1) mod 32 of word floor((plen-1)/32), in floor arithmetic, so
// plen = 0 reads bit 31 of word 0 as the TPU kernel does (:1063-1065,
// :1094-1101); best/bend update only when j < tlen and score < best
// strictly (the first minimum wins), bend = j + 1.
//
// What bounds it on an H100: integer instructions (about 15 per 32-bit
// word per text step, counted in chip_smoke.py); the bytes are one text
// symbol per step. Design: one pattern per thread, templated on the word
// count NW in {1, 2, 3, 4} (patterns of at most 128 bases) so Peq[4][NW],
// PV, MV and the score live in registers as uint32_t; the text length T is
// a runtime loop bound (`-X` changes it). The wrapper hands the patterns
// and texts over transposed, (M, B) and (T, B), so the 32 threads of a warp
// read one coalesced 128-byte row per pattern column and per text step;
// the transposing copy costs one extra read and write of the texts
// (2 x 70 MB at B=32768, T=531).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int NW>
__global__ void __launch_bounds__(128)
myers_semiglobal_kernel(const int32_t* __restrict__ pat_t,  // (M, B)
                        const int32_t* __restrict__ plens,  // (B,)
                        const int32_t* __restrict__ txt_t,  // (T, B)
                        const int32_t* __restrict__ tlens,  // (B,)
                        int B, int M, int T,
                        int32_t* __restrict__ dist,
                        int32_t* __restrict__ tend) {
  const int b = int(int64_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (b >= B) return;
  const int plen = plens[b];
  const int tlen = tlens[b];

  uint32_t peq[4][NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
#pragma unroll
    for (int c = 0; c < 4; ++c) peq[c][w] = 0u;
    for (int ii = 0; ii < 32; ++ii) {
      const int i = w * 32 + ii;
      if (i >= M) break;
      const int p = pat_t[int64_t(i) * B + b];
      const uint32_t bit = (i < plen) ? (1u << ii) : 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) peq[c][w] |= (p == c) ? bit : 0u;
    }
  }

  // floor division and modulus: plen = 0 gives word -1 (matched by no
  // word of the select chain, so word 0) and bit 31
  const int last = plen - 1;
  const int last_word = (last >= 0) ? last / 32 : -((31 - last) / 32);
  const int last_bit = last - 32 * last_word;

  uint32_t PV[NW], MV[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    PV[w] = 0xFFFFFFFFu;
    MV[w] = 0u;
  }
  int score = plen, best = plen, bend = 0;
  for (int j = 0; j < T; ++j) {
    const int tch = txt_t[int64_t(j) * B + b];
    uint32_t Eq[NW], D0[NW], Hp[NW], Hn[NW];
    uint32_t carry = 0u;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      uint32_t e = peq[0][w];
      e = (tch == 1) ? peq[1][w] : e;
      e = (tch == 2) ? peq[2][w] : e;
      e = (tch == 3) ? peq[3][w] : e;
      Eq[w] = e;
      const uint32_t a = e & PV[w];
      const uint32_t t = a + PV[w];
      const uint32_t c1 = t < a;
      const uint32_t s = t + carry;
      carry = (w == 0) ? c1 : (c1 | (s < t));
      D0[w] = (s ^ PV[w]) | e | MV[w];
      Hp[w] = MV[w] | ~(D0[w] | PV[w]);
      Hn[w] = PV[w] & D0[w];
    }
    uint32_t phl = Hp[0], mhl = Hn[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      phl = (last_word == w) ? Hp[w] : phl;
      mhl = (last_word == w) ? Hn[w] : mhl;
    }
    score += int((phl >> last_bit) & 1u) - int((mhl >> last_bit) & 1u);
    uint32_t cp = 0u, cn = 0u;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t hps = (Hp[w] << 1) | cp;
      const uint32_t hns = (Hn[w] << 1) | cn;
      cp = Hp[w] >> 31;
      cn = Hn[w] >> 31;
      PV[w] = hns | ~(D0[w] | hps);
      MV[w] = D0[w] & hps;
    }
    if (j < tlen && score < best) {
      best = score;
      bend = j + 1;
    }
  }
  dist[b] = best;
  tend[b] = bend;
}

template <int NW>
cudaError_t launch(const void* pat_t, const void* plens, const void* txt_t,
                   const void* tlens, int B, int M, int T, void* dist,
                   void* tend, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = unsigned((B + threads - 1) / threads);
  myers_semiglobal_kernel<NW><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(pat_t), static_cast<const int32_t*>(plens),
      static_cast<const int32_t*>(txt_t), static_cast<const int32_t*>(tlens),
      B, M, T, static_cast<int32_t*>(dist), static_cast<int32_t*>(tend));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for
// a pattern width without an instantiation (more than 4 words).
int nvbt_myers_semiglobal(const void* pat_t, const void* plens,
                          const void* txt_t, const void* tlens, int B, int M,
                          int T, void* dist, void* tend, void* stream) {
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch ((M + 31) / 32) {
    case 0:
    case 1:
      return int(launch<1>(pat_t, plens, txt_t, tlens, B, M, T, dist, tend, st));
    case 2:
      return int(launch<2>(pat_t, plens, txt_t, tlens, B, M, T, dist, tend, st));
    case 3:
      return int(launch<3>(pat_t, plens, txt_t, tlens, B, M, T, dist, tend, st));
    case 4:
      return int(launch<4>(pat_t, plens, txt_t, tlens, B, M, T, dist, tend, st));
    default:
      return -1;
  }
}

}  // extern "C"
