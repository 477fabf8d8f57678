// The dedup vote: an evidence-ranked tournament over the candidate loci of
// each row (nvbio_tpu_torch/align/kernels.py: vote_reps; its plain version
// vote_reps_plain beside it, which CPU tensors take).
//
// Replaces no TPU kernel: the JAX package votes with jnp ops
// (nvbio_tpu/bowtie/pipeline.py, dedup_half), and so did the port, ~15
// torch ops a round over (rows, n, n) int64 pair distances: ~133 launches
// a dedup call, ~43 a within-seed call, and a 3 x 10.9 GB peak at the
// reseed pass's (32768 x 18, 48, 48) within-seed vote of a q = 16 index.
// The mapper votes four to six times a batch (both strands of the first
// pass, the reseed pass's within-seed vote and its dedup), so the vote was
// the largest block of the batch's device time.
//
// The function, bit for bit the plain version's: positions of invalid
// candidates become INT64_MAX; a valid candidate's vote is the number of
// valid candidates within tol of it, itself included (distances as torch
// computes them, max - min in two's complement), an invalid one's -1.
// Each of n_reps rounds takes the largest vote m; m < 1 emits nothing
// (0, false). Otherwise sel is the least position among the candidates
// voting m, the members are the candidates with a vote >= 0 within tol of
// sel, the round emits the least member position (valid if below
// INT64_MAX; it may lie left of sel) and retires the members (vote -1).
// A vote never rises, so a row whose best vote fell below 1 emits nothing
// in any later round: the kernel leaves it there.
//
// Bound on an H100: the bytes in and out, 9 a candidate (int64 position,
// bool) and 9 a rep, at 3.35 TB/s (2^19 rows of 54: 0.29 GB, ~0.09 ms).
// The n^2 distances a row are lane instructions in registers, and rows
// with few valid candidates skip the rest. Design: one warp a row, so the
// loads of a row are coalesced and no (rows, n, n) temporary exists. Lane
// l holds columns l, l + 32, ... (NPL = ceil(n / 32) of them, a template
// argument up to kRegCols / 32) in registers; the votes broadcast each
// valid column with __shfl_sync (the ballot of valid columns skips the
// rest); a round is a warp max of the int32 votes (__reduce_max_sync) and
// two warp minima of int64 positions, each two 32-bit __reduce_min_sync on
// an order-preserving unsigned key. Rows of more than kRegCols columns
// keep their positions and votes in shared memory instead, one warp a
// block (12 bytes a column: at most 19360 columns in an H100's 227 KB);
// the wrapper refuses more. The per-row rounds played (optional output)
// feed the counter vote_rounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;
constexpr int kRowsPerBlock = 8;   // register route: a warp a row
constexpr int kRegCols = 256;      // columns a row keeps in registers
constexpr int64_t kBig = INT64_MAX;
constexpr uint64_t kSign = uint64_t(1) << 63;
constexpr uint64_t kNone = ~uint64_t(0);   // the key of kBig
static_assert(kRegCols == 8 * 32, "nvbt_vote_reps instantiates NPL 1..8");

// torch's max(a, b) - min(a, b) on int64: wraps in two's complement
__device__ __forceinline__ int64_t absdiff(int64_t a, int64_t b) {
  return a > b ? int64_t(uint64_t(a) - uint64_t(b))
               : int64_t(uint64_t(b) - uint64_t(a));
}

// an int64 as an unsigned key of the same order, and back
__device__ __forceinline__ uint64_t key_of(int64_t x) {
  return uint64_t(x) ^ kSign;
}
__device__ __forceinline__ int64_t pos_of(uint64_t k) {
  return int64_t(k ^ kSign);
}

__device__ __forceinline__ uint64_t min_key(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

// the least key over the warp, in every lane
__device__ __forceinline__ uint64_t warp_min(uint64_t k) {
  const unsigned hi = __reduce_min_sync(kAll, unsigned(k >> 32));
  const unsigned lo =
      __reduce_min_sync(kAll, unsigned(k >> 32) == hi ? unsigned(k) : ~0u);
  return (uint64_t(hi) << 32) | lo;
}

// A lane's columns of one row: lane + 32 k, k < NPL, in registers.
template <int NPL>
struct RegCols {
  int64_t p[NPL];
  int32_t v[NPL];
  __device__ static constexpr int count() { return NPL; }
  __device__ int64_t& pos(int k) { return p[k]; }
  __device__ int32_t& vote(int k) { return v[k]; }
  // column 32 k + src's position, from lane src
  __device__ int64_t column(int k, int src) const {
    return int64_t(__shfl_sync(kAll, (long long)p[k], src));
  }
};

// The same in shared memory (route for rows of more than kRegCols).
struct SmemCols {
  int64_t* p;   // npl * 32 positions
  int32_t* v;   // npl * 32 votes
  int npl, lane;
  __device__ int count() const { return npl; }
  __device__ int64_t& pos(int k) { return p[32 * k + lane]; }
  __device__ int32_t& vote(int k) { return v[32 * k + lane]; }
  __device__ int64_t column(int k, int src) const { return p[32 * k + src]; }
};

template <class Cols>
__device__ __forceinline__ void vote_row(
    Cols& c, const int64_t* __restrict__ pv, const bool* __restrict__ valid,
    int n, int64_t tol, int n_reps, int lane, int64_t* __restrict__ reps,
    bool* __restrict__ rep_valid, int32_t* __restrict__ rounds) {
  // positions (INT64_MAX where invalid) and votes: 0 where valid, else -1;
  // columns past n stay invalid
#pragma unroll
  for (int k = 0; k < c.count(); ++k) {
    const int col = 32 * k + lane;
    const bool ok = col < n && valid[col];
    c.pos(k) = ok ? pv[col] : kBig;
    c.vote(k) = ok ? 0 : -1;
  }
  __syncwarp();
  // each valid column j adds one to the votes of the valid columns within
  // tol of it (itself included)
#pragma unroll
  for (int k2 = 0; k2 < c.count(); ++k2) {
    unsigned vm = __ballot_sync(kAll, c.vote(k2) >= 0);
    while (vm) {
      const int src = __ffs(vm) - 1;
      vm &= vm - 1;
      const int64_t pj = c.column(k2, src);
#pragma unroll
      for (int k = 0; k < c.count(); ++k)
        if (c.vote(k) >= 0 && absdiff(c.pos(k), pj) <= tol) ++c.vote(k);
    }
  }
  int played = 0;
  for (; played < n_reps; ++played) {
    int m = -1;
#pragma unroll
    for (int k = 0; k < c.count(); ++k) m = max(m, c.vote(k));
    m = __reduce_max_sync(kAll, m);
    if (m < 1) break;   // this round and every later one emit nothing
    uint64_t ks = kNone;
#pragma unroll
    for (int k = 0; k < c.count(); ++k)
      if (c.vote(k) == m) ks = min_key(ks, key_of(c.pos(k)));
    const int64_t sel = pos_of(warp_min(ks));
    uint64_t kr = kNone;
#pragma unroll
    for (int k = 0; k < c.count(); ++k) {
      if (c.vote(k) >= 0 && absdiff(c.pos(k), sel) <= tol) {
        kr = min_key(kr, key_of(c.pos(k)));
        c.vote(k) = -1;
      }
    }
    const int64_t rep = pos_of(warp_min(kr));
    if (lane == 0) {
      reps[played] = rep < kBig ? rep : 0;
      rep_valid[played] = rep < kBig;
    }
  }
  for (int r = played + lane; r < n_reps; r += 32) {
    reps[r] = 0;
    rep_valid[r] = false;
  }
  if (rounds != nullptr && lane == 0) *rounds = played;
}

// NPL > 0: a row's columns in registers, kRowsPerBlock rows a block;
// NPL == 0: in dynamic shared memory (npl * 32 * 12 bytes), a row a block.
template <int NPL>
__global__ void __launch_bounds__(NPL ? 32 * kRowsPerBlock : 32)
vote_reps_kernel(const int64_t* __restrict__ pv,
                 const bool* __restrict__ valid, int64_t R, int n,
                 int64_t tol, int n_reps, int64_t* __restrict__ reps,
                 bool* __restrict__ rep_valid, int32_t* __restrict__ rounds) {
  const int lane = threadIdx.x & 31;
  const int64_t row = int64_t(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (row >= R) return;   // the whole warp
  int64_t* out = reps + row * n_reps;
  bool* out_v = rep_valid + row * n_reps;
  int32_t* r_out = rounds ? rounds + row : nullptr;
  if constexpr (NPL > 0) {
    RegCols<NPL> c;
    vote_row(c, pv + row * n, valid + row * n, n, tol, n_reps, lane, out,
             out_v, r_out);
  } else {
    extern __shared__ int64_t smem[];
    const int npl = (n + 31) / 32;
    SmemCols c{smem, reinterpret_cast<int32_t*>(smem + 32 * npl), npl,
               lane};
    vote_row(c, pv + row * n, valid + row * n, n, tol, n_reps, lane, out,
             out_v, r_out);
  }
}

template <int NPL>
cudaError_t launch(const int64_t* pv, const bool* valid, int64_t R, int n,
                   int64_t tol, int n_reps, int64_t* reps, bool* rep_valid,
                   int32_t* rounds, cudaStream_t stream) {
  const unsigned grid = unsigned((R + kRowsPerBlock - 1) / kRowsPerBlock);
  vote_reps_kernel<NPL><<<grid, 32 * kRowsPerBlock, 0, stream>>>(
      pv, valid, R, n, tol, n_reps, reps, rep_valid, rounds);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pv: (R, n) int64; valid: (R, n) bool; reps: (R, n_reps) int64;
// rep_valid: (R, n_reps) bool; rounds: (R,) int32 or null (the rounds each
// row played). n >= 1 with ceil(n / 32) * 32 * 12 bytes within the 227 KB
// a block may take (n <= 19360; the wrapper checks), n_reps >= 1, R below
// 2^31. Returns 0, or the cudaError_t of a failed launch.
int nvbt_vote_reps(const void* pv_, const void* valid_, int64_t R, int n,
                   int64_t tol, int n_reps, void* reps_, void* rep_valid_,
                   void* rounds_, void* stream_) {
  const auto* pv = static_cast<const int64_t*>(pv_);
  const auto* valid = static_cast<const bool*>(valid_);
  auto* reps = static_cast<int64_t*>(reps_);
  auto* rep_valid = static_cast<bool*>(rep_valid_);
  auto* rounds = static_cast<int32_t*>(rounds_);
  auto* stream = static_cast<cudaStream_t>(stream_);
  switch ((n + 31) / 32) {
#define NVBT_VOTE_CASE(NPL)                                                \
  case NPL:                                                               \
    return launch<NPL>(pv, valid, R, n, tol, n_reps, reps, rep_valid,     \
                       rounds, stream);
    NVBT_VOTE_CASE(1)
    NVBT_VOTE_CASE(2)
    NVBT_VOTE_CASE(3)
    NVBT_VOTE_CASE(4)
    NVBT_VOTE_CASE(5)
    NVBT_VOTE_CASE(6)
    NVBT_VOTE_CASE(7)
    NVBT_VOTE_CASE(8)
#undef NVBT_VOTE_CASE
    default:
      break;
  }
  const int npl = (n + 31) / 32;
  const size_t bytes = size_t(npl) * 32 * 12;
  cudaError_t err = cudaFuncSetAttribute(
      vote_reps_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return err;
  vote_reps_kernel<0><<<unsigned(R), 32, bytes, stream>>>(
      pv, valid, R, n, tol, n_reps, reps, rep_valid, rounds);
  return cudaGetLastError();
}

}  // extern "C"
