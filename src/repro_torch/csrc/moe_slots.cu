// MoE slot assignment for Hopper: each routing choice's place in its
// expert's capacity buffer, and whether it fits.
//
// No TPU original: the JAX package leaves this to XLA (a one-hot, a cumsum
// along the choices and a gather in repro/models/moe.py::apply_moe).  The
// port's plain version, kernels/ref.py::moe_slots_ref, runs the same lines
// in PyTorch; on the card their cumsum is ATen's scan along dim 0 of a
// [T*k, E] one-hot, which gives the E columns to one block of E threads that
// walk every row in turn, at one dependent memory access a row: on the H100
// ~175 ns a choice while the one-hot fits in L2 (1.45 ms at 8192 choices),
// ~365 ns beyond it (281 ms at 768,000).
//
// The function.  The choices are the router's [T, k] expert ids read
// choice-major, choice i = t * k + j.  For each,
//   slot[i] = #{i' < i : e[i'] == e[i]},   keep[i] = slot[i] < C,
// the same integers as the plain version's one-hot cumsum.  An id outside
// [0, E) (which the router never makes) gets slot -1, keep false, and is
// counted for no expert.
//
// Bound on the H100: bytes.  An id is read (8 bytes), a slot and a keep
// written (8 + 1): 17 bytes a choice, 13.1 MB at 768,000 choices, 3.9 us at
// 3.35 TB/s; at decode's 192 choices the launch is the bound.  The work is a
// stable rank of small integers, a few instructions a choice, so the design
// spends no pass on a [T*k, E] intermediate and keeps the choices in flight:
//
// - A block takes a chunk of kChunk = 4096 consecutive choices, 16 a thread,
//   and starts all 16 loads of its ids before it uses any.  The chunk is
//   walked in tiles of 256 (one choice a thread, tile r holding choices
//   [r * 256, r * 256 + 256) of the chunk), in order.
// - Inside a warp, __match_any_sync on the id gives each choice the lanes of
//   its expert; its rank among them is __popc(peers & lanes below), and the
//   lowest of them writes __popc(peers) to cnt[warp][e].  Then thread e
//   scans cnt[.][e] over the 8 warps in order from the expert's running base
//   and writes each warp's first slot to off[warp][e]; a choice's slot is
//   off[warp][e] + rank.  Two barriers a tile; the writer of a count zeroes
//   it after the read, so only the entries a tile wrote are ever cleared.
// - More than one chunk: a count pass first (one block a chunk but the
//   last) writes each chunk's per-expert counts to [chunks - 1, E] int32
//   scratch from the wrapper, and each block of the rank pass starts each
//   expert's base from the sum of the chunks before its own (summed by
//   256 / E threads an expert).  So a call is 1 launch up to 4096 choices
//   and 2 above (kernels/moe_slots.py::plan), with no host sync and nothing
//   allocated here: it can be captured into a CUDA graph.
//
// Shared memory: 2 x 8 x 256 + 256 ints, 17 KB, static, for E <= 256.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;                  // choices a thread holds
constexpr int kChunk = kThreads * kPerThread;   // choices a block
constexpr int kMaxExperts = kThreads;           // one scanning thread an expert
constexpr int kMaxChoices = 1 << 30;

struct Args {
  const long long* experts;  // [T, k], row stride st, unit stride along k
  long long st;
  int k, n, E;
  long long cap;
  long long* slot;           // [n]
  bool* keep;                // [n]
  int* counts;               // [chunks - 1, E]: each chunk's choices of each expert
};

// This thread's ids of its block's chunk, every load started before any is
// used: -1 past the last choice and for an id outside [0, E).
__device__ __forceinline__ void load_ids(const Args& a, int (&ids)[kPerThread]) {
  const int first = blockIdx.x * kChunk + threadIdx.x;
  long long raw[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = first + r * kThreads;
    raw[r] = -1;
    if (i < a.n) {
      const int t = i / a.k;
      raw[r] = __ldg(a.experts + t * a.st + (i - t * a.k));
    }
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) ids[r] = (raw[r] >= 0 && raw[r] < a.E) ? static_cast<int>(raw[r]) : -1;
}

// The count pass: block c writes chunk c's choices of each expert.
__global__ void __launch_bounds__(kThreads) moe_count_kernel(Args a) {
  __shared__ int cnt[kMaxExperts];
  int ids[kPerThread];
  load_ids(a, ids);
  if (threadIdx.x < a.E) cnt[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const unsigned peers = __match_any_sync(rt::kFull, ids[r]);
    if (ids[r] >= 0 && lane == __ffs(peers) - 1) atomicAdd(&cnt[ids[r]], __popc(peers));
  }
  __syncthreads();
  if (threadIdx.x < a.E) a.counts[blockIdx.x * a.E + threadIdx.x] = cnt[threadIdx.x];
}

// The rank pass: block c gives every choice of chunk c its slot and keep.
__global__ void __launch_bounds__(kThreads) moe_rank_kernel(Args a) {
  __shared__ int cnt[kWarps][kMaxExperts];  // a tile's choices of each expert in each warp
  __shared__ int off[kWarps][kMaxExperts];  // the slot of each warp's first choice of each expert
  __shared__ int base[kMaxExperts];         // each expert's choices before the tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int ids[kPerThread];
  load_ids(a, ids);

  // The chunks before this one, each expert's counts summed by `parts`
  // threads (chunks p, p + parts, ...), their partial sums staged in off.
  int* partial = &off[0][0];
  const int parts = kThreads / a.E;
  if (tid < parts * a.E) {
    const int e = tid % a.E;
    int sum = 0;
#pragma unroll 8
    for (int c = tid / a.E; c < static_cast<int>(blockIdx.x); c += parts) sum += a.counts[c * a.E + e];
    partial[tid] = sum;
  }
#pragma unroll
  for (int w = 0; w < kWarps; ++w) cnt[w][tid] = 0;
  __syncthreads();
  if (tid < a.E) {
    int sum = 0;
    for (int p = 0; p < parts; ++p) sum += partial[p * a.E + tid];
    base[tid] = sum;
  }
  __syncthreads();

  const unsigned below = (1u << lane) - 1u;
  const int first = blockIdx.x * kChunk;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (first + r * kThreads >= a.n) break;  // the same for every thread of the block
    const int e = ids[r];
    const unsigned peers = __match_any_sync(rt::kFull, e);
    const int rank = __popc(peers & below);
    const bool leader = e >= 0 && rank == 0;
    if (leader) cnt[warp][e] = __popc(peers);
    __syncthreads();
    if (tid < a.E) {
      int run = base[tid];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        off[w][tid] = run;
        run += cnt[w][tid];
      }
      base[tid] = run;
    }
    __syncthreads();
    const int i = first + r * kThreads + tid;
    if (i < a.n) {
      const int s = e >= 0 ? off[warp][e] + rank : -1;
      a.slot[i] = s;
      a.keep[i] = e >= 0 && s < a.cap;
    }
    if (leader) cnt[warp][e] = 0;
    __syncwarp();  // the zeroing is seen by the lane that writes this entry next tile
  }
}

}  // namespace

// experts: [T, k] int64 with row stride st and unit stride along k, T * k =
// n choices; slot: [n] int64; keep: [n] bool; counts: scratch of at least
// (chunks - 1) * E int32 with chunks = ceil(n / 4096), or null for one
// chunk.  1 <= E <= 256, 1 <= n <= 2^30.  Returns a cudaError_t.
extern "C" int moe_slots_launch(const void* experts, long long st, int k, int n, int E, long long cap,
                                void* slot, void* keep, void* counts, void* stream) {
  if (k <= 0 || n <= 0 || n > kMaxChoices || n % k != 0 || E <= 0 || E > kMaxExperts)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n + kChunk - 1) / kChunk;
  if (chunks > 1 && counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const long long*>(experts), st, k, n, E, cap,
               static_cast<long long*>(slot), static_cast<bool*>(keep), static_cast<int*>(counts)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks > 1) {
    moe_count_kernel<<<chunks - 1, kThreads, 0, s>>>(a);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  moe_rank_kernel<<<chunks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

RT_EXPORT_ERROR_STRING(moe_slots)
