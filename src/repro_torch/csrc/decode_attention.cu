// Decode attention for Hopper: one new query row per sequence against an
// over-allocated KV cache, of which only the first kv_len rows are valid.
// fp32 scores, exp, probabilities and accumulators; inputs and output in
// fp32 or bf16.
//
// Replaces: src/repro/kernels/decode_attention.py::_decode_kernel (Pallas, TPU).
// It computes o = softmax((q / sqrt(d)) . k[:kv_len]) v[:kv_len] for every
// query head, query head h reading KV head h / G with G = Hq / Hkv; masked
// scores are -1e30 and the denominator is clamped at 1e-30, so kv_len = 0
// gives 0.  kv_len is read from a device int32 scalar, as Pallas
// scalar-prefetches it, so the host never waits on the device.
//
// Bound on the H100: bytes.  One decode step must stream the valid part of
// the cache once, 2 * kv_len * d values per KV head, for 4 * G * d * kv_len
// operations: about 3 operations a byte for G = 3, a hundredth of what the
// tensor cores could use, so the math stays on the CUDA cores in fp32 and
// the design is about keeping enough bytes in flight.  Each valid K and V
// row is read exactly once, and nothing at or past kv_len is read.  The G
// query heads of one KV group share a block, as the TPU kernel's [G, d]
// tile does, so a KV row is read once per group and not once per head.
//
// Split over the cache.  The TPU kernel walks the keys along a sequential
// grid axis ("split-K" in its words); here the splits run in parallel
// blocks: the grid is (splits, Hkv, B), and split s takes keys
// [s * chunk, (s + 1) * chunk).  The wrapper picks chunk from the cache's
// capacity Lk (kv_len is on the device and never read back): the multiple
// of 64 keys that gives about two blocks for each SM, so that one wave of
// blocks covers the cache (chunk 256, 256 blocks, for B 4 x Hkv 8 at
// Lk 2048; chunk 64, 96 blocks, at the serving cache of 160).  A block whose
// chunk starts at or past kv_len does no work and writes an empty partial
// (m = -1e30, l = 0).
//
// Inside a block, tiles of 64 keys go through a 3-stage cp.async ring (2 at
// fp32, d = 192, for shared memory): the copies of the next two tiles are in
// flight while this one is computed, and copies stay predicated on kv_len.
// Each of the four warps takes 16 keys of a tile: for Q.K two lanes a key,
// each over half of d (K rows padded by 16 bytes in shared memory, so a
// quarter-warp's 16-byte reads hit distinct banks), one shuffle to add the
// halves; for P.V lanes on pairs of dims.  The warps' partial softmaxes are
// merged at the end through shared memory, into the block's partial.
//
// Merge.  Every block writes its fp32 partial (m, l, acc[G, d]) to a scratch
// tensor the wrapper allocates, and the last block of a (b, KV head) to
// finish (a counter per (b, KV head), which that block resets to 0 for the
// next call) merges the splits with the rule the block uses between its
// warps: M = max m_s, o = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M),
// 1e-30), splits with l_s = 0 skipped, so kv_len = 0 gives 0.  With one
// split the counter reaches 1 at once and the same block merges.  One launch
// a call, no second kernel.  Two calls that share counters must not run at
// once: the wrapper keeps a set of counters for each stream.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 64;            // keys per tile, 16 per warp
constexpr int kKeysPerWarp = kTileK / kWarps;
constexpr int kMaxG = 8;              // query heads per KV head

template <typename T, int D>
struct Layout {
  static constexpr int kVec = rt::Vec16<T>::N;  // elements per 16 bytes
  static constexpr int kChunks = D / kVec;       // 16-byte chunks per row
  static constexpr int kHalf = kChunks / 2;      // per lane in Q.K (two lanes a key)
  static constexpr int kRowK = D + kVec;         // padded K row, elements
  static constexpr int kPairs = D / 64;          // dim pairs per lane in P.V
  static constexpr size_t kQBytes = sizeof(float) * kMaxG * D;
  static constexpr size_t kKBytes = sizeof(T) * kTileK * kRowK;
  static constexpr size_t kVBytes = sizeof(T) * kTileK * D;
  static constexpr size_t kStageBytes = kKBytes + kVBytes;
  static constexpr int kStages = kQBytes + 3 * kStageBytes <= 200 * 1024 ? 3 : 2;
  static constexpr size_t kMergeBytes = sizeof(float) * kWarps * kMaxG * (D + 2);
  static constexpr size_t kRing = kStages * kStageBytes;
  static constexpr size_t kSmem = kQBytes + (kRing > kMergeBytes ? kRing : kMergeBytes);
};

struct Args {
  const int* kv_len_ptr;
  int kv_len_val;
  int Hq, Hkv, Lk, chunk;
  long long sqb, sqh, skb, skh, skl, svb, svh, svl, sob, soh;
  float* part;    // [B, Hq, splits] (m, l) pairs, then [B, Hq, splits, D] accumulators
  int* counters;  // [B * Hkv], zero between calls
  float sm_scale;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, const Args a) {
  using L = Layout<T, D>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  float* Qs = reinterpret_cast<float*>(smem);  // [kMaxG][D], scaled
  unsigned char* ring = smem + L::kQBytes;     // [S] x (K [kTileK][kRowK], V [kTileK][D])

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int kv_len = a.kv_len_ptr ? *a.kv_len_ptr : a.kv_len_val;
  kv_len = max(0, min(kv_len, a.Lk));
  const int c0 = split * a.chunk;
  const int c1 = min(c0 + a.chunk, kv_len);
  const int ntiles = c1 > c0 ? (c1 - c0 + kTileK - 1) / kTileK : 0;

  const T* kb = k + b * a.skb + hk * a.skh;
  const T* vb = v + b * a.svb + hk * a.svh;
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      T* Ks = reinterpret_cast<T*>(ring + (i % S) * L::kStageBytes);
      T* Vs = reinterpret_cast<T*>(ring + (i % S) * L::kStageBytes + L::kKBytes);
      const int t0 = c0 + i * kTileK;
      const int n = min(kTileK, c1 - t0);  // valid keys: nothing at or past kv_len is read
      for (int x = threadIdx.x; x < n * L::kChunks; x += kThreads) {
        const int j = x / L::kChunks, c = (x - j * L::kChunks) * L::kVec;
        rt::cp_async16(Ks + j * L::kRowK + c, kb + (t0 + j) * a.skl + c);
        rt::cp_async16(Vs + j * D + c, vb + (t0 + j) * a.svl + c);
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) load_tile(i);

  const T* qb = q + b * a.sqb + hk * G * a.sqh;
  for (int x = threadIdx.x; x < G * D; x += kThreads) {
    const int g = x / D, c = x - g * D;
    Qs[x] = rt::to_f32(qb[g * a.sqh + c]) * a.sm_scale;
  }

  float m[kMaxG], l[kMaxG], acc[kMaxG][2 * L::kPairs];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = rt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * L::kPairs; ++c) acc[g][c] = 0.f;
  }

  const int kl = lane & 15;  // the lane's key in the warp's 16
  const int half = lane >> 4;  // the half of d it takes for Q.K
  for (int i = 0; i < ntiles; ++i) {
    load_tile(i + S - 1);  // into the stage tile i - 1 used; freed by the last barrier
    cp_async_wait<S - 1>();
    __syncthreads();  // tile i has landed for every thread (and Q is staged)

    const T* Ks = reinterpret_cast<const T*>(ring + (i % S) * L::kStageBytes);
    const T* Vs = reinterpret_cast<const T*>(ring + (i % S) * L::kStageBytes + L::kKBytes);
    const int n = min(kTileK, c1 - (c0 + i * kTileK));
    const int jw = warp * kKeysPerWarp;
    if (jw < n) {  // warp-uniform
      const bool live = jw + kl < n;
      // Q.K: two lanes a key, each over half of d.  Rows past n hold stale
      // data (never NaN-safe) and are masked below by a select.
      float sc[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) sc[g] = 0.f;
      const T* krow = Ks + (jw + kl) * L::kRowK + half * (D / 2);
#pragma unroll 4
      for (int c = 0; c < L::kHalf; ++c) {
        float kf[L::kVec];
        rt::Vec16<T>::unpack(*reinterpret_cast<const uint4*>(krow + c * L::kVec), kf);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g >= G) break;
          const float* qg = Qs + g * D + half * (D / 2) + c * L::kVec;
#pragma unroll
          for (int e = 0; e < L::kVec; ++e) sc[g] = fmaf(qg[e], kf[e], sc[g]);
        }
      }

      float p[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        p[g] = 0.f;
        if (g >= G) continue;
        sc[g] += __shfl_xor_sync(rt::kFull, sc[g], 16);
        const float s = live ? sc[g] : rt::kNegInf;
        const float m_new = fmaxf(m[g], rt::warp_max(s));
        p[g] = live ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[g] - m_new);
        l[g] = l[g] * alpha + rt::warp_sum(half == 0 ? p[g] : 0.f);  // each key once
        m[g] = m_new;
#pragma unroll
        for (int c = 0; c < 2 * L::kPairs; ++c) acc[g][c] *= alpha;
      }

      // P.V: lane owns dims 2*(lane + 32c) and 2*(lane + 32c) + 1; key jj's
      // probability sits in lane jj.
      const int nw = min(kKeysPerWarp, n - jw);
#pragma unroll 4
      for (int jj = 0; jj < nw; ++jj) {
        const T* vrow = Vs + (jw + jj) * D;
        float2 vv[L::kPairs];
#pragma unroll
        for (int c = 0; c < L::kPairs; ++c) vv[c] = rt::load_pair(vrow + 2 * (lane + 32 * c));
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g >= G) break;
          const float pj = __shfl_sync(rt::kFull, p[g], jj);
#pragma unroll
          for (int c = 0; c < L::kPairs; ++c) {
            acc[g][2 * c] = fmaf(pj, vv[c].x, acc[g][2 * c]);
            acc[g][2 * c + 1] = fmaf(pj, vv[c].y, acc[g][2 * c + 1]);
          }
        }
      }
    }
    __syncthreads();  // stage i % S is consumed before a later load_tile refills it
  }

  const int nq = a.Hq * splits;  // (m, l) pairs a sequence
  float2* ml = reinterpret_cast<float2*>(a.part);
  float* pacc = a.part + 2 * static_cast<size_t>(gridDim.z) * nq;
  // Partial row of head 0 of the group (head g: + g * splits).
  const size_t row0 = (static_cast<size_t>(b) * a.Hq + hk * G) * splits + split;

  if (ntiles > 0) {
    // Merge the warps' partial softmaxes through the (now free) ring:
    // [kWarps][kMaxG] m and l, then [kWarps][kMaxG][D] accumulators.
    cp_async_wait<0>();  // only empty groups are left
    float* Ms = reinterpret_cast<float*>(ring);
    float* Ls = Ms + kWarps * kMaxG;
    float* As = Ls + kWarps * kMaxG;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      if (lane == 0) {
        Ms[warp * kMaxG + g] = m[g];
        Ls[warp * kMaxG + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < L::kPairs; ++c) {
        float* x = As + (warp * kMaxG + g) * D + 2 * (lane + 32 * c);
        x[0] = acc[g][2 * c];
        x[1] = acc[g][2 * c + 1];
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float mx = rt::kNegInf;
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, Ms[w * kMaxG + g]);
      float denom = 0.f;
      float out[2 * L::kPairs];
#pragma unroll
      for (int c = 0; c < 2 * L::kPairs; ++c) out[c] = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float scale = expf(Ms[w * kMaxG + g] - mx);
        denom += Ls[w * kMaxG + g] * scale;
#pragma unroll
        for (int c = 0; c < L::kPairs; ++c) {
          const float* x = As + (w * kMaxG + g) * D + 2 * (lane + 32 * c);
          out[2 * c] += x[0] * scale;
          out[2 * c + 1] += x[1] * scale;
        }
      }
      const size_t row = row0 + static_cast<size_t>(g) * splits;
      if (lane == 0) ml[row] = make_float2(mx, denom);
      float* dst = pacc + row * D;
#pragma unroll
      for (int c = 0; c < L::kPairs; ++c)
        *reinterpret_cast<float2*>(dst + 2 * (lane + 32 * c)) =
            make_float2(out[2 * c], out[2 * c + 1]);
    }
  } else if (threadIdx.x < G) {  // an empty partial
    ml[row0 + static_cast<size_t>(threadIdx.x) * splits] = make_float2(rt::kNegInf, 0.f);
  }

  // The last block of this (b, KV head) to finish merges the splits.
  __threadfence();  // this block's partial is visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(&a.counters[b * a.Hkv + hk], 1);
    is_last = prev == splits - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  for (int g = warp; g < G; g += kWarps) {
    const size_t row = row0 - split + static_cast<size_t>(g) * splits;  // split 0 of head g
    float mx = rt::kNegInf;
    for (int s = 0; s < splits; ++s) {
      const float2 x = __ldcg(&ml[row + s]);
      if (x.y > 0.f) mx = fmaxf(mx, x.x);
    }
    float denom = 0.f;
    float out[2 * L::kPairs];
#pragma unroll
    for (int c = 0; c < 2 * L::kPairs; ++c) out[c] = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 x = __ldcg(&ml[row + s]);
      if (!(x.y > 0.f)) continue;  // an empty split: its accumulator was never written
      const float scale = expf(x.x - mx);
      denom += x.y * scale;
      const float* src = pacc + (row + s) * D;
#pragma unroll
      for (int c = 0; c < L::kPairs; ++c) {
        const float2 y = __ldcg(reinterpret_cast<const float2*>(src + 2 * (lane + 32 * c)));
        out[2 * c] += y.x * scale;
        out[2 * c + 1] += y.y * scale;
      }
    }
    denom = fmaxf(denom, 1e-30f);
    T* dst = o + b * a.sob + (hk * G + g) * a.soh;
#pragma unroll
    for (int c = 0; c < L::kPairs; ++c) {
      dst[2 * (lane + 32 * c)] = rt::from_f32<T>(out[2 * c] / denom);
      dst[2 * (lane + 32 * c) + 1] = rt::from_f32<T>(out[2 * c + 1] / denom);
    }
  }
  if (threadIdx.x == 0) a.counters[b * a.Hkv + hk] = 0;  // ready for the next call
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, const Args& a,
           cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, D>::kSmem;
  static const cudaError_t attr = rt::allow_smem(decode_split_kernel<T, D>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int splits = (a.Lk + a.chunk - 1) / a.chunk;
  decode_split_kernel<T, D><<<dim3(splits, a.Hkv, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o, int B,
               const Args& a, cudaStream_t s) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, a, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, a, s);
    case 192:
      return launch<T, 192>(q, k, v, o, B, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [B, Hq, d] with (b, h) strides; k/v: [B, Hkv, Lk, d] with (b, h, l)
// strides; o: [B, Hq, d] with (b, h) strides; unit stride along d
// everywhere.  k and v must be 16-byte aligned, rows and all (the wrapper
// checks).  kv_len comes from a device int32 scalar when kv_len_ptr is
// non-null, else from kv_len_val.  chunk (a multiple of 64) is the keys a
// block takes; with splits = ceil(Lk / chunk), part is scratch of at least
// B * Hq * splits * (d + 2) floats and counters B * Hkv ints, zero between
// calls and used by no call running at the same time.
// Returns a cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, void* o,
                                       const int* kv_len_ptr, int kv_len_val, int B, int Hq,
                                       int Hkv, int Lk, int d, long long sqb, long long sqh,
                                       long long skb, long long skh, long long skl,
                                       long long svb, long long svh, long long svl,
                                       long long sob, long long soh, int chunk, void* part,
                                       int* counters, int dtype, void* stream) {
  if (B <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || B > 65535 ||
      Hkv > 65535 || chunk <= 0 || chunk % kTileK != 0 || part == nullptr ||
      counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{kv_len_ptr, kv_len_val, Hq, Hkv, Lk, chunk, sqb, sqh, skb, skh, skl,
               svb, svh, svl, sob, soh, static_cast<float*>(part), counters,
               1.f / sqrtf(static_cast<float>(d))};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kFloat32:
      return dispatch_d<float>(d, q, k, v, o, B, a, s);
    case rt::kBFloat16:
      return dispatch_d<__nv_bfloat16>(d, q, k, v, o, B, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

RT_EXPORT_ERROR_STRING(decode_attention)
