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
// tensor cores could use.  So the design reads each valid K and V row
// exactly once and reads nothing past kv_len: rows at or past it are
// neither loaded nor counted, and the loop ends at the last valid tile (the
// over-allocated rest of the cache costs no traffic).  The G query heads of
// one KV group share a block, as the TPU kernel's [G, d] tile does, so a KV
// row is read once per group and not once per query head.  With so little
// arithmetic, what limits one block is how many bytes it has in flight:
// each tile of 128 keys (64 KB of K and V in bf16 at d = 128) is fetched
// with 16-byte cp.async copies, all issued before the block waits once, so
// a tile costs about one trip to device memory.  The block's four warps
// then take 32 keys each: lane = key for Q.K (K rows padded by 16 bytes in
// shared memory, so 16-byte reads hit distinct banks), lanes on pairs of
// dims for P.V; the warps' partial softmaxes are merged at the end through
// shared memory.  Strides are taken per tensor, so the cache is read in the
// model's [B, L, Hkv, d] layout and never transposed or copied.  With B=4
// and Hkv=8 the grid has only 32 blocks; overlapping a tile's copy with the
// previous tile's arithmetic, and a split over keys across blocks, are for
// a later version.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = kWarps * 32;  // keys per tile, 32 per warp
constexpr int kMaxG = 8;             // query heads per KV head

template <typename T, int D>
struct Layout {
  static constexpr int kVec = rt::Vec16<T>::N;  // elements per 16 bytes
  static constexpr int kChunks = D / kVec;       // 16-byte chunks per row
  static constexpr int kRowK = D + kVec;         // padded K row, elements
  static constexpr int kPairs = D / 64;          // dim pairs per lane
  static constexpr size_t kQBytes = sizeof(float) * kMaxG * D;
  static constexpr size_t kKBytes = sizeof(T) * kTileK * kRowK;
  static constexpr size_t kVBytes = sizeof(T) * kTileK * D;
  static constexpr size_t kMergeBytes = sizeof(float) * kWarps * kMaxG * (D + 2);
  static constexpr size_t kSmem = kQBytes + (kKBytes + kVBytes > kMergeBytes
                                                 ? kKBytes + kVBytes
                                                 : kMergeBytes);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, const int* __restrict__ kv_len_ptr, int kv_len_val, int Hq,
              int Hkv, int Lk, long long sqb, long long sqh, long long skb, long long skh,
              long long skl, long long svb, long long svh, long long svl, long long sob,
              long long soh, float sm_scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);                  // [kMaxG][D], scaled
  T* Ks = reinterpret_cast<T*>(smem + L::kQBytes);             // [kTileK][kRowK]
  T* Vs = reinterpret_cast<T*>(smem + L::kQBytes + L::kKBytes);  // [kTileK][D]

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int kv_len = kv_len_ptr ? *kv_len_ptr : kv_len_val;
  kv_len = max(0, min(kv_len, Lk));

  const T* qb = q + b * sqb + hk * G * sqh;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, c = i - g * D;
    Qs[i] = rt::to_f32(qb[g * sqh + c]) * sm_scale;
  }

  float m[kMaxG], l[kMaxG], acc[kMaxG][2 * L::kPairs];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = rt::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * L::kPairs; ++c) acc[g][c] = 0.f;
  }

  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;

  for (int t0 = 0; t0 < kv_len; t0 += kTileK) {
    const int n = min(kTileK, kv_len - t0);  // valid keys in this tile
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = threadIdx.x; i < n * L::kChunks; i += kThreads) {
      const int j = i / L::kChunks, c = (i - j * L::kChunks) * L::kVec;
      rt::cp_async16(Ks + j * L::kRowK + c, kb + (t0 + j) * skl + c);
      rt::cp_async16(Vs + j * D + c, vb + (t0 + j) * svl + c);
    }
    rt::cp_async_wait_all();
    __syncthreads();

    const int jw = warp * 32;      // this warp's first key in the tile
    if (jw >= n) continue;         // warp-uniform: no valid key for this warp
    const bool live = jw + lane < n;

    // Q.K: lane = key.  Rows past n hold stale data and are masked below.
    float sc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) sc[g] = 0.f;
    const T* krow = Ks + (jw + lane) * L::kRowK;
#pragma unroll 4
    for (int c = 0; c < L::kChunks; ++c) {
      float kf[L::kVec];
      rt::Vec16<T>::unpack(*reinterpret_cast<const uint4*>(krow + c * L::kVec), kf);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float* qg = Qs + g * D + c * L::kVec;
#pragma unroll
        for (int e = 0; e < L::kVec; ++e) sc[g] = fmaf(qg[e], kf[e], sc[g]);
      }
    }

    float p[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      p[g] = 0.f;
      if (g >= G) continue;
      const float s = live ? sc[g] : rt::kNegInf;
      const float m_new = fmaxf(m[g], rt::warp_max(s));
      p[g] = live ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[g] - m_new);
      l[g] = l[g] * alpha + rt::warp_sum(p[g]);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < 2 * L::kPairs; ++c) acc[g][c] *= alpha;
    }

    // P.V: lane owns dims 2*(lane + 32c) and 2*(lane + 32c) + 1.
    const int nw = min(32, n - jw);
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

  // Merge the warps' partial softmaxes through the (now free) K/V tiles:
  // [kWarps][kMaxG] m and l, then [kWarps][kMaxG][D] accumulators.
  __syncthreads();
  float* Ms = reinterpret_cast<float*>(smem + L::kQBytes);
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
      float* a = As + (warp * kMaxG + g) * D + 2 * (lane + 32 * c);
      a[0] = acc[g][2 * c];
      a[1] = acc[g][2 * c + 1];
    }
  }
  __syncthreads();

  T* ob = o + b * sob + hk * G * soh;
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
        const float* a = As + (w * kMaxG + g) * D + 2 * (lane + 32 * c);
        out[2 * c] += a[0] * scale;
        out[2 * c + 1] += a[1] * scale;
      }
    }
    denom = fmaxf(denom, 1e-30f);
#pragma unroll
    for (int c = 0; c < L::kPairs; ++c) {
      T* dst = ob + g * soh + 2 * (lane + 32 * c);
      dst[0] = rt::from_f32<T>(out[2 * c] / denom);
      dst[1] = rt::from_f32<T>(out[2 * c + 1] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const int* kv_len_ptr,
           int kv_len_val, int B, int Hq, int Hkv, int Lk, long long sqb, long long sqh,
           long long skb, long long skh, long long skl, long long svb, long long svh,
           long long svl, long long sob, long long soh, cudaStream_t stream) {
  constexpr size_t bytes = Layout<T, D>::kSmem;
  static const cudaError_t attr = rt::allow_smem(decode_kernel<T, D>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const float sm_scale = 1.f / sqrtf(static_cast<float>(D));
  decode_kernel<T, D><<<dim3(Hkv, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), kv_len_ptr, kv_len_val, Hq, Hkv, Lk, sqb, sqh, skb, skh, skl, svb,
      svh, svl, sob, soh, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               const int* kv_len_ptr, int kv_len_val, int B, int Hq, int Hkv, int Lk,
               long long sqb, long long sqh, long long skb, long long skh, long long skl,
               long long svb, long long svh, long long svl, long long sob, long long soh,
               cudaStream_t s) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, o, kv_len_ptr, kv_len_val, B, Hq, Hkv, Lk, sqb, sqh, skb,
                           skh, skl, svb, svh, svl, sob, soh, s);
    case 128:
      return launch<T, 128>(q, k, v, o, kv_len_ptr, kv_len_val, B, Hq, Hkv, Lk, sqb, sqh, skb,
                            skh, skl, svb, svh, svl, sob, soh, s);
    case 192:
      return launch<T, 192>(q, k, v, o, kv_len_ptr, kv_len_val, B, Hq, Hkv, Lk, sqb, sqh, skb,
                            skh, skl, svb, svh, svl, sob, soh, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [B, Hq, d] with (b, h) strides; k/v: [B, Hkv, Lk, d] with (b, h, l)
// strides; o: [B, Hq, d] with (b, h) strides; unit stride along d
// everywhere.  k and v must be 16-byte aligned, rows and all (the wrapper
// checks).  kv_len comes from a device int32 scalar when kv_len_ptr is
// non-null, else from kv_len_val.  Returns a cudaError_t.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, void* o,
                                       const int* kv_len_ptr, int kv_len_val, int B, int Hq,
                                       int Hkv, int Lk, int d, long long sqb, long long sqh,
                                       long long skb, long long skh, long long skl,
                                       long long svb, long long svh, long long svl,
                                       long long sob, long long soh, int dtype, void* stream) {
  if (B <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxG || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kFloat32:
      return dispatch_d<float>(d, q, k, v, o, kv_len_ptr, kv_len_val, B, Hq, Hkv, Lk, sqb, sqh,
                               skb, skh, skl, svb, svh, svl, sob, soh, s);
    case rt::kBFloat16:
      return dispatch_d<__nv_bfloat16>(d, q, k, v, o, kv_len_ptr, kv_len_val, B, Hq, Hkv, Lk,
                                       sqb, sqh, skb, skh, skl, svb, svh, svl, sob, soh, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

RT_EXPORT_ERROR_STRING(decode_attention)
