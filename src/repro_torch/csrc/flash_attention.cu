// Flash attention (prefill) for Hopper: online-softmax GQA attention over a
// KV cache, with fp32 scores, fp32 exp, fp32 probabilities and fp32
// accumulators; inputs and output in fp32 or bf16.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (Pallas, TPU),
// extended by a query offset so that a prefill at any cache length reaches it:
// query row t sits at absolute position q_offset + t.  With q_offset = 0 it
// computes what the TPU kernel computes:
//   s = (q / sqrt(d)) . k, optionally tanh-softcapped;
//   key s is live for row t iff s < kv_len, and (causal) s <= q_offset + t,
//   and (window > 0) q_offset + t - s < window;
//   o = softmax(s) v, with masked scores at -1e30 and the denominator
//   clamped at 1e-30.  Query head h reads KV head h / (Hq / Hkv).
// A row with no live key comes out 0 (the TPU kernel's result when every
// KV block of the row is skipped).  Probabilities stay fp32 for P.V, as in
// the TPU kernel, where the reference sdpa rounds them to v's dtype first.
//
// Bound on the H100: a causal prefill of Lq rows does about
// Hq * Lq / (2 * (Hq + Hkv)) operations for each byte of q, k, v and o it
// must move: 48 at the serving shape (Hq=24, Hkv=8, Lq=128), under the
// card's ~295 bf16 operations a byte, so there the bytes bound it; from
// prompts of about 800 tokens on, the operations on the tensor cores do.
// This first version uses no tensor cores: it is a SIMT kernel that keeps
// every intermediate (scores, probabilities) out of device memory, which
// is what the TPU kernel's design is for.  Each block owns 16 query rows of
// one head (4 warps x 4 rows); K and V are staged through shared memory 32
// keys at a time in fp32 and shared by the block's rows; lane j of a warp
// owns key j of the tile for Q.K (the K tile is padded to d+1 floats a row,
// so the 32 lanes hit 32 banks) and output dims lane + 32c for P.V.  Tiles
// past the block's last live key (causal, kv_len) or before its first
// (window) are skipped.  Strides are taken per tensor, so q/k/v/o are read
// in the model's [B, L, H, d] layout and the cache is never copied; only the
// ragged tail of Lq and kv_len is masked, no padding.  wgmma, TMA and a
// split over keys are for a later version.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kTileK = 32;

struct Strides {
  long long b, h, l;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * D + kTileK * (D + 1) + kTileK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, const int* __restrict__ q_offset_ptr, int q_offset_val,
             const int* __restrict__ kv_len_ptr, int kv_len_val, int Hq, int Hkv, int Lq,
             int Lk, Strides sq, Strides sk, Strides sv, Strides so, int causal, int window,
             float softcap, float sm_scale) {
  constexpr int DPL = D / 32;  // output dims per lane
  constexpr int KP = D + 1;    // padded K row
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBlockQ][D], pre-scaled by 1/sqrt(d)
  float* Ks = Qs + kBlockQ * D;      // [kTileK][KP]
  float* Vs = Ks + kTileK * KP;      // [kTileK][D]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * kBlockQ;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int q_off = q_offset_ptr ? *q_offset_ptr : q_offset_val;
  int kv_len = kv_len_ptr ? *kv_len_ptr : kv_len_val;
  kv_len = max(0, min(kv_len, Lk));

  const T* qb = q + b * sq.b + h * sq.h;
  for (int i = threadIdx.x; i < kBlockQ * D; i += kWarps * 32) {
    const int r = i / D, c = i - r * D;
    const int t = t0 + r;
    Qs[i] = t < Lq ? rt::to_f32(qb[t * sq.l + c]) * sm_scale : 0.f;
  }

  // Live key range of the whole block.
  const int t_last = min(t0 + kBlockQ, Lq) - 1;
  int k_end = kv_len;
  if (causal) k_end = min(k_end, q_off + t_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_off + t0 - window + 1);
  k_begin -= k_begin % kTileK;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = rt::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  const float* qw = Qs + warp * kRowsPerWarp * D;

  for (int ks = k_begin; ks < k_end; ks += kTileK) {
    __syncthreads();  // Q is staged / the previous tile is consumed
    for (int i = threadIdx.x; i < kTileK * D; i += kWarps * 32) {
      const int j = i / D, c = i - j * D;
      const int s = ks + j;
      const bool ok = s < k_end;  // rows past k_end are dead for every row here
      Ks[j * KP + c] = ok ? rt::to_f32(kb[s * sk.l + c]) : 0.f;
      Vs[j * D + c] = ok ? rt::to_f32(vb[s * sv.l + c]) : 0.f;
    }
    __syncthreads();

    float sc[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = 0.f;
    const float* krow = Ks + lane * KP;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float kv = krow[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = fmaf(qw[r * D + c], kv, sc[r]);
    }

    const int key = ks + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int t = t0 + warp * kRowsPerWarp + r;
      const int tabs = q_off + t;
      bool live = t < Lq && key < kv_len;
      if (causal) live = live && key <= tabs;
      if (window > 0) live = live && tabs - key < window;
      float s = sc[r];
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      s = live ? s : rt::kNegInf;
      const float m_new = fmaxf(m[r], rt::warp_max(s));
      p[r] = live ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + rt::warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < kTileK; ++j) {
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) vv[c] = Vs[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(rt::kFull, p[r], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int t = t0 + warp * kRowsPerWarp + r;
    if (t >= Lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) ob[t * so.l + lane + 32 * c] = rt::from_f32<T>(acc[r][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const int* q_offset_ptr,
           int q_offset_val, const int* kv_len_ptr, int kv_len_val, int B, int Hq, int Hkv,
           int Lq, int Lk, Strides sq, Strides sk, Strides sv, Strides so, int causal,
           int window, float softcap, float sm_scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static const cudaError_t attr = rt::allow_smem(flash_kernel<T, D>, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_kernel<T, D><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), q_offset_ptr, q_offset_val, kv_len_ptr, kv_len_val, Hq, Hkv, Lq, Lk,
      sq, sk, sv, so, causal, window, softcap, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               const int* q_offset_ptr, int q_offset_val, const int* kv_len_ptr, int kv_len_val,
               int B, int Hq, int Hkv, int Lq, int Lk, Strides sq, Strides sk, Strides sv,
               Strides so, int causal, int window, float softcap, float sm_scale,
               cudaStream_t s) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, o, q_offset_ptr, q_offset_val, kv_len_ptr, kv_len_val, B,
                           Hq, Hkv, Lq, Lk, sq, sk, sv, so, causal, window, softcap, sm_scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, q_offset_ptr, q_offset_val, kv_len_ptr, kv_len_val, B,
                            Hq, Hkv, Lq, Lk, sq, sk, sv, so, causal, window, softcap, sm_scale, s);
    case 192:
      return launch<T, 192>(q, k, v, o, q_offset_ptr, q_offset_val, kv_len_ptr, kv_len_val, B,
                            Hq, Hkv, Lq, Lk, sq, sk, sv, so, causal, window, softcap, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [B, Hq, Lq, d], k/v: [B, Hkv, Lk, d], o: [B, Hq, Lq, d], each given by
// its (b, h, l) element strides with unit stride along d.  q_offset and
// kv_len are read from device int32 scalars when the pointers are non-null,
// else taken from the *_val arguments.  Returns a cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, const int* q_offset_ptr,
    int q_offset_val, const int* kv_len_ptr, int kv_len_val, int B, int Hq, int Hkv, int Lq,
    int Lk, int d, long long sqb, long long sqh, long long sql, long long skb, long long skh,
    long long skl, long long svb, long long svh, long long svl, long long sob, long long soh,
    long long sol, int causal, int window, float softcap, int dtype, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{sqb, sqh, sql}, sk{skb, skh, skl}, sv{svb, svh, svl}, so{sob, soh, sol};
  const float sm_scale = 1.f / sqrtf(static_cast<float>(d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kFloat32:
      return dispatch_d<float>(d, q, k, v, o, q_offset_ptr, q_offset_val, kv_len_ptr,
                               kv_len_val, B, Hq, Hkv, Lq, Lk, sq, sk, sv, so, causal, window,
                               softcap, sm_scale, s);
    case rt::kBFloat16:
      return dispatch_d<__nv_bfloat16>(d, q, k, v, o, q_offset_ptr, q_offset_val, kv_len_ptr,
                                       kv_len_val, B, Hq, Hkv, Lq, Lk, sq, sk, sv, so, causal,
                                       window, softcap, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

RT_EXPORT_ERROR_STRING(flash_attention)
