// Absorbed MLA decode for Hopper: one decode row per sequence and head
// against a latent cache, of which only the first kv_len rows are valid.
// bf16 inputs and output, bf16 products on the tensor cores (mma.sync
// m16n8k16), fp32 scores, softmax and accumulators.
//
// No TPU original: the JAX package has no MLA.  It computes, for every head
// h < H <= 16 of sequence b,
//   o_lat[b, h] = softmax(scale * (q_lat[b, h] . c_kv[b, :kv_len]
//                                  + q_pe[b, h] . k_pe[b, :kv_len])) . c_kv[b, :kv_len]
// with masked scores at -1e30 and the denominator clamped at 1e-30, so
// kv_len = 0 gives 0.  kv_len is read from a device int32 scalar, so a
// replayed CUDA graph is right at every length.
//
// Bound on the H100: bytes.  A key row is a cache row, [c_kv (512), k_pe
// (64)], 1152 bytes in bf16, shared by the 16 query heads, and its first 512
// are also the value: 2 * 16 * (576 + 512) = 34,816 FLOPs a row, 30 a byte,
// against the card's ~295 at the bf16 tensor-core peak, so the design keeps
// the bytes in flight and reads each valid row exactly once, for all heads.
// On the CUDA cores in fp32 the same FLOPs would take 1.5 times the memory
// time (67 TFLOP/s); on the tensor cores the heads are the M of one m16n8k16
// tile.
//
// Split over the cache.  The grid is (splits, B); split s takes keys
// [s * chunk, (s + 1) * chunk), chunk a multiple of 32 chosen by the wrapper
// from the cache's capacity (kv_len is never read back) so that about two
// blocks run on each SM.  A block stages the 16 query rows [q_lat, q_pe] in
// shared memory once (cp.async, with the first tile), then walks its keys in
// tiles of 32 rows through a cp.async ring (rows at or past kv_len are
// zero-filled, never read):
//   S = Q K^T    each of the 4 warps takes 8 keys over the 576 dims
//                (ldmatrix fragments of Q and K, 36 mma a warp in two
//                independent chains), scaled by scale * log2(e), masked,
//                into shared memory;
//   softmax      online, a warp per 4 heads: the running max and sum per
//                head, P as two bf16 halves (hi + lo, so that P is not
//                rounded to bf16 alone, as the flash kernel does);
//   O += P V     each warp owns 128 of the 512 value dims (16 n8 tiles,
//                accumulators in registers), V read from the same staged
//                rows with ldmatrix.trans; hi and lo, 64 mma a warp.
// Shared-memory rows are padded by 16 bytes, so the 8 rows an ldmatrix
// reads fall on distinct banks.  Each block writes its fp32 partial (m, l
// in log2 units, acc[H][512]) to scratch; an empty split writes nothing.
//
// Merge.  A second launch, one block a (head, sequence), over the splits
// that hold a valid row (the first ceil(kv_len / chunk)), four groups of
// threads each taking every fourth split: M = max m_s, o = sum acc_s
// 2^(m_s - M) / max(sum l_s 2^(m_s - M), 1e-30).  Nothing persists between
// calls, so two calls on different streams may run at once.

#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kLat = 512;              // latent width: the value
constexpr int kRope = 64;              // RoPE key width
constexpr int kKey = kLat + kRope;     // a key row
constexpr int kHeads = 16;             // query heads: the M of one mma tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 32;             // keys a tile, 8 a warp in Q.K
constexpr int kStages = 2;             // the cp.async ring: two blocks of ~96 KB fit an SM (3 stages: one)
constexpr int kRow = kKey + 8;         // padded shared row of Q and K, elements (1168 bytes)
constexpr int kPRow = kTileK + 8;      // padded row of P (80 bytes)
constexpr int kDims = kLat / kWarps;   // value dims a warp owns in P.V
constexpr int kNTiles = kDims / 8;     // its n8 tiles
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  static constexpr size_t kQ = sizeof(bf16) * kHeads * kRow;
  static constexpr size_t kStage = sizeof(bf16) * kTileK * kRow;
  static constexpr size_t kS = sizeof(float) * kHeads * kTileK;
  static constexpr size_t kP = sizeof(bf16) * 2 * kHeads * kPRow;
  static constexpr size_t kStats = sizeof(float) * 3 * kHeads;  // m, l, alpha
  static constexpr size_t kTotal = kQ + kStages * kStage + kS + kP + kStats;
};

struct Args {
  const int* kv_len_ptr;
  int kv_len_val;
  int H, Lk, chunk;
  long long sqb, sqh, spb, sph, scb, scl, skb, skl;
  float scale_log2;  // scale * log2(e)
  float* part;       // [B, splits, H, kLat] accumulators, then [B, splits, H] (m, l)
};

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
mla_split_kernel(const bf16* __restrict__ q_lat, const bf16* __restrict__ q_pe,
                 const bf16* __restrict__ c_kv, const bf16* __restrict__ k_pe, const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                // [kHeads][kRow]
  bf16* ring = reinterpret_cast<bf16*>(smem + Smem::kQ);    // [kStages][kTileK][kRow]
  float* Ss = reinterpret_cast<float*>(smem + Smem::kQ + kStages * Smem::kStage);  // [kHeads][kTileK]
  bf16* Ps = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(Ss) + Smem::kS);  // [2][kHeads][kPRow]
  float* Ms = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Ps) + Smem::kP);
  float* Ls = Ms + kHeads;
  float* As = Ls + kHeads;

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the fragment's row (and row + 8)
  const int t = lane & 3;   // the fragment's column pair
  int kv_len = a.kv_len_ptr ? *a.kv_len_ptr : a.kv_len_val;
  kv_len = max(0, min(kv_len, a.Lk));
  const int c0 = split * a.chunk;
  const int c1 = min(c0 + a.chunk, kv_len);
  const int ntiles = c1 > c0 ? (c1 - c0 + kTileK - 1) / kTileK : 0;

  const size_t row0 = (static_cast<size_t>(b) * splits + split) * a.H;  // partial row of head 0
  float* pacc = a.part;
  float2* ml = reinterpret_cast<float2*>(a.part + static_cast<size_t>(gridDim.y) * splits * a.H * kLat);
  if (ntiles == 0) return;  // an empty split: the merge reads only the splits below kv_len

  const bf16* cb = c_kv + b * a.scb;
  const bf16* pb = k_pe + b * a.skb;
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      bf16* Ks = ring + (i % kStages) * kTileK * kRow;
      const int t0 = c0 + i * kTileK;
      // 72 16-byte pieces a row: 64 of c_kv, then 8 of k_pe; rows at or past
      // c1 are zero-filled (their scores are masked, and P = 0 meets V = 0).
      for (int x = threadIdx.x; x < kTileK * (kKey / 8); x += kThreads) {
        const int j = x / (kKey / 8), piece = x - j * (kKey / 8);
        const bool ok = t0 + j < c1;
        const long long r = ok ? t0 + j : c0;
        const bf16* src = piece < kLat / 8 ? cb + r * a.scl + piece * 8 : pb + r * a.skl + (piece - kLat / 8) * 8;
        cp_async16_zfill(Ks + j * kRow + piece * 8, src, ok);
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  // The query rows [q_lat, q_pe], zero-filled past H, in the first group with tile 0.
  for (int x = threadIdx.x; x < kHeads * (kKey / 8); x += kThreads) {
    const int h = x / (kKey / 8), piece = x - h * (kKey / 8);
    const long long hh = h < a.H ? h : 0;
    const bf16* src = piece < kLat / 8 ? q_lat + b * a.sqb + hh * a.sqh + piece * 8
                                       : q_pe + b * a.spb + hh * a.sph + (piece - kLat / 8) * 8;
    cp_async16_zfill(Qs + h * kRow + piece * 8, src, h < a.H);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_tile(i);

  if (threadIdx.x < kHeads) {
    Ms[threadIdx.x] = rt::kNegInf;
    Ls[threadIdx.x] = 0.f;
  }

  float acc[kNTiles][4];
#pragma unroll
  for (int n = 0; n < kNTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i has landed for every thread; the last tile's P.V is done
    load_tile(i + kStages - 1);  // into the stage that tile i - 1 used
    const bf16* Ks = ring + (i % kStages) * kTileK * kRow;
    const int n = min(kTileK, c1 - (c0 + i * kTileK));  // valid keys of this tile

    // S = Q K^T for this warp's 8 keys.
    const int key0 = warp * 8;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};  // two chains of 18 mma, not one of 36
#pragma unroll 3
    for (int kk = 0; kk < kKey; kk += 32) {
      uint32_t a0[4], a1[4], bk[4];
      ldmatrix_x4(a0, Qs + (lane & 15) * kRow + kk + (lane >> 4) * 8);
      ldmatrix_x4(a1, Qs + (lane & 15) * kRow + kk + 16 + (lane >> 4) * 8);
      ldmatrix_x4(bk, Ks + (key0 + (lane & 7)) * kRow + kk + (lane >> 3) * 8);
      mma(s, a0, bk[0], bk[1]);
      mma(s1, a1, bk[2], bk[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] += s1[e];
    {
      const int j = key0 + 2 * t;
      Ss[g * kTileK + j] = j < n ? s[0] * a.scale_log2 : rt::kNegInf;
      Ss[g * kTileK + j + 1] = j + 1 < n ? s[1] * a.scale_log2 : rt::kNegInf;
      Ss[(g + 8) * kTileK + j] = j < n ? s[2] * a.scale_log2 : rt::kNegInf;
      Ss[(g + 8) * kTileK + j + 1] = j + 1 < n ? s[3] * a.scale_log2 : rt::kNegInf;
    }
    __syncthreads();

    // Online softmax: warp w takes heads 4w .. 4w + 3, 8 lanes a head, 4 keys a lane.
    {
      const int row = warp * 4 + (lane >> 3);
      const int j0 = (lane & 7) * 4;
      float v[4];
      float mx = rt::kNegInf;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = Ss[row * kTileK + j0 + e];
        mx = fmaxf(mx, v[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(rt::kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(rt::kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(rt::kFull, mx, 4));
      const float m_old = Ms[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(v[e] - m_new);  // a masked key gives 0
        const bf16 hi = __float2bfloat16_rn(p);
        Ps[row * kPRow + j0 + e] = hi;
        Ps[(kHeads + row) * kPRow + j0 + e] = __float2bfloat16_rn(p - __bfloat162float(hi));
        sum += p;
      }
      sum += __shfl_xor_sync(rt::kFull, sum, 1);
      sum += __shfl_xor_sync(rt::kFull, sum, 2);
      sum += __shfl_xor_sync(rt::kFull, sum, 4);
      __syncwarp();
      if ((lane & 7) == 0) {
        const float alpha = exp2f(m_old - m_new);
        Ls[row] = Ls[row] * alpha + sum;
        Ms[row] = m_new;
        As[row] = alpha;
      }
    }
    __syncthreads();

    // O += P V over this warp's 128 value dims.
    {
      const float al0 = As[g], al1 = As[g + 8];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        acc[nt][0] *= al0;
        acc[nt][1] *= al0;
        acc[nt][2] *= al1;
        acc[nt][3] *= al1;
      }
      const int d0 = warp * kDims;
#pragma unroll
      for (int ks = 0; ks < kTileK; ks += 16) {
        uint32_t ph[4], pl[4];
        ldmatrix_x4(ph, Ps + (lane & 15) * kPRow + ks + (lane >> 4) * 8);
        ldmatrix_x4(pl, Ps + (kHeads + (lane & 15)) * kPRow + ks + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < kNTiles; nt += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Ks + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow + d0 + nt * 8 + (lane >> 4) * 8);
          mma(acc[nt], ph, bv[0], bv[1]);
          mma(acc[nt], pl, bv[0], bv[1]);
          mma(acc[nt + 1], ph, bv[2], bv[3]);
          mma(acc[nt + 1], pl, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left

  // This split's partial: (m, l) per head, and the accumulators of rows g, g + 8.
  if (threadIdx.x < a.H) ml[row0 + threadIdx.x] = make_float2(Ms[threadIdx.x], Ls[threadIdx.x]);
  const int d0 = warp * kDims + 2 * t;
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    if (g < a.H)
      *reinterpret_cast<float2*>(pacc + (row0 + g) * kLat + d0 + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
    if (g + 8 < a.H)
      *reinterpret_cast<float2*>(pacc + (row0 + g + 8) * kLat + d0 + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// One block a (head, sequence), kMergeGroups groups of 128 threads; thread x
// of a group owns dims 4x .. 4x + 3.  The splits that hold a valid row are
// the first ceil(kv_len / chunk); group q takes splits q, q + kMergeGroups,
// ... with a running max (so each thread's loads of a split are independent
// of the others' and many are in flight), and group 0 merges the groups.
constexpr int kMergeGroups = 4;

__global__ void __launch_bounds__(kMergeGroups * kLat / 4)
mla_merge_kernel(bf16* __restrict__ o, const float* __restrict__ part, const int* kv_len_ptr, int kv_len_val,
                 int Lk, int chunk, int splits, long long sob, long long soh) {
  __shared__ float4 so[kMergeGroups][kLat / 4];
  __shared__ float sm[kMergeGroups], sd[kMergeGroups];
  const int h = blockIdx.x, H = gridDim.x, b = blockIdx.y;
  const int grp = threadIdx.x / (kLat / 4), x = threadIdx.x - grp * (kLat / 4);
  int kv_len = kv_len_ptr ? *kv_len_ptr : kv_len_val;
  kv_len = max(0, min(kv_len, Lk));
  const int live = min(splits, (kv_len + chunk - 1) / chunk);
  const float2* ml = reinterpret_cast<const float2*>(part + static_cast<size_t>(gridDim.y) * splits * H * kLat);
  const size_t row0 = static_cast<size_t>(b) * splits * H + h;  // split 0 of head h
  float m = rt::kNegInf, denom = 0.f;
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = grp; s < live; s += kMergeGroups) {
    const size_t row = row0 + static_cast<size_t>(s) * H;
    const float2 v = ml[row];
    const float4 y = *reinterpret_cast<const float4*>(part + row * kLat + 4 * x);
    const float m_new = fmaxf(m, v.x);
    const float keep = exp2f(m - m_new), w = exp2f(v.x - m_new);
    denom = denom * keep + v.y * w;
    out.x = out.x * keep + y.x * w;
    out.y = out.y * keep + y.y * w;
    out.z = out.z * keep + y.z * w;
    out.w = out.w * keep + y.w * w;
    m = m_new;
  }
  so[grp][x] = out;
  if (x == 0) {
    sm[grp] = m;
    sd[grp] = denom;
  }
  __syncthreads();
  if (grp != 0) return;
  float mx = sm[0];
#pragma unroll
  for (int q = 1; q < kMergeGroups; ++q) mx = fmaxf(mx, sm[q]);
  float den = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int q = 0; q < kMergeGroups; ++q) {
    const float w = exp2f(sm[q] - mx);  // a group with no split: m = -1e30, w = 0
    den += sd[q] * w;
    acc.x += so[q][x].x * w;
    acc.y += so[q][x].y * w;
    acc.z += so[q][x].z * w;
    acc.w += so[q][x].w * w;
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
  bf16* dst = o + b * sob + h * soh + 4 * x;
  dst[0] = __float2bfloat16_rn(acc.x * inv);
  dst[1] = __float2bfloat16_rn(acc.y * inv);
  dst[2] = __float2bfloat16_rn(acc.z * inv);
  dst[3] = __float2bfloat16_rn(acc.w * inv);
}

int launch_split(const void* q_lat, const void* q_pe, const void* c_kv, const void* k_pe, int B, int splits,
                 const Args& a, cudaStream_t stream) {
  constexpr size_t bytes = Smem::kTotal;
  static const cudaError_t attr = rt::allow_smem(mla_split_kernel, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  mla_split_kernel<<<dim3(splits, B), kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q_lat), static_cast<const bf16*>(q_pe), static_cast<const bf16*>(c_kv),
      static_cast<const bf16*>(k_pe), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_lat: [B, H, 512], q_pe: [B, H, 64] with (b, h) strides; c_kv: [B, Lk,
// 512], k_pe: [B, Lk, 64] with (b, l) strides; o: [B, H, 512] with (b, h)
// strides; unit stride along the last dim everywhere, bf16; q_lat, q_pe,
// c_kv and k_pe 16-byte aligned, base and rows.  kv_len comes from a device
// int32 scalar when kv_len_ptr is non-null, else from kv_len_val.  chunk (a
// multiple of 32) is the keys a block takes; with splits = ceil(Lk / chunk),
// part is scratch of at least B * splits * H * (512 + 2) floats.  Returns a
// cudaError_t.
extern "C" int mla_decode_launch(const void* q_lat, const void* q_pe, const void* c_kv, const void* k_pe,
                                 void* o, const int* kv_len_ptr, int kv_len_val, int B, int H, int Lk,
                                 long long sqb, long long sqh, long long spb, long long sph, long long scb,
                                 long long scl, long long skb, long long skl, long long sob, long long soh,
                                 float scale, int chunk, void* part, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > kHeads || Lk <= 0 || chunk <= 0 || chunk % kTileK != 0 ||
      part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (Lk + chunk - 1) / chunk;
  const Args a{kv_len_ptr, kv_len_val, H, Lk, chunk, sqb, sqh, spb, sph, scb, scl, skb, skl,
               scale * kLog2e, static_cast<float*>(part)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = launch_split(q_lat, q_pe, c_kv, k_pe, B, splits, a, s);
  if (rc != 0) return rc;
  mla_merge_kernel<<<dim3(H, B), kMergeGroups * kLat / 4, 0, s>>>(
      static_cast<bf16*>(o), static_cast<const float*>(part), kv_len_ptr, kv_len_val, Lk, chunk, splits, sob, soh);
  return static_cast<int>(cudaGetLastError());
}

RT_EXPORT_ERROR_STRING(mla_decode)
