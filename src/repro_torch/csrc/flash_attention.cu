// Flash attention (prefill) for Hopper: online-softmax GQA attention over a
// KV cache, with fp32 scores, fp32 exp, fp32 probabilities and fp32
// accumulators; inputs and output in bf16 (the served model) or fp32.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (Pallas, TPU),
// extended by a query offset so that a prefill at any cache length reaches it:
// query row t sits at absolute position q_offset + t.  With q_offset = 0 it
// computes what the TPU kernel computes:
//   s = (q . k) / sqrt(d), the scale applied to the fp32 score, optionally
//   tanh-softcapped;
//   key s is live for row t iff s < kv_len, and (causal) s <= q_offset + t,
//   and (window > 0) q_offset + t - s < window;
//   o = softmax(s) v, with masked scores at -1e30 and the denominator
//   clamped at 1e-30.  Query head h reads KV head h / (Hq / Hkv).
// A row with no live key comes out 0 (the TPU kernel's result when every
// KV block of the row is skipped).  q_offset and kv_len are device int32
// scalars the kernel reads itself; nothing waits on the host.  Strides are
// taken per tensor, so q/k/v/o are read in the model's [B, L, H, d] layout
// and the cache is never copied; any Lq and Lk, the ragged edges masked.
//
// Bound on the H100: a causal prefill of Lq rows does about
// Hq * Lq / (2 * (Hq + Hkv)) operations for each byte of q, k, v and o it
// must move: 48 at the serving shape (Hq=24, Hkv=8, Lq=128), under the
// card's ~295 bf16 operations a byte, so there bytes and latency bound it;
// from prompts of about 800 tokens on, the tensor cores' 989 TFLOP/s do.
//
// bf16: wgmma on a TMA ring.
// - A block owns a 64-row query tile (one wgmma M) for all G query heads of
//   one KV group: one consumer warpgroup a head (G = 3 for llama3.2-3b), up
//   to three at d <= 128 and two at d = 192 (where the 64 x 192 fp32
//   accumulator takes 96 registers a thread); a larger group is taken in
//   passes of that many heads.  So each K/V tile is staged once for the
//   group and not once for each query head.  Blocks run longest-rows first.
// - K and V tiles of 64 keys x d stream through a ring in shared memory (4
//   stages at d <= 128, 3 at d = 192): TMA loads with 128-byte swizzle over
//   tensor maps built on the host over the strided views (4-D, innermost
//   first), completion on one mbarrier per stage for K and one for V (so
//   Q.K^T starts before V lands), release on an "empty" mbarrier that every
//   warp arrives on.
//   Thread 0 issues the loads: one a stage at the start, then each stage
//   again once all warps have released it, a ring's length ahead of the
//   math.  (A producer warp of its own would be a 13th warp and cap every
//   thread at 128 registers, where the accumulators spill.)  Each
//   warpgroup loads its own Q tile by TMA.
// - S = Q K^T: wgmma m64n64k16, bf16 from shared memory, fp32 accumulate;
//   1/sqrt(d), softcap and masks go on the fp32 accumulator fragments, the
//   online softmax in fp32 with the scale folded into the exponent
//   (p = 2^(s c - m c), c = log2(e) / sqrt(d)), row max and sum over the 4
//   lanes of a row.
// - O += P V without rounding P to bf16 alone: P = P_hi + P_lo, both bf16,
//   two register-A wgmmas m64nDk16 a k-step into the fp32 accumulator.
//   P_hi + P_lo carries P to a relative error of about 2^-16 (P_lo's own
//   rounding), against 2^-9 for P in bf16; V is exact in bf16.  The tensor
//   cores do 1.5 times the products of a bf16-P kernel for it.
// - Rows at or past kv_len contribute exactly 0 even if they hold Inf or
//   NaN: their scores are masked by a select (never by arithmetic), and
//   in the last live tile the V rows in [kv_len, Lk) are zeroed in shared
//   memory before the P.V products (TMA zero-fills only rows past Lk).
//   Tiles wholly outside the live range (causal, kv_len, window) are never
//   loaded.
//
// fp32: the CUDA-core kernel of the first version, unchanged: each block
// owns 16 query rows of one head (4 warps x 4 rows); K and V are staged
// through shared memory 32 keys at a time in fp32; lane j of a warp owns key
// j of the tile for Q.K and output dims lane + 32c for P.V.  It serves the
// fp32 checks; the served model is bf16.

#include "common.cuh"
#include "sm90.cuh"

// Launch status for a tensor map the driver would not encode: this plus
// the CUresult.
constexpr int kTensorMapError = 100000;

// ---- fp32: CUDA cores (the first version, kept for the fp32 checks) -----------------

namespace simt {

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

}  // namespace simt

// ---- bf16: wgmma on a TMA ring ----------------------------------------------------

namespace hop {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;        // query rows a block: one wgmma M
constexpr int kBN = 64;        // keys a tile
constexpr int kChunkBytes = 64 * 64 * 2;  // one [64 rows][64 bf16] swizzled chunk, 8 KB
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kChunks = D / 64;               // 64-column chunks of a row
  static constexpr int kTile = kChunks * kChunkBytes;  // one Q, K or V tile
  // Consumer warpgroups a block (query heads at once): three at D <= 128,
  // two at D = 192, where each holds a 64 x 192 fp32 accumulator.
  static constexpr int kMaxNC = D <= 128 ? 3 : 2;
  static constexpr int kStages = D <= 128 ? 4 : 3;  // K/V tiles in flight, as smem allows
  // No producer warp of its own: a 13th warp would put four warps on one of
  // the SM's four register-file quarters and cap every thread at 128
  // registers, where the d = 128 accumulators spill; with 12 warps the cap
  // is 168.
  static constexpr int kThreads = kMaxNC * 128;
  static constexpr size_t smem(int nc) {
    return 1024 + static_cast<size_t>(nc + 2 * kStages) * kTile + 8 * (3 * kStages + kMaxNC);
  }
};

struct Params {
  bf16* o;
  long long sob, soh, sol;
  const int* q_off_ptr;
  int q_off_val;
  const int* kv_len_ptr;
  int kv_len_val;
  int G, NC, passes, Lq, Lk, causal, window;
  float softcap;
  float pre_mul;  // with a softcap: 1 / (sqrt(d) * softcap)
  float cap_mul;  // with a softcap: softcap * log2(e)
  float exp_mul;  // log2(e) / sqrt(d), or 1 with a softcap
  int q_lfirst, k_lfirst, v_lfirst;
};

// Coordinates of a [B, H, L, D] map whose middle dimensions are in the
// order sm90::make_map_bhld chose.
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int l_first, int col, int row, int h, int b) {
  if (l_first)
    sm90::tma_load_4d(dst, map, bar, col, row, h, b);
  else
    sm90::tma_load_4d(dst, map, bar, col, h, row, b);
}

// 2^x in one instruction (MUFU.EX2; results under 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two bf16 as one register: .x in the low half (the lower column).
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, const Params p) {
  using C = Cfg<D>;
  constexpr int NCH = C::kChunks;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors need 1024-byte tiles.
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;                              // [NC][tile]
  unsigned char* k_s = q_s + p.NC * C::kTile;             // [kStages][tile]
  unsigned char* v_s = k_s + kStages * C::kTile;          // [kStages][tile]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(v_s + kStages * C::kTile);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;
  uint64_t* q_full = empty + kStages;  // [NC]

  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // the longest rows start first
  const int q_off = p.q_off_ptr ? *p.q_off_ptr : p.q_off_val;
  int kv_len = p.kv_len_ptr ? *p.kv_len_ptr : p.kv_len_val;
  kv_len = max(0, min(kv_len, p.Lk));

  // Live key tiles of the block (the same for all its heads).
  const int t_last = min(t0 + kBM, p.Lq) - 1;
  int k_end = kv_len;
  if (p.causal) k_end = min(k_end, q_off + t_last + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_off + t0 - p.window + 1);
  k_begin -= k_begin % kBN;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kBN - 1) / kBN : 0;

  const int consumers = p.NC * 128;
  const int total = p.passes * ntiles;  // K/V tiles the block streams
  // Thread 0 keeps K and V tiles in flight: flat tile j is tile j % ntiles
  // of its pass, in stage j % kStages.
  auto issue = [&](int j) {
    const int st = j % kStages;
    const int s0 = k_begin + (j % ntiles) * kBN;
    sm90::mbar_arrive_expect_tx(&full_k[st], C::kTile);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      load_rows(k_s + st * C::kTile + c * kChunkBytes, &map_k, &full_k[st], p.k_lfirst, c * 64,
                s0, hk, b);
    sm90::mbar_arrive_expect_tx(&full_v[st], C::kTile);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      load_rows(v_s + st * C::kTile + c * kChunkBytes, &map_v, &full_v[st], p.v_lfirst, c * 64,
                s0, hk, b);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty[s], p.NC * 4);  // one arrival per warp
    }
    for (int c = 0; c < p.NC; ++c) sm90::mbar_init(&q_full[c], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x == 0)
    for (int j = 0; j < min(kStages, total); ++j) issue(j);

  // ---- one warpgroup a query head ----------------------------------------------------
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);  // the thread's rows: r0 and r0 + 8
  const int cq = 2 * (lane & 3);                 // its columns in each 8-column group
  unsigned char* my_q = q_s + wg * C::kTile;
  int it = 0;

  for (int pass = 0; pass < p.passes; ++pass) {
    const int g = pass * p.NC + wg;
    const bool active = g < p.G;  // only the last pass can leave a warpgroup idle
    const int h = hk * p.G + g;
    if (active) {
      if (pass > 0) sm90::named_barrier(2 + wg, 128);  // the old Q is no longer read
      if (tid == 0) {
        sm90::mbar_arrive_expect_tx(&q_full[wg], C::kTile);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          load_rows(my_q + c * kChunkBytes, &map_q, &q_full[wg], p.q_lfirst, c * 64, t0, h, b);
      }
      sm90::mbar_wait(&q_full[wg], pass & 1);
    }

    // O, 64 x D in fp32: columns 8 (i / 4) + cq + (i % 2) of rows r0 (+ 8).
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {rt::kNegInf, rt::kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's part of the row sums

    for (int i = 0; i < ntiles; ++i, ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const int s0 = k_begin + i * kBN;
      unsigned char* kt = k_s + st * C::kTile;
      unsigned char* vt = v_s + st * C::kTile;
      uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];

      sm90::mbar_wait(&full_k[st], ph);
      if (active) {
        // S = Q K^T on the tensor cores, fp32.
        float s[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] = 0.f;
        sm90::fence_regs(s);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk >> 2) * kChunkBytes + (kk & 3) * 32;
          sm90::wgmma_m64n64k16_ss(s, sm90::desc_b128(my_q + off, 0), sm90::desc_b128(kt + off, 0),
                                   1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(s);

        // Softcap, masks and the online softmax on the fp32 fragments.  The
        // scale goes into the exponent: p = 2^(x c - m c), with x the raw
        // score and c = log2(e) / sqrt(d) (with a softcap, x is the capped
        // score already times log2(e), and c = 1), one FFMA and one EX2.
        const bool all_live =
            s0 + kBN <= kv_len && (!p.causal || s0 + kBN - 1 <= q_off + t0) &&
            (p.window <= 0 || q_off + t0 + kBM - 1 - s0 < p.window);
        if (p.softcap > 0.f) {
#pragma unroll
          for (int j = 0; j < 32; ++j) s[j] = tanhf(s[j] * p.pre_mul) * p.cap_mul;
        }
        uint32_t live = 0xffffffffu;
        if (!all_live) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int key = s0 + 8 * (j >> 2) + cq + (j & 1);
            const int t = q_off + t0 + r0 + 8 * ((j >> 1) & 1);
            bool ok = key < kv_len;
            if (p.causal) ok = ok && key <= t;
            if (p.window > 0) ok = ok && t - key < p.window;
            if (!ok) {
              s[j] = rt::kNegInf;  // a select: a NaN score from a poisoned row goes too
              live &= ~(1u << j);
            }
          }
        }
        float mx[2] = {rt::kNegInf, rt::kNegInf};
#pragma unroll
        for (int j = 0; j < 32; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
        float alpha[2], mc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(rt::kFull, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(rt::kFull, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          alpha[r] = ex2((m[r] - m_new) * p.exp_mul);
          m[r] = m_new;
          mc[r] = m_new * p.exp_mul;
          l[r] *= alpha[r];
        }
        if (all_live) {
#pragma unroll
          for (int j = 0; j < 32; ++j) s[j] = ex2(fmaf(s[j], p.exp_mul, -mc[(j >> 1) & 1]));
        } else {
#pragma unroll
          for (int j = 0; j < 32; ++j)
            s[j] = (live >> j) & 1 ? ex2(fmaf(s[j], p.exp_mul, -mc[(j >> 1) & 1])) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) l[(j >> 1) & 1] += s[j];
        // P = P_hi + P_lo, both bf16: P.V in two products keeps P to about
        // 2^-16 relative, where P in bf16 alone would round it to 2^-9.
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = make_float2(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
            const __nv_bfloat162 hi = __float22bfloat162_rn(x);
            const float2 hf = __bfloat1622float2(hi);
            const __nv_bfloat162 lo = __float22bfloat162_rn(make_float2(x.x - hf.x, x.y - hf.y));
            p_hi[kk][e] = bits_of(hi);
            p_lo[kk][e] = bits_of(lo);
          }
        }
        if (alpha[0] != 1.f || alpha[1] != 1.f) {  // once the row maxima settle, they are 1
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        }
      }

      sm90::mbar_wait(&full_v[st], ph);
      if (kv_len < s0 + kBN && kv_len < p.Lk) {
        // V rows in [kv_len, Lk) are real memory and may hold anything, Inf
        // and NaN included; a tensor-core product multiplies whole tiles,
        // and 0 x NaN is NaN.  Zero them (rows past Lk arrived as zeros).
        const int r_beg = kv_len - s0, r_end = min(kBN, p.Lk - s0);
        const int units = (r_end - r_beg) * 8;  // 16-byte units of a chunk's rows
        for (int u = threadIdx.x; u < units * NCH; u += consumers) {
          const int c = u / units, w = u - c * units;
          *reinterpret_cast<uint4*>(vt + c * kChunkBytes + r_beg * 128 + w * 16) =
              make_uint4(0, 0, 0, 0);
        }
        sm90::fence_proxy_async();
        sm90::named_barrier(1, consumers);
      }
      if (active) {
        // O += P_hi V + P_lo V on the tensor cores, fp32 accumulators.
        // One m64nDk16 a k-step: all D columns, the 64-column chunks of V
        // at the descriptor's leading byte offset.
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          const uint64_t dv = sm90::desc_b128(vt + kk * 16 * 128, kChunkBytes);
          sm90::wgmma_rs<D>(acc, p_hi[kk], dv);
          sm90::wgmma_rs<D>(acc, p_lo[kk], dv);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(acc);
      }
      if (lane == 0) sm90::mbar_arrive(&empty[st]);
      if (threadIdx.x == 0 && it + kStages < total) {
        // Refill this stage once every warp has released it.
        sm90::mbar_wait(&empty[st], ph);
        issue(it + kStages);
      }
    }

    if (active) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(rt::kFull, l[r], 1);
        l[r] += __shfl_xor_sync(rt::kFull, l[r], 2);
        inv[r] = 1.f / fmaxf(l[r], 1e-30f);
      }
      bf16* ob = p.o + b * p.sob + h * p.soh;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + r0 + 8 * r;
        if (t >= p.Lq) continue;
        bf16* orow = ob + t * p.sol;
#pragma unroll
        for (int j8 = 0; j8 < D / 8; ++j8) {
          const int i = 4 * j8 + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j8 + cq) =
              __floats2bfloat162_rn(acc[i] * inv[r], acc[i + 1] * inv[r]);
        }
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, const int* q_offset_ptr,
           int q_offset_val, const int* kv_len_ptr, int kv_len_val, int B, int Hq, int Hkv,
           int Lq, int Lk, const simt::Strides& sq, const simt::Strides& sk,
           const simt::Strides& sv, const simt::Strides& so, int causal, int window,
           float softcap, float sm_scale, cudaStream_t stream) {
  using C = Cfg<D>;
  static const cudaError_t attr = rt::allow_smem(flash_wgmma_kernel<D>, C::smem(C::kMaxNC));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Params p{};
  p.G = Hq / Hkv;
  p.passes = (p.G + C::kMaxNC - 1) / C::kMaxNC;
  p.NC = (p.G + p.passes - 1) / p.passes;
  CUtensorMap mq, mk, mv;
  int rc = sm90::make_map_bhld(&mq, &p.q_lfirst, q, B, Hq, Lq, D, sq.b, sq.h, sq.l, kBM);
  if (rc == 0) rc = sm90::make_map_bhld(&mk, &p.k_lfirst, k, B, Hkv, Lk, D, sk.b, sk.h, sk.l, kBN);
  if (rc == 0) rc = sm90::make_map_bhld(&mv, &p.v_lfirst, v, B, Hkv, Lk, D, sv.b, sv.h, sv.l, kBN);
  if (rc != 0) return kTensorMapError + rc;
  p.o = static_cast<bf16*>(o);
  p.sob = so.b;
  p.soh = so.h;
  p.sol = so.l;
  p.q_off_ptr = q_offset_ptr;
  p.q_off_val = q_offset_val;
  p.kv_len_ptr = kv_len_ptr;
  p.kv_len_val = kv_len_val;
  p.Lq = Lq;
  p.Lk = Lk;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.pre_mul = softcap > 0.f ? sm_scale / softcap : 0.f;
  p.cap_mul = softcap * kLog2e;
  p.exp_mul = softcap > 0.f ? 1.f : sm_scale * kLog2e;
  const dim3 grid((Lq + kBM - 1) / kBM, Hkv, B);
  flash_wgmma_kernel<D><<<grid, p.NC * 128, C::smem(p.NC), stream>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               const int* q_offset_ptr, int q_offset_val, const int* kv_len_ptr, int kv_len_val,
               int B, int Hq, int Hkv, int Lq, int Lk, const simt::Strides& sq,
               const simt::Strides& sk, const simt::Strides& sv, const simt::Strides& so,
               int causal, int window, float softcap, float sm_scale, cudaStream_t s) {
  // TMA reads from 16-byte-aligned bases (the encoder checks the strides).
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, o, q_offset_ptr, q_offset_val, kv_len_ptr, kv_len_val, B, Hq,
                        Hkv, Lq, Lk, sq, sk, sv, so, causal, window, softcap, sm_scale, s);
    case 128:
      return launch<128>(q, k, v, o, q_offset_ptr, q_offset_val, kv_len_ptr, kv_len_val, B, Hq,
                         Hkv, Lq, Lk, sq, sk, sv, so, causal, window, softcap, sm_scale, s);
    case 192:
      return launch<192>(q, k, v, o, q_offset_ptr, q_offset_val, kv_len_ptr, kv_len_val, B, Hq,
                         Hkv, Lq, Lk, sq, sk, sv, so, causal, window, softcap, sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace hop

// q: [B, Hq, Lq, d], k/v: [B, Hkv, Lk, d], o: [B, Hq, Lq, d], each given by
// its (b, h, l) element strides with unit stride along d.  q_offset and
// kv_len are read from device int32 scalars when the pointers are non-null,
// else taken from the *_val arguments.  fp32 runs the CUDA-core kernel, bf16
// the wgmma kernel (whose q, k, v bases and strides must be multiples of 16
// bytes).  Returns a cudaError_t, or kTensorMapError + a CUresult when a
// tensor map cannot be encoded.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, const int* q_offset_ptr,
    int q_offset_val, const int* kv_len_ptr, int kv_len_val, int B, int Hq, int Hkv, int Lq,
    int Lk, int d, long long sqb, long long sqh, long long sql, long long skb, long long skh,
    long long skl, long long svb, long long svh, long long svl, long long sob, long long soh,
    long long sol, int causal, int window, float softcap, int dtype, void* stream) {
  if (B <= 0 || Lq <= 0 || Lk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B > 65535 || Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const simt::Strides sq{sqb, sqh, sql}, sk{skb, skh, skl}, sv{svb, svh, svl}, so{sob, soh, sol};
  const float sm_scale = 1.f / sqrtf(static_cast<float>(d));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kFloat32:
      return simt::dispatch_d<float>(d, q, k, v, o, q_offset_ptr, q_offset_val, kv_len_ptr,
                                     kv_len_val, B, Hq, Hkv, Lq, Lk, sq, sk, sv, so, causal,
                                     window, softcap, sm_scale, s);
    case rt::kBFloat16:
      return hop::dispatch_d(d, q, k, v, o, q_offset_ptr, q_offset_val, kv_len_ptr, kv_len_val,
                             B, Hq, Hkv, Lq, Lk, sq, sk, sv, so, causal, window, softcap,
                             sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code >= kTensorMapError)
    return "cuTensorMapEncodeTiled failed (code - 100000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
