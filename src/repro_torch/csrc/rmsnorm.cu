// RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * (1 + w), in fp32,
// written back in x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py::_rmsnorm_kernel (Pallas, TPU).
//
// Bound on the H100: bytes.  A row is read once and written once, w is
// read once, and the arithmetic is four operations an element, far below
// the card's ~295 bf16 operations a byte.  So the design spends the bytes
// once and waits for memory once a row:
//
// - One pass from registers.  Each thread issues every load it needs up
//   front: its 16-byte pieces of the row (8 bf16 or 4 fp32 values each,
//   `ld.global.nc` that does not allocate in L1) and the matching pieces of
//   w (through L1, where the other rows of the SM find them).  It squares
//   and sums in fp32 from those registers, reduces with warp shuffles (and,
//   where a row spans several warps, one exchange through shared memory
//   behind one barrier), then scales the same registers and stores 16 bytes
//   at a time.  x is never read a second time: one memory round trip a row
//   before the store.  A thread holds at most kMaxValues = 32 values of a
//   row, so d <= 8192 fits in 256 threads without spills.
// - Rows mapped to threads by width.  The plan (kernels/rmsnorm.py::plan)
//   gives the loads a thread (the template N), the warps a row and the rows
//   a block: a warp a row and four rows a block for d <= 1024 (no barrier),
//   a group of warps a row for wider rows, chosen to cover d with the least
//   idle lanes and the fewest threads.  The grid covers the rows exactly; the
//   last block masks the rows past the end.  A row's sum never meets another
//   row's: shuffles stay in the row's warps and each warp of the block has
//   its own shared-memory slot, so a NaN or inf stays in its row.
// - A scalar instance (VEC = 1, up to 32 values a thread) for a d that is
//   not a multiple of 16 bytes, or for x, w or y whose base or row stride is
//   not 16-byte aligned.  It is the same kernel, one element a load.
//
// Thread-block clusters and programmatic dependent launch buy nothing here:
// a row of at most 16 KB is one round trip from one SM, and the eager decode
// step leaves the card idle between kernels, so there is no prologue to hide.

#include <utility>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // a block; a row takes at most 8 warps
constexpr int kMaxValues = 32;    // values of a row one thread holds

__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<unsigned*>(&h);
}

// VEC elements of T, loaded and stored as one piece: 16 bytes, or one
// element on the scalar path.
template <typename T, int VEC>
struct Piece {
  static_assert(VEC * sizeof(T) == 16, "a vector piece is 16 bytes");
  uint4 r;
  __device__ __forceinline__ void load_stream(const T* p) { r = ld_stream16(p); }
  __device__ __forceinline__ void load_cached(const T* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void unpack(float* f) const { rt::Vec16<T>::unpack(r, f); }
  __device__ __forceinline__ static void store(T* p, const float* f) {
    uint4 o;
    if constexpr (sizeof(T) == 4) {
      o = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                     __float_as_uint(f[3]));
    } else {
      o = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]), pack_bf16x2(f[4], f[5]),
                     pack_bf16x2(f[6], f[7]));
    }
    *reinterpret_cast<uint4*>(p) = o;
  }
};

template <typename T>
struct Piece<T, 1> {
  T r;
  __device__ __forceinline__ void load_stream(const T* p) { r = __ldg(p); }
  __device__ __forceinline__ void load_cached(const T* p) { r = __ldg(p); }
  __device__ __forceinline__ void zero() { r = rt::from_f32<T>(0.f); }
  __device__ __forceinline__ void unpack(float* f) const { f[0] = rt::to_f32(r); }
  __device__ __forceinline__ static void store(T* p, const float* f) { *p = rt::from_f32<T>(f[0]); }
};

// Row `row` of the block's rows is taken by `warps_per_row` warps; thread t
// of the row takes pieces t, t + 32 * warps_per_row, ... of the d / VEC.
template <typename T, int VEC, int N>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               long long rows, int d, long long x_row_stride, long long y_row_stride,
               float eps, int warps_per_row) {
  const int warp = threadIdx.x >> 5;
  const int row_in_block = warp / warps_per_row;
  const int threads_per_row = warps_per_row * 32;
  const int t = threadIdx.x - row_in_block * threads_per_row;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / threads_per_row) + row_in_block;
  const bool live = row < rows;
  const int pieces = d / VEC;
  const T* xr = x + row * x_row_stride;
  T* yr = y + row * y_row_stride;

  // Every load of the row first, x and w in one batch.
  Piece<T, VEC> xp[N], wp[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c = k * threads_per_row + t;
    if (live && c < pieces) {
      xp[k].load_stream(xr + c * VEC);
      wp[k].load_cached(w + c * VEC);
    } else {
      xp[k].zero();
      wp[k].zero();
    }
  }

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float f[VEC];
    xp[k].unpack(f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) ss += f[i] * f[i];
  }
  ss = rt::warp_sum(ss);
  if (warps_per_row > 1) {  // the same for the whole block
    __shared__ float part[kMaxThreads / 32];
    if ((threadIdx.x & 31) == 0) part[warp] = ss;
    __syncthreads();
    // Every thread of a row adds the row's warps in the same order, so all
    // hold the same sum.
    const int w0 = row_in_block * warps_per_row;
    ss = 0.f;
    for (int i = 0; i < warps_per_row; ++i) ss += part[w0 + i];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c = k * threads_per_row + t;
    if (live && c < pieces) {
      float f[VEC], g[VEC];
      xp[k].unpack(f);
      wp[k].unpack(g);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = f[i] * r * (1.f + g[i]);
      Piece<T, VEC>::store(yr + c * VEC, f);
    }
  }
}

// Does nothing: launched on rmsnorm's grid, it times the launch floor that
// every rmsnorm launch pays (chip_smoke.py).
__global__ void __launch_bounds__(kMaxThreads) empty_kernel() {}

struct Launch {
  const void* x;
  const void* w;
  void* y;
  long long rows;
  int d;
  long long xs, ys;
  float eps;
  int warps_per_row;
  dim3 grid, block;
  cudaStream_t stream;
};

template <typename T, int VEC, int N>
int launch(const Launch& a) {
  rmsnorm_kernel<T, VEC, N><<<a.grid, a.block, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w), static_cast<T*>(a.y), a.rows, a.d,
      a.xs, a.ys, a.eps, a.warps_per_row);
  return static_cast<int>(cudaGetLastError());
}

// The vector instance with N == n pieces a thread, for n in 1..kMaxValues / VEC.
template <typename T, int VEC, int... I>
int launch_vec(const Launch& a, int n, std::integer_sequence<int, I...>) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  ((n == I + 1 ? (rc = launch<T, VEC, I + 1>(a), 0) : 0), ...);
  return rc;
}

template <typename T>
int dispatch(const Launch& a, int vec, int n) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == 1) return launch<T, 1, kMaxValues>(a);  // masks the pieces past d
  return launch_vec<T, kVec>(a, n, std::make_integer_sequence<int, kMaxValues / kVec>{});
}

// Checks a plan against the shapes, the alignment and the instances.
int check_plan(const void* x, const void* w, const void* y, long long rows, int d,
               long long xs, long long ys, int esize, int vec, int n, int warps_per_row,
               int rows_per_block, Launch* a) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int threads = warps_per_row * 32 * rows_per_block;
  if (rows <= 0 || d <= 0 || warps_per_row < 1 || rows_per_block < 1 || threads > kMaxThreads)
    return bad;
  if (vec != 1 && vec != 16 / esize) return bad;
  if (d % vec != 0 || n < 1 || n * vec > kMaxValues ||
      static_cast<long long>(n) * 32 * warps_per_row * vec < d)
    return bad;
  if (vec > 1) {
    const unsigned long long bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                                    reinterpret_cast<uintptr_t>(y) |
                                    static_cast<unsigned long long>(xs * esize) |
                                    static_cast<unsigned long long>(ys * esize);
    if (bits & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return bad;
  a->grid = dim3(static_cast<unsigned>(blocks));
  a->block = dim3(static_cast<unsigned>(threads));
  return 0;
}

int esize_of(int dtype) {
  return dtype == rt::kFloat32 ? 4 : dtype == rt::kBFloat16 ? 2 : 0;
}

}  // namespace

// x: [rows, d] with row stride x_row_stride (unit stride along d); w: [d];
// y: [rows, d] with row stride y_row_stride.  (vec, n, warps_per_row,
// rows_per_block) is the plan of kernels/rmsnorm.py::plan: elements a load
// (16 bytes' worth, or 1), loads of x a thread, warps a row, rows a block.
// Returns a cudaError_t.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, long long rows, int d,
                              long long x_row_stride, long long y_row_stride, float eps,
                              int dtype, int vec, int n, int warps_per_row, int rows_per_block,
                              void* stream) {
  const int esize = esize_of(dtype);
  if (esize == 0) return static_cast<int>(cudaErrorInvalidValue);
  Launch a{x, w, y, rows, d, x_row_stride, y_row_stride, eps, warps_per_row, {}, {},
           static_cast<cudaStream_t>(stream)};
  const int rc = check_plan(x, w, y, rows, d, x_row_stride, y_row_stride, esize, vec, n,
                            warps_per_row, rows_per_block, &a);
  if (rc != 0) return rc;
  return dtype == rt::kFloat32 ? dispatch<float>(a, vec, n) : dispatch<__nv_bfloat16>(a, vec, n);
}

// The same arguments and checks as rmsnorm_launch; launches the empty kernel
// on the grid rmsnorm would take.
extern "C" int rmsnorm_empty_launch(const void* x, const void* w, void* y, long long rows, int d,
                                    long long x_row_stride, long long y_row_stride, float eps,
                                    int dtype, int vec, int n, int warps_per_row,
                                    int rows_per_block, void* stream) {
  const int esize = esize_of(dtype);
  if (esize == 0) return static_cast<int>(cudaErrorInvalidValue);
  Launch a{};
  const int rc = check_plan(x, w, y, rows, d, x_row_stride, y_row_stride, esize, vec, n,
                            warps_per_row, rows_per_block, &a);
  if (rc != 0) return rc;
  empty_kernel<<<a.grid, a.block, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

RT_EXPORT_ERROR_STRING(rmsnorm)
