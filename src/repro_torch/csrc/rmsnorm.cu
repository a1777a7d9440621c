// RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * (1 + w), in fp32,
// written back in x's dtype.
//
// Replaces: src/repro/kernels/rmsnorm.py::_rmsnorm_kernel (Pallas, TPU).
//
// Bound on the H100: bytes.  Each row is read and written once and the
// arithmetic is four operations an element, far below the card's ~295
// bf16 operations a byte.  The design therefore only has to keep the
// memory traffic at one read and one write of each row: one block owns a
// whole row (d <= 8192, so the feature dim is never split across blocks
// and no second pass is needed), the threads sweep the row with unit
// stride so every warp load is coalesced, the mean square is reduced
// across the block in shared memory, and the second sweep that scales
// the row re-reads it from L1/L2, not from device memory.  Rows that
// the TPU kernel padded up to a block multiple need no padding here: the
// grid has exactly one block a row.  At decode the grid has only B rows,
// so the card is mostly idle; that is accepted in this first version.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
               int d, long long x_row_stride, long long y_row_stride, float eps) {
  const T* xr = x + static_cast<long long>(blockIdx.x) * x_row_stride;
  T* yr = y + static_cast<long long>(blockIdx.x) * y_row_stride;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = rt::to_f32(xr[i]);
    ss += v * v;
  }
  __shared__ float partial[kThreads / 32];
  ss = rt::warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kThreads / 32 ? partial[threadIdx.x] : 0.f;
    t = rt::warp_sum(t);
    if (threadIdx.x == 0) partial[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(partial[0] / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = rt::to_f32(xr[i]) * r;
    yr[i] = rt::from_f32<T>(v * (1.f + rt::to_f32(w[i])));
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, long long rows, int d,
           long long x_row_stride, long long y_row_stride, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), d,
      x_row_stride, y_row_stride, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [rows, d] with row stride x_row_stride (unit stride along d);
// w: [d]; y: [rows, d] with row stride y_row_stride.  Returns a cudaError_t.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, long long rows, int d,
                              long long x_row_stride, long long y_row_stride, float eps,
                              int dtype, void* stream) {
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kFloat32:
      return launch<float>(x, w, y, rows, d, x_row_stride, y_row_stride, eps, s);
    case rt::kBFloat16:
      return launch<__nv_bfloat16>(x, w, y, rows, d, x_row_stride, y_row_stride, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

RT_EXPORT_ERROR_STRING(rmsnorm)
