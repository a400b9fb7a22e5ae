// RMSNorm kernel for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * g.
//
// Replaces src/repro/kernels/rmsnorm.py::_rmsnorm_kernel (launched by
// rmsnorm_pallas), which normalises 128-row blocks of width d in VMEM.
//
// Contract: x and y are (rows, d) row-major, g is (d,), all of one dtype
// (float or bfloat16); the sum of squares, the scale and the product with
// g run in fp32 and the result is cast back to the input dtype, as the
// reference does.  Any row count: rows are not padded.
//
// What bounds it on this card: every element is read once and written
// once, with a handful of operations each, so device-memory bandwidth
// bounds it (2 * rows * d * sizeof(T) bytes + g).
//
// What the design does about it: rows of d <= 1024 (the qk-norm's head
// width) take one warp each, eight rows to a block, so a small row does
// not leave a block of idle threads; wider rows (the model width) take a
// block of 256 threads each.  The sum of squares is a warp-shuffle
// reduction (plus one shared-memory step across warps for the block
// variant); the second pass re-reads x, which the first pass left in L1
// and L2.  Vector loads and a single pass holding the row in registers
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRowsMaxD = 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// one warp per row, kThreads / 32 rows per block
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_warp_rows(const T* __restrict__ x, const T* __restrict__ g,
                      T* __restrict__ y, long long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_float(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);
  for (int i = lane; i < d; i += 32) {
    yr[i] = from_float<T>(to_float(xr[i]) * r * to_float(g[i]));
  }
}

// one block per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_block_rows(const T* __restrict__ x, const T* __restrict__ g,
                       T* __restrict__ y, int d, float eps) {
  __shared__ float partial[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_float(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += partial[w];
  const float r = rsqrtf(total / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    yr[i] = from_float<T>(to_float(xr[i]) * r * to_float(g[i]));
  }
}

template <typename T>
int launch(const void* x, const void* g, void* y, long long rows, int d,
           float eps, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* yp = static_cast<T*>(y);
  if (d <= kWarpRowsMaxD) {
    const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rmsnorm_warp_rows<T><<<(unsigned)blocks, kThreads, 0, s>>>(xp, gp, yp, rows,
                                                               d, eps);
  } else {
    if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    rmsnorm_block_rows<T><<<(unsigned)rows, kThreads, 0, s>>>(xp, gp, yp, d, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success); nothing here
// synchronises.
extern "C" int rmsnorm_launch(const void* x, const void* g, void* y,
                              long long rows, int d, float eps, int dtype,
                              void* stream) {
  if (rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, g, y, rows, d, eps, s);
    case 1:
      return launch<__nv_bfloat16>(x, g, y, rows, d, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
