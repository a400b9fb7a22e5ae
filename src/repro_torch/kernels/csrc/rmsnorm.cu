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
// bounds it (2 * rows * d * sizeof(T) bytes + g): 25.0 µs at the dense
// prefill's 8192 x 2560 bf16 rows over 3.35 TB/s.
//
// What the design does about it (the vector route): one warp a row, eight
// rows to a block, each lane holding its share of the row in registers as
// 16-byte vectors (8 bf16 or 4 fp32: 320 vectors at d 2560 bf16, 10 a
// lane), so x is read from device memory once, in 16-byte accesses with
// neighbouring lanes on neighbouring addresses, and every load of a row
// is in flight before the warp-shuffle sum of squares.  g is copied into
// shared memory once per block (after the block's first loads are
// issued), and each block walks its rows with a grid stride.  Fewer rows
// than SMs' worth of such blocks (decode: 8 rows) take one block of 256
// threads a row instead, each thread holding up to 3 vectors and reading
// its g vectors directly, so the row's loads spread over as many SMs as
// there are rows.  Rows whose
// start or g is not 16-byte aligned, whose width is not a multiple of the
// vector, or wider than 20 vectors a lane (bf16 d > 5120, fp32 d > 2560)
// take the scalar route in this file: one warp a row for d <= 1024, one
// block of 256 threads a row past that, two passes over x (the second
// from L1 and L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRowsMaxD = 1024;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxDevices = 64;

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

// 16-byte vectors: unpack to fp32, pack (round to nearest even) back
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static unsigned pack2(float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

// one warp per row, the row in registers as NV 16-byte vectors a lane;
// g (d / kN vectors) in dynamic shared memory
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_vec_rows(const T* __restrict__ x, const T* __restrict__ g,
                     T* __restrict__ y, long long rows, int d, float eps) {
  extern __shared__ uint4 g_s[];
  constexpr int kN = Vec16<T>::kN;
  const int lane = threadIdx.x & 31;
  const int dv = d / kN;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  const long long stride = (long long)gridDim.x * kRowsPerBlock;
  long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  uint4 buf[NV];
  if (row < rows) {
    const uint4* xr = xv + row * dv;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = lane + 32 * k;
      if (i < dv) buf[k] = xr[i];
    }
  }
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  for (int i = threadIdx.x; i < dv; i += kThreads) g_s[i] = gv[i];
  __syncthreads();
  for (bool first = true; row < rows; row += stride, first = false) {
    if (!first) {
      const uint4* xr = xv + row * dv;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int i = lane + 32 * k;
        if (i < dv) buf[k] = xr[i];
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (lane + 32 * k < dv) {
        float f[kN];
        Vec16<T>::unpack(buf[k], f);
#pragma unroll
        for (int e = 0; e < kN; ++e) ss += f[e] * f[e];
      }
    }
    ss = warp_sum(ss);
    const float r = rsqrtf(ss / (float)d + eps);
    uint4* yr = yv + row * dv;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = lane + 32 * k;
      if (i < dv) {
        float f[kN], w[kN];
        Vec16<T>::unpack(buf[k], f);
        Vec16<T>::unpack(g_s[i], w);
#pragma unroll
        for (int e = 0; e < kN; ++e) f[e] = f[e] * r * w[e];
        yr[i] = Vec16<T>::pack(f);
      }
    }
  }
}

// one block per row for few rows (decode): each of the block's threads
// holds NB 16-byte vectors of the row and reads its g vectors directly,
// so a row's loads all go out at once, spread over as many SMs as rows
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_vec_block(const T* __restrict__ x, const T* __restrict__ g,
                      T* __restrict__ y, int d, float eps) {
  __shared__ float partial[kThreads / 32];
  constexpr int kN = Vec16<T>::kN;
  const int dv = d / kN;
  const long long row = blockIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + row * dv;
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  uint4* yv = reinterpret_cast<uint4*>(y) + row * dv;
  uint4 buf[NB], gbuf[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int i = threadIdx.x + kThreads * k;
    if (i < dv) {
      buf[k] = xv[i];
      gbuf[k] = gv[i];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (threadIdx.x + kThreads * k < dv) {
      float f[kN];
      Vec16<T>::unpack(buf[k], f);
#pragma unroll
      for (int e = 0; e < kN; ++e) ss += f[e] * f[e];
    }
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += partial[w];
  const float r = rsqrtf(total / (float)d + eps);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int i = threadIdx.x + kThreads * k;
    if (i < dv) {
      float f[kN], w[kN];
      Vec16<T>::unpack(buf[k], f);
      Vec16<T>::unpack(gbuf[k], w);
#pragma unroll
      for (int e = 0; e < kN; ++e) f[e] = f[e] * r * w[e];
      yv[i] = Vec16<T>::pack(f);
    }
  }
}

int sm_count() {
  static int counts[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      return 132;
    }
    counts[dev] = n;
  }
  return counts[dev];
}

template <typename T, int NV>
void launch_vec(const T* x, const T* g, T* y, long long rows, int d, float eps,
                cudaStream_t s) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks < sm_count()) {  // few rows: a block a row, over more SMs
    const int nb = (d / Vec16<T>::kN + kThreads - 1) / kThreads;
    if (nb == 1) {
      rmsnorm_vec_block<T, 1><<<(unsigned)rows, kThreads, 0, s>>>(x, g, y, d, eps);
    } else if (nb == 2) {
      rmsnorm_vec_block<T, 2><<<(unsigned)rows, kThreads, 0, s>>>(x, g, y, d, eps);
    } else {
      rmsnorm_vec_block<T, 3><<<(unsigned)rows, kThreads, 0, s>>>(x, g, y, d, eps);
    }
    return;
  }
  const long long cap = 8LL * sm_count();
  const unsigned grid = (unsigned)(blocks < cap ? blocks : cap);
  const size_t smem = (size_t)(d / Vec16<T>::kN) * sizeof(uint4);
  rmsnorm_vec_rows<T, NV><<<grid, kThreads, smem, s>>>(x, g, y, rows, d, eps);
}

// the vector route's lanes: the fewest vectors a lane among the compiled
// counts that hold the row, or 0 when the row takes the scalar route
int vec_per_lane(const void* x, const void* g, const void* y, int d, int elt) {
  const int n = 16 / elt;
  const uintptr_t any = (uintptr_t)x | (uintptr_t)g | (uintptr_t)y;
  if ((any & 15) != 0 || d % n != 0) return 0;
  const int need = (d / n + 31) / 32;
  const int counts[] = {1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20};
  for (int c : counts) {
    if (need <= c) return c;
  }
  return 0;
}

template <typename T>
int launch(const void* x, const void* g, void* y, long long rows, int d,
           float eps, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* yp = static_cast<T*>(y);
  switch (vec_per_lane(x, g, y, d, (int)sizeof(T))) {
#define RMSNORM_VEC_CASE(NV)                           \
  case NV:                                             \
    launch_vec<T, NV>(xp, gp, yp, rows, d, eps, s);    \
    return (int)cudaGetLastError();
    RMSNORM_VEC_CASE(1)
    RMSNORM_VEC_CASE(2)
    RMSNORM_VEC_CASE(3)
    RMSNORM_VEC_CASE(4)
    RMSNORM_VEC_CASE(5)
    RMSNORM_VEC_CASE(6)
    RMSNORM_VEC_CASE(8)
    RMSNORM_VEC_CASE(10)
    RMSNORM_VEC_CASE(12)
    RMSNORM_VEC_CASE(16)
    RMSNORM_VEC_CASE(20)
#undef RMSNORM_VEC_CASE
    default:
      break;
  }
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

// dtype: 0 = float32, 1 = bfloat16.  Takes the vector route where
// vec_per_lane allows it, else the scalar route.  Launches on `stream` and returns
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
