// RD strip kernel for Hopper (sm_90a): one strip of device
// Replica-Deletion — the lexicographic sort of the slot lanes by the
// deletion key and the bucket walk of their member counts against the
// strip's quota, in one thread block.
//
// Replaces src/repro/kernels/rd.py::_rd_strip_kernel, which the JAX
// package launches through _rd_strip_call (rd_strip_takes_pallas).
//
// Contract (the same as the TPU kernel's): keys int32 (R, C), rows
// most-significant first (masked -count with 2^30 for non-candidates,
// alt, the P packed holder words, group), R in [1, 24], C a power of two
// in [128, 16384]; size int32 (C,); quota int32, one element.  Outputs,
// both int32 (C,):
//   idx         the lanes sorted ascending by (key rows..., lane index):
//               keys are unique, so the order is total and equals the
//               stable lexsort that the plain version chains;
//   take_sorted clip(quota - prev, 0, s), s the sorted member counts
//               masked to candidates (row 0 != 2^30), prev their
//               exclusive prefix sum.
// All arithmetic is int32 and wraps exactly as the reference's does.
//
// What bounds it on this card: one block holds the whole strip, so the
// work runs on one SM.  Device memory moves (R + 1) * C * 4 B in and
// 8 * C B out; the bitonic network's C/2 * log2(C) * (log2(C) + 1) / 2
// compare-exchanges dominate, each reading two lane indices and, per key
// row until the first difference, two key words.  One SM's shared-memory
// bandwidth is the bound when the keys are staged there, L2 when not.
//
// What the design does about it: the network permutes a lane-index array
// in shared memory and never moves the (R, C) key block itself (a swap
// writes two 4-byte indices however many rows the key has); a compare
// reads the keys of the two lanes it holds, row by row, and stops at the
// first row that differs.  When (R + 2) * C * 4 B fit in the block's
// opt-in shared memory (the main path's R = 11, C = 4096 needs 212,992 B)
// the keys and sizes are staged there; otherwise they are read from
// global memory, which L2 (50 MB) holds.  The prefix sum is per-thread
// serial runs plus a warp-shuffle scan of the thread totals; int32
// addition wraps associatively, so every scan order gives the same bits.
// Making it fast (keys compressed to the candidates, the strip loop of
// _rd_core in one persistent launch) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kMaxThreads = 1024;
constexpr int kMinLanes = 128;
constexpr int kMaxLanes = 1 << 14;
constexpr int kMaxRows = 24;
constexpr int kStaticSmemMargin = 1024;  // warp_sums and the compiler's own
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// Exclusive prefix of one value per thread across the block (wrapping).
// Every thread of the block must call it; blockDim.x is a multiple of 32.
__device__ unsigned block_exclusive_scan(unsigned v, unsigned* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < n_warps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  const unsigned out = x - v + (warp > 0 ? warp_sums[warp - 1] : 0u);
  __syncthreads();
  return out;
}

// True when lane a's key is lexicographically greater than lane c's,
// the lane index breaking a tie on every row.
__device__ __forceinline__ bool key_greater(const int* kb, int rows, int n,
                                            int a, int c) {
  for (int r = 0; r < rows; ++r) {
    const int x = kb[r * n + a];
    const int y = kb[r * n + c];
    if (x != y) return x > y;
  }
  return a > c;
}

template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
rd_strip_kernel(const int* __restrict__ keys, const int* __restrict__ size_in,
                const int* __restrict__ quota_in, int* __restrict__ take_out,
                int* __restrict__ idx_out, int rows, int n) {
  extern __shared__ int smem[];
  __shared__ unsigned warp_sums[32];

  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  int* idx = smem;  // n lane indices, permuted by the network
  const int* kb = keys;
  const int* sz = size_in;
  if (kStaged) {
    int* ks = smem + n;  // rows * n key words, then n sizes
    const int total = rows * n;
    for (int i = tid; i < total; i += nt) ks[i] = keys[i];
    for (int i = tid; i < n; i += nt) ks[total + i] = size_in[i];
    kb = ks;
    sz = ks + total;
  }
  for (int i = tid; i < n; i += nt) idx[i] = i;
  __syncthreads();

  // 1. bitonic sort of the lane indices, ascending by (key rows, lane)
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < half; i += nt) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const int a = idx[lo];
        const int c = idx[hi];
        const bool ascending = (lo & k) == 0;
        if (key_greater(kb, rows, n, a, c) == ascending) {
          idx[lo] = c;
          idx[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // 2. masked member counts, exclusive prefix over each thread's run of
  // `per` consecutive sorted positions, then the quota clamp
  const int per = n / nt;
  const int base = tid * per;
  int run = 0;
  for (int r = 0; r < per; ++r) {
    const int lane = idx[base + r];
    run = wadd(run, kb[lane] != kBig ? sz[lane] : 0);
  }
  int prev = (int)block_exclusive_scan((unsigned)run, warp_sums);
  const int quota = quota_in[0];
  for (int r = 0; r < per; ++r) {
    const int i = base + r;
    const int lane = idx[i];
    const int s = kb[lane] != kBig ? sz[lane] : 0;
    int take = wsub(quota, prev);
    take = take > 0 ? take : 0;
    take = take < s ? take : s;
    take_out[i] = take;
    idx_out[i] = lane;
    prev = wadd(prev, s);
  }
}

struct DeviceConfig {
  bool configured = false;
  int smem_optin = 0;  // cudaDevAttrMaxSharedMemoryPerBlockOptin
};

}  // namespace

// Launch on `stream`.  Returns cudaGetLastError() after the launch (0 on
// success); nothing here synchronises.
extern "C" int rd_strip_launch(const void* keys, const void* size,
                               const void* quota, void* take, void* idx,
                               int rows, int n_lanes, void* stream) {
  if (rows < 1 || rows > kMaxRows || n_lanes < kMinLanes ||
      n_lanes > kMaxLanes || (n_lanes & (n_lanes - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  static DeviceConfig configs[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  DeviceConfig& cfg = configs[dev];
  if (!cfg.configured) {
    err = cudaDeviceGetAttribute(&cfg.smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    const int dyn = cfg.smem_optin - kStaticSmemMargin;
    err = cudaFuncSetAttribute(rd_strip_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(rd_strip_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return (int)err;
    cfg.configured = true;
  }
  const int threads = n_lanes / 2 < kMaxThreads ? n_lanes / 2 : kMaxThreads;
  const size_t staged = (size_t)(rows + 2) * n_lanes * sizeof(int);
  const size_t budget = (size_t)(cfg.smem_optin - kStaticSmemMargin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* k = static_cast<const int*>(keys);
  const int* sz = static_cast<const int*>(size);
  const int* q = static_cast<const int*>(quota);
  int* t = static_cast<int*>(take);
  int* ix = static_cast<int*>(idx);
  if (staged <= budget) {
    rd_strip_kernel<true><<<1, threads, staged, s>>>(k, sz, q, t, ix, rows,
                                                      n_lanes);
  } else {
    rd_strip_kernel<false><<<1, threads, (size_t)n_lanes * sizeof(int), s>>>(
        k, sz, q, t, ix, rows, n_lanes);
  }
  return (int)cudaGetLastError();
}
