// Water-level kernel for Hopper (sm_90a): the fused water level of the
// paper's eqs. 7/9 plus the Alg. 2 allocation, one problem row per block.
//
// Replaces src/repro/kernels/waterlevel.py::_waterlevel_kernel, which the
// JAX package launches through _waterlevel_call_padded (one problem) and
// _waterlevel_call_padded_batch (a (B,) grid of independent rows).  One
// __global__ function covers both: the grid is one block per row.
//
// Contract (the same as the TPU kernel's): pre-masked int32 rows b, w of
// shape (B, n) with n a power of two in [128, 32768], pad and masked lanes
// carrying b = 2^30 and w = 0, and demand of shape (B,).  Outputs: level
// (B,), and take_sorted, idx_sorted (B, n), all int32.  Per row:
//   1. sort the lanes ascending by (busy, lane index);
//   2. inclusive prefix sums cw = sum w and cbw = sum b*w;
//   3. xi = ceil((T + cbw) / max(cw, 1)); the first lane with xi <= next b
//      and cw > 0 is selected (lane 0 when there is none);
//   4. level = max(xi0, b0 + 1);
//   5. take = clip(T - exclusive_prefix(caps), 0, caps),
//      caps = max(level - b, 0) * w.
// All arithmetic is int32 and wraps exactly as the reference's does.
//
// What bounds it on this card: one block holds a whole row, so the work
// runs on one SM.  Device memory moves only 16 B per lane (b, w in; take,
// idx out); the bitonic network's n/2 * log2(n) * (log2(n) + 1) / 2
// compare-exchanges on 12-byte lanes in shared memory dominate, so one
// SM's shared-memory bandwidth is the bound.
//
// What the design does about it: each lane is one 64-bit key (busy with
// its sign bit flipped in the high word, the lane index in the low word),
// so a compare-exchange is one 64-bit compare and the keys are unique,
// which makes any sorting network give exactly the stable argsort order;
// w rides beside the key.  Rows up to 16384 lanes (196,608 B) stay in
// dynamic shared memory; rows of 16385..32768 lanes run the same code on a
// global scratch buffer that the wrapper allocates and that stays in L2.
// Prefix sums are per-thread serial runs plus a warp-shuffle scan of the
// thread totals; int32 addition wraps associatively, so every scan order
// gives the same bits.  Making it fast (register-resident sort stages,
// fewer bank conflicts, the K-group loop inside one launch) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kMaxThreads = 1024;
constexpr int kMinLanes = 128;
constexpr int kMaxLanes = 1 << 15;
constexpr int kSmemMaxLanes = 1 << 14;
constexpr int kBytesPerLane = 12;  // 8 B key + 4 B w
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned long long pack_key(int b, int lane) {
  // flipping the sign bit maps signed order onto unsigned order
  return ((unsigned long long)((unsigned)b ^ 0x80000000u) << 32) |
         (unsigned long long)(unsigned)lane;
}

__device__ __forceinline__ int key_busy(unsigned long long key) {
  return (int)((unsigned)(key >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int key_lane(unsigned long long key) {
  return (int)(unsigned)(key & 0xffffffffull);
}

// int32 arithmetic that wraps like the reference's, without signed
// overflow in C++
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// ceil(a / d) for d >= 1; equals the reference's -(-a // d).  Written
// without a + d - 1, which overflows for a near 2^31.
__device__ __forceinline__ int ceil_div(int a, int d) {
  return a / d + ((a % d != 0) && (a > 0));
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
  __syncthreads();  // warp_sums is reused by the next scan
  return out;
}

__global__ void __launch_bounds__(kMaxThreads)
waterlevel_kernel(const int* __restrict__ b_in, const int* __restrict__ w_in,
                  const int* __restrict__ demand_in, int* __restrict__ level_out,
                  int* __restrict__ take_out, int* __restrict__ idx_out,
                  unsigned long long* scratch_keys, int* scratch_w, int n) {
  extern __shared__ unsigned long long smem_keys[];
  __shared__ unsigned warp_sums[32];
  __shared__ int s_first;
  __shared__ int s_xi;
  __shared__ int s_b;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t off = (size_t)row * n;

  unsigned long long* keys;
  int* ws;
  if (scratch_keys == nullptr) {
    keys = smem_keys;
    ws = reinterpret_cast<int*>(smem_keys + n);
  } else {
    keys = scratch_keys + off;
    ws = scratch_w + off;
  }

  for (int i = tid; i < n; i += nt) {
    keys[i] = pack_key(b_in[off + i], i);
    ws[i] = w_in[off + i];
  }
  if (tid == 0) s_first = n;
  __syncthreads();

  // 1. bitonic sort, ascending by (busy, lane)
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < half; i += nt) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const unsigned long long a = keys[lo];
        const unsigned long long c = keys[hi];
        const bool ascending = (lo & k) == 0;
        if ((a > c) == ascending) {
          keys[lo] = c;
          keys[hi] = a;
          const int t = ws[lo];
          ws[lo] = ws[hi];
          ws[hi] = t;
        }
      }
      __syncthreads();
    }
  }

  // 2. prefix sums over each thread's run of `per` consecutive lanes
  const int per = n / nt;
  const int base = tid * per;
  const int demand = demand_in[row];
  int run_w = 0;
  int run_bw = 0;
  for (int r = 0; r < per; ++r) {
    const int i = base + r;
    const int wi = ws[i];
    run_w = wadd(run_w, wi);
    run_bw = wadd(run_bw, wmul(key_busy(keys[i]), wi));
  }
  int cw = (int)block_exclusive_scan((unsigned)run_w, warp_sums);
  int cbw = (int)block_exclusive_scan((unsigned)run_bw, warp_sums);

  // 3. first valid segment: each thread finds the first in its run, then
  // a block-wide min
  int cand = n;
  int cand_xi = 0;
  int cand_b = 0;
  int xi_lane0 = 0;
  int b_lane0 = 0;
  for (int r = 0; r < per; ++r) {
    const int i = base + r;
    const int bi = key_busy(keys[i]);
    const int wi = ws[i];
    cw = wadd(cw, wi);
    cbw = wadd(cbw, wmul(bi, wi));
    const int xi = ceil_div(wadd(demand, cbw), cw > 1 ? cw : 1);
    const int next_b = i + 1 < n ? key_busy(keys[i + 1]) : kBig;
    if (i == 0) {
      xi_lane0 = xi;
      b_lane0 = bi;
    }
    if (cand == n && xi <= next_b && cw > 0) {
      cand = i;
      cand_xi = xi;
      cand_b = bi;
    }
  }
  if (cand < n) atomicMin(&s_first, cand);
  __syncthreads();
  const int first = s_first;
  if (first == n) {
    if (tid == 0) {  // nothing valid: lane 0, the reference's convention
      s_xi = xi_lane0;
      s_b = b_lane0;
    }
  } else if (cand == first) {
    s_xi = cand_xi;
    s_b = cand_b;
  }
  __syncthreads();

  // 4. the level
  const int b0_next = wadd(s_b, 1);
  const int level = s_xi > b0_next ? s_xi : b0_next;
  if (tid == 0) level_out[row] = level;

  // 5. allocation at the level: take = clip(T - exclusive caps prefix,
  // 0, caps), written over w in place
  int run_caps = 0;
  for (int r = 0; r < per; ++r) {
    const int i = base + r;
    const int gap = wsub(level, key_busy(keys[i]));
    run_caps = wadd(run_caps, wmul(gap > 0 ? gap : 0, ws[i]));
  }
  int prev = (int)block_exclusive_scan((unsigned)run_caps, warp_sums);
  for (int r = 0; r < per; ++r) {
    const int i = base + r;
    const int gap = wsub(level, key_busy(keys[i]));
    const int caps = wmul(gap > 0 ? gap : 0, ws[i]);
    int take = wsub(demand, prev);
    take = take > 0 ? take : 0;
    take = take < caps ? take : caps;
    ws[i] = take;
    prev = wadd(prev, caps);
  }
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    take_out[off + i] = ws[i];
    idx_out[off + i] = key_lane(keys[i]);
  }
}

}  // namespace

// Launch on `stream`.  `scratch` must hold batch * n_lanes * 12 bytes when
// n_lanes > 16384 and is ignored otherwise.  Returns cudaGetLastError()
// after the launch (0 on success); nothing here synchronises.
extern "C" int waterlevel_launch(const void* b, const void* w,
                                 const void* demand, void* level, void* take,
                                 void* idx, void* scratch, int batch,
                                 int n_lanes, void* stream) {
  if (batch < 1 || n_lanes < kMinLanes || n_lanes > kMaxLanes ||
      (n_lanes & (n_lanes - 1)) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int threads = n_lanes / 2 < kMaxThreads ? n_lanes / 2 : kMaxThreads;
  size_t smem = 0;
  unsigned long long* keys = nullptr;
  int* ws = nullptr;
  if (n_lanes <= kSmemMaxLanes) {
    static bool configured[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!configured[dev]) {
      err = cudaFuncSetAttribute(waterlevel_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMaxLanes * kBytesPerLane);
      if (err != cudaSuccess) return (int)err;
      configured[dev] = true;
    }
    smem = (size_t)n_lanes * kBytesPerLane;
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    keys = static_cast<unsigned long long*>(scratch);
    ws = reinterpret_cast<int*>(keys + (size_t)batch * n_lanes);
  }
  waterlevel_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(b), static_cast<const int*>(w),
      static_cast<const int*>(demand), static_cast<int*>(level),
      static_cast<int*>(take), static_cast<int*>(idx), keys, ws, n_lanes);
  return (int)cudaGetLastError();
}
