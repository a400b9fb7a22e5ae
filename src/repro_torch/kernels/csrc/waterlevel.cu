// Water-level kernels for Hopper (sm_90a): the fused water level of the
// paper's eqs. 7/9 plus the Alg. 2 allocation.
//
// Replaces src/repro/kernels/waterlevel.py::_waterlevel_kernel, which the
// JAX package launches through _waterlevel_call_padded (one problem) and
// _waterlevel_call_padded_batch (a (B,) grid of independent rows).  Two
// __global__ functions share one row step here:
//
// - waterlevel_kernel (K1/K2): the TPU kernel's contract.  Pre-masked
//   int32 rows b, w of shape (B, n), n a power of two in [128, 32768], pad
//   and masked lanes carrying b = 2^30 and w = 0, demand (B,).  Outputs:
//   level (B,), take_sorted and idx_sorted (B, n).  One block per row.
// - wf_fused_kernel: the water-filling loops of core/wf_torch.py in one
//   launch.  Raw busy / mu rows, (K, M) bool masks and (K,) demands per
//   problem; each block carries the K-group scan (eq. 10 raises between
//   groups) and, in chain mode, admits B jobs in series with eq. 2
//   (b += ceil(load / mu) where load > 0) committed between jobs.  It
//   writes every group's allocation in lane order, its level (the minimum
//   available busy where demand <= 0), and Phi per job.
//
// One row step, per group:
//   1. the lanes in ascending (busy, lane) order;
//   2. inclusive prefix sums cw = sum w and cbw = sum b*w;
//   3. xi = ceil((T + cbw) / max(cw, 1)); the first lane with xi <= next b
//      and cw > 0 is selected (lane 0 when there is none);
//   4. level = max(xi0, b0 + 1);
//   5. take = clip(T - exclusive_prefix(caps), 0, caps),
//      caps = max(level - b, 0) * w.
// All arithmetic is int32 and wraps exactly as the reference's does.
//
// The order rule that keeps the sort small: every lane whose busy equals
// 2^30 (BIG) ties on busy, so in (busy, lane) order those lanes form one
// contiguous run that is already in lane order.  Lanes below BIG come
// before the run, lanes above it (levels raised past BIG by eq. 10) after
// it.  So only the lanes whose busy is not BIG are sorted: one block scan
// gives each lane its final slot (below-BIG and above-BIG lanes packed at
// the two ends, BIG lanes at n_lo + their rank among BIG lanes), then the
// two end segments are sorted in place: up to 32 lanes by one warp in
// registers, more by a bitonic network over the next power of two of the
// segment, every compare-exchange ascending so that the virtual lanes past
// the segment (+inf) never move.  This holds for every input.  A task
// group of the scheduler's traces is available on 8-12 of 4096 servers,
// so the sort that took 78 barrier stages over 4096 lanes becomes a
// 15-stage warp sort of about 10 registers.
//
// What bounds it on this card: device memory moves 16 B per lane (K1) or
// the masks plus 4 B per lane of alloc (fused); what is left is a chain of
// block-wide scans and barriers on one SM per row, so latency, not bytes,
// bounds both.  The fused kernel removes the host round of ~15 PyTorch
// ops per group step and one launch per group; a group with at most 32
// live lanes, none above BIG and no available lane at BIG with capacity
// (the scheduler's usual group) takes a step done by one warp after one
// block scan: the BIG run's prefix sums stay where the live lanes left
// them, so its positions add nothing to find (6 barriers a step, against
// about 15 for the full-row step).
//
// Memory: a block's threads and dynamic shared memory come from the
// wrapper (launch_config in kernels/waterlevel.py, which the kernel
// contracts read too); the launchers check them against the layout
// below.  A row's sorted keys (8 B) and w (4 B) live in dynamic shared
// memory up to 16384 lanes for K1; the fused kernel adds the busy vector
// being raised, the committed busy vector and the chain's loads, in
// shared memory up to 8192 lanes.  Wider rows run the same code on a
// global scratch buffer that the wrapper allocates and that stays in L2.
// Each thread owns PER consecutive lanes (a compile-time count, so its
// loads are in flight together); the arrays are padded one word in 16
// keys / 32 ints so that neighbouring threads hit distinct banks.  Prefix
// sums are per-thread serial runs plus a warp-shuffle scan of the thread
// totals; int32 addition wraps associatively, so every scan order gives
// the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
constexpr int kMaxThreads = 1024;
constexpr int kMinLanes = 128;
constexpr int kMaxLanes = 1 << 15;
constexpr int kSmemMaxLanes = 1 << 14;       // K1: keys + w
constexpr int kFusedSmemMaxLanes = 1 << 13;  // fused: + work, commit, loads
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

constexpr int kFastLanes = 32;  // live lanes one warp takes on its own

struct RowShared {
  uint2 sums[32];  // per-warp scan totals
  uint2 total;
  int first;
  int xi;
  int b;
  // the fused kernel's one-warp step: the live lanes in lane order, their
  // takes by the same rank, the level and the smallest live busy
  unsigned long long fk[kFastLanes];
  int fw[kFastLanes];
  int ft[kFastLanes];
  int level;
  int b_first;
};

// Exclusive prefix of two values per thread across the block (wrapping),
// and their block totals in sh.total.  Every thread must call it;
// blockDim.x is a multiple of 32.
__device__ uint2 block_exclusive_scan2(uint2 v, RowShared& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  uint2 x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned yx = __shfl_up_sync(0xffffffffu, x.x, o);
    const unsigned yy = __shfl_up_sync(0xffffffffu, x.y, o);
    if (lane >= o) {
      x.x += yx;
      x.y += yy;
    }
  }
  if (lane == 31) sh.sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint2 s = lane < n_warps ? sh.sums[lane] : make_uint2(0u, 0u);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned yx = __shfl_up_sync(0xffffffffu, s.x, o);
      const unsigned yy = __shfl_up_sync(0xffffffffu, s.y, o);
      if (lane >= o) {
        s.x += yx;
        s.y += yy;
      }
    }
    if (lane < n_warps) sh.sums[lane] = s;
    if (lane == n_warps - 1) sh.total = s;
  }
  __syncthreads();
  uint2 out = make_uint2(x.x - v.x, x.y - v.y);
  if (warp > 0) {
    out.x += sh.sums[warp - 1].x;
    out.y += sh.sums[warp - 1].y;
  }
  __syncthreads();  // sums is reused by the next scan
  return out;
}

// Pre-masked rows (K1's contract).
struct MaskedRow {
  const int* b;
  const int* w;
  __device__ __forceinline__ void operator()(int i, int& bi, int& wi) const {
    bi = b[i];
    wi = w[i];
  }
};

// A busy vector (padded like the lane arrays) masked by one group's row;
// lanes past m are pad lanes.
struct GroupRow {
  const int* busy;
  const int* mu;
  const unsigned char* mask;
  int m;
  __device__ __forceinline__ void operator()(int i, int& bi, int& wi) const {
    // the three loads depend on i alone, so an unrolled loop issues them
    // together; the mask only selects
    const bool real = i < m;
    const int on = real ? mask[i] : 0;
    const int b = real ? busy[i + (i >> 5)] : kBig;  // lane_int's padding
    const int w = real ? mu[i] : 0;
    bi = on ? b : kBig;
    wi = on ? w : 0;
  }
};

// A row's lanes in (busy, lane) order: the 64-bit keys and the w beside
// them, each array padded by one word every 16 keys / 32 ints so that a
// thread owning PER consecutive lanes and its warp's neighbours touch
// distinct banks (unpadded, PER = 4 is a 4-way and PER = 16 a 32-way
// conflict on every access).
__host__ __device__ constexpr int key_slots(int n) { return n + (n >> 4); }
__host__ __device__ constexpr int int_slots(int n) { return n + (n >> 5); }

struct Lanes {
  unsigned long long* k;
  int* w;
  __device__ __forceinline__ unsigned long long& key(int i) const { return k[i + (i >> 4)]; }
  __device__ __forceinline__ int& wt(int i) const { return w[i + (i >> 5)]; }
};

// Per-lane int vectors of the fused kernel (lane order), padded alike.
__device__ __forceinline__ int& lane_int(int* v, int i) { return v[i + (i >> 5)]; }

// Ascending compare-exchange of one warp lane with lane ^ mask; w and
// rank ride with the key.
__device__ __forceinline__ void warp_cx(unsigned long long& k, int& w, int& rank, int l,
                                        int mask) {
  const unsigned long long ok = __shfl_xor_sync(0xffffffffu, k, mask);
  const int ow = __shfl_xor_sync(0xffffffffu, w, mask);
  const int orank = __shfl_xor_sync(0xffffffffu, rank, mask);
  const bool lower = l < (l ^ mask);
  if (lower ? ok < k : ok > k) {
    k = ok;
    w = ow;
    rank = orank;
  }
}

__device__ __forceinline__ void smem_cx(const Lanes& L, int lo, int hi) {
  const unsigned long long a = L.key(lo);
  const unsigned long long c = L.key(hi);
  if (a > c) {
    L.key(lo) = c;
    L.key(hi) = a;
    const int t = L.wt(lo);
    L.wt(lo) = L.wt(hi);
    L.wt(hi) = t;
  }
}

// Sort positions [start, start + len) ascending by key, w beside them.
// Block-uniform len; every thread calls it.  Keys are unique, so the
// result is the stable argsort order.  Bitonic sort in the form whose
// every compare-exchange puts the smaller key at the lower index (a flip
// stage, then half-cleaners): the virtual +inf lanes in [len, next pow2)
// never move, so pairs that reach them are skipped.
__device__ void sort_segment(const Lanes& L, int start, int len) {
  if (len <= 1) return;
  if (len <= 32) {
    if (threadIdx.x < 32) {
      const int l = threadIdx.x;
      unsigned long long k = l < len ? L.key(start + l) : ~0ull;
      int w = l < len ? L.wt(start + l) : 0;
      int rank = 0;  // unused here
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
        warp_cx(k, w, rank, l, size - 1);
#pragma unroll
        for (int j = size >> 2; j > 0; j >>= 1) warp_cx(k, w, rank, l, j);
      }
      if (l < len) {
        L.key(start + l) = k;
        L.wt(start + l) = w;
      }
    }
    __syncthreads();
    return;
  }
  int p = 64;
  while (p < len) p <<= 1;
  const int half = p >> 1;
  for (int size = 2; size <= p; size <<= 1) {
    const int hs = size >> 1;
    for (int t = threadIdx.x; t < half; t += blockDim.x) {
      const int r = t & (hs - 1);
      const int lo = ((t - r) << 1) + r;
      const int hi = ((t - r) << 1) + size - 1 - r;
      if (hi < len) smem_cx(L, start + lo, start + hi);
    }
    __syncthreads();
    for (int j = hs >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo + j;
        if (hi < len) smem_cx(L, start + lo, start + hi);
      }
      __syncthreads();
    }
  }
}

// Step 1: the row's n lanes in ascending (busy, lane) order.  Returns the
// number of lanes above BIG (they sit at the end).
template <int PER, class Row>
__device__ int place_lanes(const Row& row, const Lanes& L, int n, RowShared& sh) {
  const int base = threadIdx.x * PER;
  int bv[PER], wv[PER];
  unsigned lo = 0, hi = 0;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    row(base + r, bv[r], wv[r]);
    lo += bv[r] < kBig;
    hi += bv[r] > kBig;
  }
  const uint2 before = block_exclusive_scan2(make_uint2(lo, hi), sh);
  const int n_lo = (int)sh.total.x;
  const int n_hi = (int)sh.total.y;
  int lo_i = (int)before.x;
  int hi_i = (int)before.y;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int i = base + r;
    int pos;
    if (bv[r] < kBig) {
      pos = lo_i++;
    } else if (bv[r] > kBig) {
      pos = n - n_hi + hi_i++;
    } else {  // the BIG run, in lane order: n_lo + the BIG lanes before i
      pos = n_lo + (i - lo_i - hi_i);
    }
    L.key(pos) = pack_key(bv[r], i);
    L.wt(pos) = wv[r];
  }
  __syncthreads();
  sort_segment(L, 0, n_lo);
  sort_segment(L, n - n_hi, n_hi);
  return n_hi;
}

// Steps 2-5 on the sorted row; returns the level and writes each lane's
// take over its w.  Each thread holds its PER positions in registers
// throughout.  Ends with a barrier.
template <int PER>
__device__ int level_and_takes(const Lanes& L, int n, int demand, RowShared& sh) {
  const int base = threadIdx.x * PER;
  if (threadIdx.x == 0) sh.first = n;
  int bv[PER], wv[PER];
  int run_w = 0;
  int run_bw = 0;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    bv[r] = key_busy(L.key(base + r));
    wv[r] = L.wt(base + r);
    run_w = wadd(run_w, wv[r]);
    run_bw = wadd(run_bw, wmul(bv[r], wv[r]));
  }
  const int b_after = base + PER < n ? key_busy(L.key(base + PER)) : kBig;
  const uint2 ex = block_exclusive_scan2(make_uint2((unsigned)run_w, (unsigned)run_bw), sh);
  int cw = (int)ex.x;
  int cbw = (int)ex.y;

  // first valid segment: each thread finds the first in its run, then a
  // block-wide min
  int cand = n;
  int cand_xi = 0;
  int cand_b = 0;
  int xi_lane0 = 0;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    cw = wadd(cw, wv[r]);
    cbw = wadd(cbw, wmul(bv[r], wv[r]));
    const int xi = ceil_div(wadd(demand, cbw), cw > 1 ? cw : 1);
    const int next_b = r + 1 < PER ? bv[r + 1] : b_after;
    if (r == 0) xi_lane0 = xi;
    if (cand == n && xi <= next_b && cw > 0) {
      cand = base + r;
      cand_xi = xi;
      cand_b = bv[r];
    }
  }
  if (cand < n) atomicMin(&sh.first, cand);
  __syncthreads();
  const int first = sh.first;
  if (first == n) {
    if (threadIdx.x == 0) {  // nothing valid: lane 0, the reference's convention
      sh.xi = xi_lane0;
      sh.b = bv[0];
    }
  } else if (cand == first) {
    sh.xi = cand_xi;
    sh.b = cand_b;
  }
  __syncthreads();
  const int b0_next = wadd(sh.b, 1);
  const int level = sh.xi > b0_next ? sh.xi : b0_next;

  // allocation at the level: take = clip(T - exclusive caps prefix, 0, caps)
  int caps[PER];
  int run_caps = 0;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int gap = wsub(level, bv[r]);
    caps[r] = wmul(gap > 0 ? gap : 0, wv[r]);
    run_caps = wadd(run_caps, caps[r]);
  }
  int prev = (int)block_exclusive_scan2(make_uint2((unsigned)run_caps, 0u), sh).x;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    int take = wsub(demand, prev);
    take = take > 0 ? take : 0;
    take = take < caps[r] ? take : caps[r];
    L.wt(base + r) = take;
    prev = wadd(prev, caps[r]);
  }
  __syncthreads();
  return level;
}

// Steps 1-5 by warp 0 alone for a row whose only lanes not at BIG are
// the `len` <= 32 lanes below it in sh.fk / sh.fw (lane order), every BIG
// lane carrying w = 0.  In (busy, lane) order the row is those lanes
// sorted, then the BIG run, whose prefix sums stay where the live lanes
// left them: a run position is valid only if the last live position is,
// so the first valid position is a live one or none (then position 0, a
// BIG lane with cw = 0 when len = 0).  Leaves the takes by rank in sh.ft,
// the level in sh.level and the smallest live busy (BIG if none) in
// sh.b_first.  The same bits as level_and_takes on the full row.
__device__ void warp_level(RowShared& sh, int len, int demand) {
  const int l = threadIdx.x;
  unsigned long long k = l < len ? sh.fk[l] : ~0ull;
  int w = l < len ? sh.fw[l] : 0;
  int rank = l;  // the lane-order rank rides with its key
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    warp_cx(k, w, rank, l, size - 1);
#pragma unroll
    for (int j = size >> 2; j > 0; j >>= 1) warp_cx(k, w, rank, l, j);
  }
  const bool live = l < len;
  const int b = live ? key_busy(k) : kBig;
  int cw = w;
  int cbw = wmul(b, w);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ycw = __shfl_up_sync(0xffffffffu, cw, o);
    const int ycbw = __shfl_up_sync(0xffffffffu, cbw, o);
    if (l >= o) {
      cw = wadd(cw, ycw);
      cbw = wadd(cbw, ycbw);
    }
  }
  const int xi = ceil_div(wadd(demand, cbw), cw > 1 ? cw : 1);
  const int nb = __shfl_down_sync(0xffffffffu, b, 1);
  const int next_b = l + 1 < len ? nb : kBig;
  const unsigned valid = __ballot_sync(0xffffffffu, live && xi <= next_b && cw > 0);
  // nothing valid: position 0, a BIG lane with cw = cbw = 0 (xi = T) when
  // there is no live lane, which lane 0 of the warp already holds
  const int first = valid ? __ffs(valid) - 1 : 0;
  const int xi_sel = __shfl_sync(0xffffffffu, xi, first);
  const int b_sel = __shfl_sync(0xffffffffu, b, first);
  const int b0_next = wadd(b_sel, 1);
  const int level = xi_sel > b0_next ? xi_sel : b0_next;
  const int gap = wsub(level, b);
  const int caps = live ? wmul(gap > 0 ? gap : 0, w) : 0;
  int prev = caps;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, prev, o);
    if (l >= o) prev = wadd(prev, y);
  }
  prev = wsub(prev, caps);
  int take = wsub(demand, prev);
  take = take > 0 ? take : 0;
  take = take < caps ? take : caps;
  if (live) sh.ft[rank] = take;
  if (l == 0) {
    sh.level = level;
    sh.b_first = b;
  }
}

// Bytes of one row's buffers: K1's keys and w; the fused kernel's also
// the raised, committed and load vectors.
__host__ __device__ constexpr size_t row_bytes(int n, bool fused) {
  return 8 * (size_t)key_slots(n) + 4 * (size_t)int_slots(n) * (fused ? 4 : 1);
}

__device__ __forceinline__ Lanes row_lanes(unsigned char* base, int n) {
  unsigned long long* k = reinterpret_cast<unsigned long long*>(base);
  return Lanes{k, reinterpret_cast<int*>(k + key_slots(n))};
}

template <int PER>
__global__ void __launch_bounds__(kMaxThreads)
waterlevel_kernel(const int* __restrict__ b_in, const int* __restrict__ w_in,
                  const int* __restrict__ demand_in, int* __restrict__ level_out,
                  int* __restrict__ take_out, int* __restrict__ idx_out,
                  unsigned char* scratch, int n) {
  extern __shared__ unsigned long long smem_keys[];
  __shared__ RowShared sh;
  const int row = blockIdx.x;
  const size_t off = (size_t)row * n;
  unsigned char* base = scratch == nullptr
                            ? reinterpret_cast<unsigned char*>(smem_keys)
                            : scratch + (size_t)row * row_bytes(n, false);
  const Lanes L = row_lanes(base, n);
  place_lanes<PER>(MaskedRow{b_in + off, w_in + off}, L, n, sh);
  const int level = level_and_takes<PER>(L, n, demand_in[row], sh);
  if (threadIdx.x == 0) level_out[row] = level;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    take_out[off + i] = L.wt(i);
    idx_out[off + i] = key_lane(L.key(i));
  }
}

// Groups mode (chain == 0): block r solves problem r (jobs == 1), busy row
// r.  Chain mode (chain == 1): one block admits `jobs` problems in series
// from one busy vector and writes the busy vector after the burst.
template <int PER>
__global__ void __launch_bounds__(kMaxThreads)
wf_fused_kernel(const int* __restrict__ busy_in, const int* __restrict__ mu,
                const unsigned char* __restrict__ masks, const int* __restrict__ demands,
                int* __restrict__ alloc, int* __restrict__ levels, int* __restrict__ phi_out,
                int* __restrict__ busy_out, unsigned char* scratch, int m, int n,
                int k_groups, int jobs, int chain) {
  extern __shared__ unsigned long long smem_keys[];
  __shared__ RowShared sh;
  unsigned char* base = scratch == nullptr
                            ? reinterpret_cast<unsigned char*>(smem_keys)
                            : scratch + (size_t)blockIdx.x * row_bytes(n, true);
  const Lanes L = row_lanes(base, n);
  int* work = L.w + int_slots(n);       // busy, raised group by group (eq. 10)
  int* commit = work + int_slots(n);    // chain: busy with eq. 2 committed
  int* loads = commit + int_slots(n);   // chain: the job's load per server
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  if (chain) {
    for (int i = tid; i < m; i += nt) lane_int(commit, i) = busy_in[i];
  }
  for (int j = 0; j < jobs; ++j) {
    const int g = chain ? j : blockIdx.x;
    const int* mu_g = mu + (size_t)g * m;
    const unsigned char* masks_g = masks + (size_t)g * k_groups * m;
    for (int i = tid; i < m; i += nt) {
      lane_int(work, i) = chain ? lane_int(commit, i) : busy_in[(size_t)g * m + i];
      if (chain) lane_int(loads, i) = 0;
    }
    __syncthreads();
    int phi = 0;
    for (int k = 0; k < k_groups; ++k) {
      const unsigned char* mask = masks_g + (size_t)k * m;
      const int d = demands[(size_t)g * k_groups + k];
      int* alloc_k = alloc + ((size_t)g * k_groups + k) * m;
      // classify this thread's lanes: below BIG, above BIG, at BIG with
      // w != 0 (counted in the high half of y)
      const int base = tid * PER;
      int bv[PER], wv[PER];
      unsigned on_bits = 0, lo = 0, hi = 0;
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        const int i = base + r;
        const bool real = i < m;
        const int on = real ? mask[i] : 0;
        const int bb = real ? lane_int(work, i) : kBig;
        const int ww = real ? mu_g[i] : 0;
        bv[r] = on ? bb : kBig;
        wv[r] = on ? ww : 0;
        on_bits |= (on != 0 ? 1u : 0u) << r;
        lo += bv[r] < kBig;
        hi += (bv[r] > kBig) + ((bv[r] == kBig && wv[r] != 0) << 16);
      }
      const uint2 before = block_exclusive_scan2(make_uint2(lo, hi), sh);
      const int n_lo = (int)sh.total.x;
      const bool fast = n_lo <= kFastLanes && sh.total.y == 0u;
      int lvl;
      if (fast) {  // one warp does steps 1-5 on the live lanes
        int rank = (int)before.x;
#pragma unroll
        for (int r = 0; r < PER; ++r) {
          if (bv[r] < kBig) {
            sh.fk[rank] = pack_key(bv[r], base + r);
            sh.fw[rank] = wv[r];
            ++rank;
          }
        }
        __syncthreads();
        if (tid < 32) warp_level(sh, n_lo, d);
        __syncthreads();
        lvl = d > 0 ? sh.level : sh.b_first;
        rank = (int)before.x;
#pragma unroll
        for (int r = 0; r < PER; ++r) {
          const int i = base + r;
          if (i < m) {
            const int take = bv[r] < kBig ? sh.ft[rank++] : 0;
            alloc_k[i] = take;
            if (chain) lane_int(loads, i) = wadd(lane_int(loads, i), take);
            if (d > 0 && ((on_bits >> r) & 1u) && lane_int(work, i) < lvl) {
              lane_int(work, i) = lvl;  // eq. 10
            }
          }
        }
      } else {
        const int n_hi = place_lanes<PER>(GroupRow{work, mu_g, mask, m}, L, n, sh);
        const int level = level_and_takes<PER>(L, n, d, sh);
        // demand <= 0: the minimum available busy over the m real lanes.  A
        // pad lane (BIG, the highest lane indices) comes first only when
        // every real lane lies above BIG, at the start of the top segment.
        lvl = level;
        if (d <= 0) {
          const unsigned long long k0 = key_lane(L.key(0)) < m ? L.key(0) : L.key(n - n_hi);
          lvl = key_busy(k0);
        }
#pragma unroll
        for (int r = 0; r < PER; ++r) {
          const int pos = tid + r * nt;
          const int lane = key_lane(L.key(pos));
          if (lane < m) {
            const int take = L.wt(pos);
            alloc_k[lane] = take;
            if (chain) lane_int(loads, lane) = wadd(lane_int(loads, lane), take);
          }
        }
        if (d > 0) {  // eq. 10: the group's servers rise to its level
#pragma unroll
          for (int r = 0; r < PER; ++r) {
            const int i = base + r;
            if (i < m && ((on_bits >> r) & 1u) && lane_int(work, i) < lvl) {
              lane_int(work, i) = lvl;
            }
          }
        }
      }
      if (tid == 0) {
        levels[(size_t)g * k_groups + k] = lvl;
        const int contrib = d > 0 ? lvl : 0;
        phi = k == 0 || contrib > phi ? contrib : phi;
      }
      __syncthreads();
    }
    if (tid == 0) phi_out[g] = phi;
    if (chain) {  // eq. 2: b += ceil(load / mu) where load > 0
      for (int i = tid; i < m; i += nt) {
        const int ld = lane_int(loads, i);
        if (ld > 0) {
          const int mi = mu_g[i] > 1 ? mu_g[i] : 1;
          lane_int(commit, i) = wadd(lane_int(commit, i), ceil_div(ld, mi));
        }
      }
      __syncthreads();
    }
  }
  if (chain) {
    for (int i = tid; i < m; i += nt) busy_out[i] = lane_int(commit, i);
  }
}

// Raise the kernel's dynamic shared-memory ceiling to `bytes` on the
// current device, where it is lower.
template <typename Kernel>
cudaError_t configure_smem(Kernel kernel, size_t* configured, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (configured[dev] < bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    configured[dev] = bytes;
  }
  return cudaSuccess;
}

bool valid_width(int n) {
  return n >= kMinLanes && n <= kMaxLanes && (n & (n - 1)) == 0;
}

// The block the wrapper passes (kernels/waterlevel.py launch_config): a
// whole number of warps, at most kMaxThreads, each thread owning a
// power of two of 2-32 consecutive lanes.
bool valid_block(int n, int threads) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || n % threads != 0) {
    return false;
  }
  const int per = n / threads;
  return per >= 2 && per <= 32 && (per & (per - 1)) == 0;
}

// Shared memory as the wrapper passes it: the row buffers, at least
// row_bytes(n, fused), up to the kernel's shared-memory width; 0 above
// it, where the rows run on the scratch.
cudaError_t check_smem(size_t smem, int n, bool fused, const void* scratch) {
  const int cap = fused ? kFusedSmemMaxLanes : kSmemMaxLanes;
  if (n <= cap) return smem >= row_bytes(n, fused) ? cudaSuccess : cudaErrorInvalidValue;
  return smem == 0 && scratch != nullptr ? cudaSuccess : cudaErrorInvalidValue;
}

template <int PER>
int launch_waterlevel(const int* b, const int* w, const int* demand, int* level, int* take,
                      int* idx, void* scratch, int batch, int n, size_t smem,
                      cudaStream_t st) {
  cudaError_t err = check_smem(smem, n, false, scratch);
  if (err != cudaSuccess) return (int)err;
  if (smem > 0) {
    static size_t configured[kMaxDevices] = {};
    err = configure_smem(waterlevel_kernel<PER>, configured, smem);
    if (err != cudaSuccess) return (int)err;
    scratch = nullptr;
  }
  waterlevel_kernel<PER><<<batch, n / PER, smem, st>>>(
      b, w, demand, level, take, idx, static_cast<unsigned char*>(scratch), n);
  return (int)cudaGetLastError();
}

template <int PER>
int launch_fused(const int* busy, const int* mu, const unsigned char* masks,
                 const int* demands, int* alloc, int* levels, int* phi, int* busy_out,
                 unsigned char* scratch, int rows, int jobs, int k_groups, int m, int n,
                 int chain, size_t smem, cudaStream_t st) {
  cudaError_t err = check_smem(smem, n, true, scratch);
  if (err != cudaSuccess) return (int)err;
  if (smem > 0) {
    static size_t configured[kMaxDevices] = {};
    err = configure_smem(wf_fused_kernel<PER>, configured, smem);
    if (err != cudaSuccess) return (int)err;
    scratch = nullptr;
  }
  wf_fused_kernel<PER><<<rows, n / PER, smem, st>>>(busy, mu, masks, demands, alloc, levels,
                                                     phi, busy_out, scratch, m, n, k_groups,
                                                     jobs, chain);
  return (int)cudaGetLastError();
}

template <typename Kernel>
int attributes_of(Kernel kernel, int* static_smem, int* max_threads) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  *static_smem = (int)a.sharedSizeBytes;
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}

}  // namespace

// Scratch bytes a launch needs: 0 where the rows fit in shared memory,
// else rows * the padded row buffers (about 12.6 B a lane for K1, 24.9 for
// the fused kernel).
extern "C" long long waterlevel_scratch_bytes(int rows, int n_lanes, int fused) {
  const int cap = fused ? kFusedSmemMaxLanes : kSmemMaxLanes;
  return n_lanes <= cap ? 0 : (long long)rows * (long long)row_bytes(n_lanes, fused != 0);
}

// K1/K2.  Launch on `stream` with `threads` threads and `smem_bytes` of
// dynamic shared memory a block, as the wrapper's launch_config gives
// them.  `scratch` must hold waterlevel_scratch_bytes(batch, n_lanes, 0)
// bytes.  Returns cudaGetLastError() after the launch (0 on success);
// nothing here synchronises.
extern "C" int waterlevel_launch(const void* b, const void* w,
                                 const void* demand, void* level, void* take,
                                 void* idx, void* scratch, int batch,
                                 int n_lanes, int smem_bytes, int threads,
                                 void* stream) {
  if (batch < 1 || !valid_width(n_lanes) || !valid_block(n_lanes, threads) ||
      smem_bytes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)smem_bytes;
  const int* bp = static_cast<const int*>(b);
  const int* wp = static_cast<const int*>(w);
  const int* dp = static_cast<const int*>(demand);
  int* lp = static_cast<int*>(level);
  int* tp = static_cast<int*>(take);
  int* ip = static_cast<int*>(idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // lanes per thread: a compile-time count, so that the per-lane loops
  // unroll and their loads are in flight together
  switch (n_lanes / threads) {
    case 2:
      return launch_waterlevel<2>(bp, wp, dp, lp, tp, ip, scratch, batch, n_lanes, smem, st);
    case 4:
      return launch_waterlevel<4>(bp, wp, dp, lp, tp, ip, scratch, batch, n_lanes, smem, st);
    case 8:
      return launch_waterlevel<8>(bp, wp, dp, lp, tp, ip, scratch, batch, n_lanes, smem, st);
    case 16:
      return launch_waterlevel<16>(bp, wp, dp, lp, tp, ip, scratch, batch, n_lanes, smem, st);
    case 32:
      return launch_waterlevel<32>(bp, wp, dp, lp, tp, ip, scratch, batch, n_lanes, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The fused water-filling launch.  busy (rows, m) in groups mode or (m,)
// in chain mode, mu (P, m), masks (P, K, m) bytes, demands (P, K), with P
// = rows (groups mode, chain = 0, jobs = 1) or P = jobs (chain mode, chain
// = 1, rows = 1); writes alloc (P, K, m), levels (P, K), phi (P,) and, in
// chain mode, busy_out (m,).  n_lanes is the padded power-of-two width of
// m.  `threads` and `smem_bytes` (dynamic shared memory a block) are the
// wrapper's launch_config.  `scratch` must hold
// waterlevel_scratch_bytes(rows, n_lanes, 1) bytes.  Returns
// cudaGetLastError() after the launch.
extern "C" int wf_fused_launch(const void* busy, const void* mu, const void* masks,
                               const void* demands, void* alloc, void* levels, void* phi,
                               void* busy_out, void* scratch, int rows, int jobs,
                               int k_groups, int m, int n_lanes, int chain, int smem_bytes,
                               int threads, void* stream) {
  if (rows < 1 || jobs < 1 || k_groups < 1 || m < 1 || m > n_lanes ||
      !valid_width(n_lanes) || !valid_block(n_lanes, threads) || smem_bytes < 0 ||
      (chain && (rows != 1 || busy_out == nullptr)) || (!chain && jobs != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)smem_bytes;
  const int* bu = static_cast<const int*>(busy);
  const int* mp = static_cast<const int*>(mu);
  const unsigned char* mk = static_cast<const unsigned char*>(masks);
  const int* dm = static_cast<const int*>(demands);
  int* al = static_cast<int*>(alloc);
  int* lv = static_cast<int*>(levels);
  int* ph = static_cast<int*>(phi);
  int* bo = static_cast<int*>(busy_out);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_lanes / threads) {
    case 2:
      return launch_fused<2>(bu, mp, mk, dm, al, lv, ph, bo, sc, rows, jobs, k_groups, m,
                             n_lanes, chain, smem, st);
    case 4:
      return launch_fused<4>(bu, mp, mk, dm, al, lv, ph, bo, sc, rows, jobs, k_groups, m,
                             n_lanes, chain, smem, st);
    case 8:
      return launch_fused<8>(bu, mp, mk, dm, al, lv, ph, bo, sc, rows, jobs, k_groups, m,
                             n_lanes, chain, smem, st);
    case 16:
      return launch_fused<16>(bu, mp, mk, dm, al, lv, ph, bo, sc, rows, jobs, k_groups, m,
                              n_lanes, chain, smem, st);
    case 32:
      return launch_fused<32>(bu, mp, mk, dm, al, lv, ph, bo, sc, rows, jobs, k_groups, m,
                              n_lanes, chain, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The compiled kernel's static shared memory and thread limit, for the
// variant with `per` lanes a thread (fused != 0: the fused water-filling
// kernel, else K1/K2).  Returns 0 or the CUDA error.
extern "C" int waterlevel_kernel_attributes(int fused, int per, int* static_smem,
                                            int* max_threads) {
  switch (per) {
    case 2:
      return fused ? attributes_of(wf_fused_kernel<2>, static_smem, max_threads)
                   : attributes_of(waterlevel_kernel<2>, static_smem, max_threads);
    case 4:
      return fused ? attributes_of(wf_fused_kernel<4>, static_smem, max_threads)
                   : attributes_of(waterlevel_kernel<4>, static_smem, max_threads);
    case 8:
      return fused ? attributes_of(wf_fused_kernel<8>, static_smem, max_threads)
                   : attributes_of(waterlevel_kernel<8>, static_smem, max_threads);
    case 16:
      return fused ? attributes_of(wf_fused_kernel<16>, static_smem, max_threads)
                   : attributes_of(waterlevel_kernel<16>, static_smem, max_threads);
    case 32:
      return fused ? attributes_of(wf_fused_kernel<32>, static_smem, max_threads)
                   : attributes_of(waterlevel_kernel<32>, static_smem, max_threads);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
