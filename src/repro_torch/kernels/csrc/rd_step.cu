// RD step kernel for Hopper (sm_90a): one iteration of device
// Replica-Deletion's deletion loop or dedup loop in one launch — the
// target pick, the strip (candidates sorted by the deletion key, member
// counts walked against the quota), the re-homing of the deleted members
// and the server deltas — on state held in device buffers, updated in
// place.
//
// Replaces src/repro/kernels/rd.py::_rd_strip_kernel (launched by
// _rd_strip_call), which sorts and walks one strip's key block, together
// with the jnp loop bodies of src/repro/core/rd_jax.py around it.  The
// plain version, step for step, is rd_step_plain in
// src/repro_torch/kernels/rd.py; every buffer below ends bit for bit as
// it leaves them.
//
// State (C slots, A ids a holder row, M servers; each slot buffer has a
// spare row C, each server buffer but busy_est/busy0/mu/targets0 a spare
// lane M): holders int32 (C+1, A), rows ascending, padded with M; size,
// cnt, grp int32 (C+1); hash int64 (C+1); load, multi int32 (M+1);
// busy_est, busy0, mu int32 (M); words int64 (M+1); targets0 uint8 (M);
// flags int32 [best, done, headroom, stop].  scratch: 5 * C int32.
// Ceilings: C a power of two in [128, 16384] (the candidate sort's 12
// bytes a slot in shared memory), A a power of two in [2, 64] (a warp
// holds a row, two ids a lane), 1 <= M <= 32767 (M + 1 peek counts in
// shared memory).  Wider rows take the plain version by the wrapper's
// counted rule.  All arithmetic is int32 and wraps as the plain version's.
//
// What bounds it on this card: the iteration is a chain of dependent
// block-wide reductions (sweep level, peek counts, target, candidates,
// sort, prefix walk, home lookup, free-slot ranks, deltas, exit flag), so
// one block runs it on one SM.  Its device-memory work is small: two
// passes over the holder rows (C * A * 4 bytes, 256 KB at the main path's
// C 4096, A 16, which stays in the 50 MB L2 between launches) and a few
// passes over the M-vectors, about 0.3 MB in all, 0.1 µs at HBM rate; so
// the time is the passes' L2 traffic into one SM, the ~45 barriers of
// the chain, and the launch.
//
// What the design does about it: the strip sorts only the candidates
// (active slots on m with two or more replicas: a few dozen of the main
// path's 2,048-4,096 slots) instead of every lane, as 64-bit
// (-count, alt) keys with their slot in shared memory, reading holder
// rows only to break ties; everything between the target pick and the
// exit flag stays in the one launch, so a loop iteration costs the host
// one launch.  Spreading an iteration over SMs, or a whole loop in one
// persistent launch, is later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 1 << 30;
constexpr int kMinSlots = 128;
constexpr int kMaxSlots = 1 << 14;
constexpr int kMaxRowIds = 64;
constexpr int kMaxServers = (1 << 15) - 1;  // <= 32 servers a thread
constexpr int kStaticSmemMargin = 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
enum { kBest = 0, kDone = 1, kHeadroom = 2, kStop = 3 };

typedef unsigned long long u64;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ unsigned biased(int v) {
  return (unsigned)v ^ 0x80000000u;
}
// floor division and -(-a // b), as torch's int32 // (b != 0)
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int ceil_div(int a, int b) {
  return wsub(0, floor_div(wsub(0, a), b));
}

struct Scalars {
  u64 red64[kWarps];
  int red32[kWarps];
  unsigned scan[kWarps];
  int n_cand, n_mv, n_new, n_free;
};

__device__ __forceinline__ u64 block_max_u64(u64 v, Scalars& sh) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  if ((threadIdx.x & 31) == 0) sh.red64[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 r = sh.red64[0];
  for (int w = 1; w < kWarps; ++w) r = sh.red64[w] > r ? sh.red64[w] : r;
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_max_i32(int v, Scalars& sh) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) sh.red32[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = sh.red32[0];
  for (int w = 1; w < kWarps; ++w) r = max(r, sh.red32[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ bool block_any(bool v, Scalars& sh) {
  return __syncthreads_or(v) != 0;
}

// wrapping sum across the block
__device__ __forceinline__ int block_sum(int v, Scalars& sh) {
  for (int o = 16; o > 0; o >>= 1) v = wadd(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) sh.red32[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < kWarps; ++w) r = wadd(r, sh.red32[w]);
  __syncthreads();
  return r;
}

// Exclusive prefix (wrapping) of one value per thread, in thread order;
// *total gets the sum.
__device__ unsigned block_exclusive_scan(unsigned v, Scalars& sh,
                                         unsigned* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh.scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned s = sh.scan[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    sh.scan[lane] = s;
  }
  __syncthreads();
  const unsigned out = x - v + (warp > 0 ? sh.scan[warp - 1] : 0u);
  *total = sh.scan[kWarps - 1];
  __syncthreads();
  return out;
}

// Candidate order: (-count, alt) packed in `key`, then the holder row id
// by id, the group, the slot.  Pads (slot >= C) carry the largest key.
__device__ __forceinline__ bool cand_greater(u64 ka, int sa, u64 kb, int sb,
                                             const int* holders,
                                             const int* grp, int A, int C) {
  if (ka != kb) return ka > kb;
  if (sa >= C || sb >= C) return sa > sb;
  const int* ra = holders + (size_t)sa * A;
  const int* rb = holders + (size_t)sb * A;
  for (int j = 0; j < A; ++j) {
    const int x = ra[j], y = rb[j];
    if (x != y) return x > y;
  }
  if (grp[sa] != grp[sb]) return grp[sa] > grp[sb];
  return sa > sb;
}

// The mover's row in a warp, two ids a lane (ids past A read as the pad
// M), and its spun row: the row without m, shifted left, padded with M.
struct SpunPair {
  int s0, s1;
};
__device__ __forceinline__ SpunPair spun_pair(const int* row, int A, int M,
                                              int m) {
  const int lane = threadIdx.x & 31;
  const int i0 = 2 * lane, i1 = 2 * lane + 1;
  const int a0 = i0 < A ? row[i0] : M;
  const int a1 = i1 < A ? row[i1] : M;
  int next0 = __shfl_down_sync(kFull, a0, 1);
  if (lane == 31) next0 = M;
  const unsigned hit = __ballot_sync(kFull, a0 == m || a1 == m);
  const bool before = (hit & ((1u << lane) - 1u)) != 0u;
  const bool has0 = before || a0 == m;
  const bool has1 = has0 || a1 == m;
  return SpunPair{has0 ? a1 : a0, has1 ? next0 : a1};
}

__global__ void __launch_bounds__(kThreads)
rd_step_kernel(int* holders, int* size, int* cnt, int* grp, long long* hash,
               int* load, int* multi, int* busy_est,
               const int* __restrict__ busy0, const int* __restrict__ mu,
               const long long* __restrict__ words, unsigned char* targets0,
               int* flags, int* scratch, int C, int A, int logA, int M,
               int dedup) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Scalars sh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int* mv_slot = scratch;
  int* mv_take = scratch + C;
  int* mv_tgt = scratch + 2 * C;  // merge: home slot; new: -1 - rank
  int* free_at = scratch + 3 * C;

  if (tid == 0) {
    sh.n_cand = 0;
    sh.n_mv = 0;
    sh.n_new = 0;
  }

  // ---- 1. target pick ---------------------------------------------------
  const int best_prev = flags[kBest];
  int m, best = best_prev;
  bool gate, stop = false;
  if (!dedup) {
    // servers s = tid + k * kThreads, k < 32: the valid mask as bits
    unsigned vbits = 0;
    bool any_valid = false;
    int nbest_l = INT_MIN;
    for (int s = tid, k = 0; s < M; s += kThreads, ++k) {
      const bool held = load[s] > 0;
      const int be = busy_est[s];
      const bool v = targets0[s] != 0 && held && be == best_prev;
      any_valid |= v;
      nbest_l = max(nbest_l, held ? be : -1);
    }
    any_valid = block_any(any_valid, sh);
    const int nbest = block_max_i32(nbest_l, sh);
    const bool new_sweep = !any_valid;
    best = new_sweep ? nbest : best_prev;
    bool sole_target = false;
    for (int s = tid, k = 0; s < M; s += kThreads, ++k) {
      const bool held = load[s] > 0;
      const int be = busy_est[s];
      const bool nt = held && be == nbest;
      bool v;
      if (new_sweep) {
        targets0[s] = nt ? 1 : 0;
        v = nt;
      } else {
        v = targets0[s] != 0 && held && be == best_prev;
      }
      if (v) vbits |= 1u << k;
      sole_target |= nt && multi[s] == 0;
    }
    sole_target = block_any(sole_target, sh);
    const bool done_now = new_sweep && (nbest < 0 || sole_target);

    // peek: the largest replica count of an active slot on each server
    int* peek = reinterpret_cast<int*>(dyn);
    for (int s = tid; s <= M; s += kThreads) peek[s] = 0;
    __syncthreads();
    const int total = C << logA;
    for (int i = tid; i < total; i += kThreads) {
      const int c = i >> logA;
      if (size[c] > 0) {
        const int cn = cnt[c];
        if (cn > 0) atomicMax(&peek[holders[i]], cn);
      }
    }
    __syncthreads();
    int p_l = INT_MIN;
    for (int s = tid, k = 0; s < M; s += kThreads, ++k) {
      if (vbits >> k & 1u) p_l = max(p_l, peek[s]);
    }
    const int p = block_max_i32(p_l, sh);
    // first argmax of busy0 over the servers attaining p
    u64 key_l = 0;
    for (int s = tid, k = 0; s < M; s += kThreads, ++k) {
      const bool in = (vbits >> k & 1u) && peek[s] == p;
      const int v = in ? busy0[s] : INT_MIN;
      const u64 key = ((u64)biased(v) << 32) | (u64)(0xffffffffu - (unsigned)s);
      key_l = key > key_l ? key : key_l;
    }
    m = (int)(0xffffffffu - (unsigned)(block_max_u64(key_l, sh) & 0xffffffffu));
    stop = flags[kDone] != 0 || done_now || p <= 1;
    gate = !stop;
  } else {
    bool go = false;
    int bmax_l = INT_MIN;
    for (int s = tid; s < M; s += kThreads) {
      const bool mp = multi[s] > 0;
      go |= mp;
      if (mp) bmax_l = max(bmax_l, busy_est[s]);
    }
    go = block_any(go, sh);
    const int bmax = block_max_i32(bmax_l, sh);
    // last argmax of busy0 over the busiest multi-copy holders
    u64 key_l = 0;
    for (int s = tid; s < M; s += kThreads) {
      const bool in = multi[s] > 0 && busy_est[s] == bmax;
      const int v = in ? busy0[s] : INT_MIN;
      const u64 key = ((u64)biased(v) << 32) | (u64)(unsigned)s;
      key_l = key > key_l ? key : key_l;
    }
    m = (int)(unsigned)(block_max_u64(key_l, sh) & 0xffffffffu);
    gate = go;
  }

  // ---- 2. the strip: candidates -----------------------------------------
  const int load_m = load[m];
  const int mu_m = mu[m];
  int quota = 0;
  if (gate) {
    int r = wsub(load_m, 1) % mu_m;
    if (r != 0 && ((r < 0) != (mu_m < 0))) r += mu_m;
    quota = r + 1;
  }
  u64* cand_key = reinterpret_cast<u64*>(dyn);
  int* cand_slot = reinterpret_cast<int*>(dyn + (size_t)8 * C);
  {
    const int total = C << logA;
    for (int i = tid; i < total; i += kThreads) {
      if (holders[i] == m) {
        const int c = i >> logA;
        if (size[c] > 0 && cnt[c] >= 2) cand_slot[atomicAdd(&sh.n_cand, 1)] = c;
      }
    }
  }
  __syncthreads();
  const int K = sh.n_cand;
  int Kp = K > 0 ? 1 : 0;
  while (Kp < K) Kp <<= 1;
  for (int k = tid; k < Kp; k += kThreads) {
    if (k < K) {
      const int c = cand_slot[k];
      const int* row = holders + (size_t)c * A;
      int alt = INT_MAX;
      for (int j = 0; j < A; ++j) {
        const int h = row[j];
        alt = min(alt, h == m ? kBig : (h < M ? busy0[h] : kBig));
      }
      cand_key[k] = ((u64)biased(wsub(0, cnt[c])) << 32) | (u64)biased(alt);
    } else {
      cand_key[k] = ~0ull;
      cand_slot[k] = C + k;
    }
  }
  __syncthreads();

  // bitonic sort of the candidates, ascending
  for (int k = 2; k <= Kp; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < (Kp >> 1); i += kThreads) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const u64 ka = cand_key[lo], kb = cand_key[hi];
        const int sa = cand_slot[lo], sb = cand_slot[hi];
        const bool ascending = (lo & k) == 0;
        if (cand_greater(ka, sa, kb, sb, holders, grp, A, C) == ascending) {
          cand_key[lo] = kb;
          cand_key[hi] = ka;
          cand_slot[lo] = sb;
          cand_slot[hi] = sa;
        }
      }
      __syncthreads();
    }
  }

  // walk: exclusive prefix of the sorted member counts against the quota
  int removed;
  {
    const int per = (K + kThreads - 1) / kThreads;
    const int base = min(tid * per, K);
    const int end = min(base + per, K);
    int run = 0;
    for (int k = base; k < end; ++k) run = wadd(run, size[cand_slot[k]]);
    unsigned total;
    int prev = (int)block_exclusive_scan((unsigned)run, sh, &total);
    int removed_l = 0;
    for (int k = base; k < end; ++k) {
      const int c = cand_slot[k];
      const int s = size[c];
      int take = wsub(quota, prev);
      take = take > 0 ? take : 0;
      take = take < s ? take : s;
      prev = wadd(prev, s);
      removed_l = wadd(removed_l, take);
      if (take > 0) {
        const int j = atomicAdd(&sh.n_mv, 1);
        mv_slot[j] = c;
        mv_take[j] = take;
      }
    }
    removed = block_sum(removed_l, sh);
  }
  const int n_mv = sh.n_mv;

  // ---- 3. re-homing -------------------------------------------------------
  // the candidate arrays are dead: spun hashes and homes take their place
  const long long word_m = words[m];
  long long* spun_hash = reinterpret_cast<long long*>(dyn);
  int* home = reinterpret_cast<int*>(dyn + (size_t)8 * C);
  for (int j = tid; j < n_mv; j += kThreads) {
    spun_hash[j] = hash[mv_slot[j]] ^ word_m;
    home[j] = INT_MAX;
  }
  __syncthreads();
  if (n_mv > 0) {
    for (int c = tid; c < C; c += kThreads) {
      if (size[c] > 0) {
        const long long h = hash[c];
        for (int j = 0; j < n_mv; ++j) {
          if (h == spun_hash[j]) atomicMin(&home[j], c);
        }
      }
    }
  }
  __syncthreads();
  // confirm each home by its group and holder row, one warp a mover
  for (int j = warp; j < n_mv; j += kWarps) {
    const int c = mv_slot[j];
    const int h = home[j];
    const SpunPair sp = spun_pair(holders + (size_t)c * A, A, M, m);
    bool merge = false;
    if (h != INT_MAX) {
      const int* hr = holders + (size_t)h * A;
      const int i0 = 2 * lane, i1 = 2 * lane + 1;
      const bool eq = (i0 >= A || hr[i0] == sp.s0) && (i1 >= A || hr[i1] == sp.s1);
      merge = __all_sync(kFull, eq) && grp[h] == grp[c];
    }
    if (lane == 0) {
      if (merge) {
        mv_tgt[j] = h;
      } else {
        mv_tgt[j] = -1;
        atomicAdd(&sh.n_new, 1);
      }
    }
  }
  __syncthreads();
  const int n_new = sh.n_new;
  // the i-th new class in slot order takes the i-th free slot
  for (int j = tid; j < n_mv; j += kThreads) {
    if (mv_tgt[j] < 0) {
      const int c = mv_slot[j];
      int rank = 0;
      for (int i = 0; i < n_mv; ++i) rank += (mv_tgt[i] < 0 && mv_slot[i] < c);
      home[j] = rank;  // the home slot is not needed past here
    }
  }
  int n_free;
  {
    const int per = (C + kThreads - 1) / kThreads;
    const int base = min(tid * per, C);
    const int end = min(base + per, C);
    int run = 0;
    for (int c = base; c < end; ++c) run += size[c] == 0;
    unsigned total;
    int r = (int)block_exclusive_scan((unsigned)run, sh, &total);
    n_free = (int)total;
    for (int c = base; c < end; ++c) {
      if (size[c] == 0) {
        if (r < n_new) free_at[r] = c;
        ++r;
      }
    }
  }
  __syncthreads();

  // ---- 4. moves and deltas ----------------------------------------------
  for (int j = warp; j < n_mv; j += kWarps) {
    const int c = mv_slot[j];
    const int take = mv_take[j];
    int t = mv_tgt[j];
    if (t < 0) t = home[j] < n_free ? free_at[home[j]] : C;
    const SpunPair sp = spun_pair(holders + (size_t)c * A, A, M, m);
    if (t < C) {
      int* tr = holders + (size_t)t * A;
      const int i0 = 2 * lane, i1 = 2 * lane + 1;
      if (i0 < A) tr[i0] = sp.s0;
      if (i1 < A) tr[i1] = sp.s1;
    }
    if (lane == 0) {
      if (t < C) {
        hash[t] = hash[c] ^ word_m;
        grp[t] = grp[c];
        cnt[t] = cnt[c] - 1;
      }
      size[c] = wsub(size[c], take);
      atomicAdd(&size[t], take);
      // members of a count-2 class became sole-copy on their last holder
      atomicSub(&multi[cnt[c] == 2 ? sp.s0 : M], take);
    }
  }
  if (tid == 0) {
    atomicSub(&multi[m], removed);
    load[m] = wsub(load_m, removed);
    busy_est[m] = wadd(busy0[m], ceil_div(wsub(load_m, removed), mu_m));
    flags[kHeadroom] = min(flags[kHeadroom], n_free - n_new);
  }
  __syncthreads();

  // ---- 5. carry and exit flag -------------------------------------------
  const bool overflow = __ldcg(&flags[kHeadroom]) < 0;
  if (dedup) {
    bool any_multi = false;
    for (int s = tid; s < M; s += kThreads) any_multi |= __ldcg(&multi[s]) > 0;
    any_multi = block_any(any_multi, sh);
    if (tid == 0) flags[kStop] = (!any_multi || overflow) ? 1 : 0;
  } else {
    bool tail = false;
    for (int s = tid; s < M; s += kThreads) {
      tail |= __ldcg(&load[s]) > 0 && __ldcg(&busy_est[s]) == best &&
              __ldcg(&multi[s]) == 0;
    }
    tail = block_any(tail, sh) || removed == 0;
    if (tid == 0) {
      const bool done = stop || (gate && tail);
      flags[kBest] = best;
      flags[kDone] = done ? 1 : 0;
      flags[kStop] = (done || overflow) ? 1 : 0;
    }
  }
}

struct DeviceConfig {
  bool configured = false;
  int smem_optin = 0;  // cudaDevAttrMaxSharedMemoryPerBlockOptin
};

}  // namespace

// Launch one iteration on `stream` (dedup != 0: the dedup loop's) with
// `threads` threads and `smem_bytes` of dynamic shared memory, as the
// wrapper's launch_config (kernels/rd.py) gives them: kThreads, and the
// peek counts (M + 1 ints) or the candidates' keys and slots (12 bytes a
// slot), whichever is larger, rounded up to 16 bytes.  Returns
// cudaGetLastError() after the launch (0 on success); nothing here
// synchronises.
extern "C" int rd_step_launch(void* holders, void* size, void* cnt, void* grp,
                              void* hash, void* load, void* multi,
                              void* busy_est, const void* busy0, const void* mu,
                              const void* words, void* targets0, void* flags,
                              void* scratch, int C, int A, int M, int dedup,
                              int smem_bytes, int threads, void* stream) {
  if (C < kMinSlots || C > kMaxSlots || (C & (C - 1)) != 0 || A < 2 ||
      A > kMaxRowIds || (A & (A - 1)) != 0 || M < 1 || M > kMaxServers ||
      threads != kThreads) {
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
    err = cudaFuncSetAttribute(rd_step_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cfg.smem_optin - kStaticSmemMargin);
    if (err != cudaSuccess) return (int)err;
    cfg.configured = true;
  }
  // the layout needs the peek counts (M + 1 ints) while picking, then the
  // candidates' keys and slots (12 bytes a slot)
  const size_t peek = (size_t)(M + 1) * sizeof(int);
  const size_t cands = (size_t)12 * C;
  const size_t smem = (size_t)(smem_bytes > 0 ? smem_bytes : 0);
  if (smem < (peek > cands ? peek : cands) ||
      smem > (size_t)(cfg.smem_optin - kStaticSmemMargin)) {
    return (int)cudaErrorInvalidValue;
  }
  int logA = 0;
  while ((1 << logA) < A) ++logA;
  rd_step_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(holders), static_cast<int*>(size),
      static_cast<int*>(cnt), static_cast<int*>(grp),
      static_cast<long long*>(hash), static_cast<int*>(load),
      static_cast<int*>(multi), static_cast<int*>(busy_est),
      static_cast<const int*>(busy0), static_cast<const int*>(mu),
      static_cast<const long long*>(words),
      static_cast<unsigned char*>(targets0), static_cast<int*>(flags),
      static_cast<int*>(scratch), C, A, logA, M, dedup);
  return (int)cudaGetLastError();
}

// The compiled kernel's static shared memory and thread limit.  Returns 0
// or the CUDA error.
extern "C" int rd_step_kernel_attributes(int* static_smem, int* max_threads) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, rd_step_kernel);
  if (err != cudaSuccess) return (int)err;
  *static_smem = (int)a.sharedSizeBytes;
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}
