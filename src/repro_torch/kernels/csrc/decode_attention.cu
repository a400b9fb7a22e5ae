// Single-token decode attention for Hopper (sm_90a): one query token per
// sequence against its KV cache, grouped-query, masked past `pos`, with
// the cache split over many blocks (split-KV).
//
// Replaces src/repro/kernels/decode_attention.py::_decode_kernel (launched
// by decode_attention_pallas on a (batch, q_heads) grid, streaming 512-row
// KV slices with the online-softmax recurrence).
//
// Contract: q (B, H, hd), k and v (B, Hkv, T, hd), out (B, H, hd), all
// contiguous and of one dtype (float or bfloat16); pos (B,) int32, the
// last valid cache index of each sequence.  Query head h reads KV head
// h / (H / Hkv).  Keys t <= min(pos, T - 1) take part; the rest are never
// read, which is the reference's mask (their logit is -1e30, so their
// weight is exactly 0).  Any T; any hd from 1 to 256; any number of
// query heads per KV head.  Logits, softmax and the weighted sum of V run in fp32; the result
// is cast back to the input dtype, and is 0 for pos < 0 (no key), as the
// TPU kernel gives.
//
// Partial mode (lse not null): the launch also writes lse (B, H) fp32,
// each head's log-sum-exp of its scaled logits over the keys it read, in
// natural-log units (-inf where it read none), and writes out in fp32
// rather than the input dtype, still normalised.  A cache split over
// ranks by the sequence (shard-local pos = pos - offset, negative for a
// shard wholly past pos) then combines the shards' (out, lse) exactly:
// weights exp(lse - max lse), the outputs' weighted sum over the weights'.
//
// What bounds it on this card: the cache is read once, 2 * T * hd
// elements per (sequence, KV head), with about 4 * G operations per
// element read, so device-memory bandwidth bounds it.
//
// What the design does about it: the grid is (splits, Hkv, B), sized by
// the caller from B, Hkv and T (never from pos, which lies on the device)
// so that every block is resident at once: a serving batch of 4 x 20 KV
// heads runs 6 blocks per head, 480 in all, on 132 SMs.  The cache is cut
// into chunks of `chunk` keys dealt round-robin to the splits, so block s
// walks chunks s, s + splits, ... up to pos: a short prefix still spreads
// over as many blocks as it has chunks, and a long one keeps each block
// streaming.  One block serves all G query heads of its (sequence, KV
// head), so each cache row is read once; its 4 warps read their keys with
// 16-byte loads, a row spread over the fewest lanes that hold it (16
// lanes for 128 bf16), so a warp reads 2 rows per load and keeps U loads
// of K and V in flight.  Each key slot keeps its own online-softmax state
// per query head; the block merges them (warp shuffles, then shared
// memory) into one fp32 partial (m, l, acc) in a scratch buffer.  A block
// whose first chunk starts past pos writes an empty partial (m = -inf,
// l = 0, acc = 0) and reads no key.  The merge runs in the same launch:
// each block takes a ticket from a per-(sequence, KV head) counter after
// its partial is written; the block that draws the last ticket merges the
// partials by log-sum-exp in one pass (each thread one output element,
// its loads of every partial independent), writes the output and resets
// the counter to 0 for the next launch.  So there is one launch per layer, and the counters stay valid
// from launch to launch (and under a CUDA graph) as long as launches
// sharing them run one at a time.
//
// Groups past 8 query heads per KV head (Qwen3-MoE: 64 over 4, a group
// of 16): each key slot keeps an online-softmax state per query head in
// registers, so 16 heads at hd 128 would hold ~128 fp32 accumulators a
// lane besides q and spill.  Instead the group is cut into n_slices =
// ceil(G / 8) slices of at most 8 heads, and the grid's y axis runs over
// (KV head, slice): a block serves one slice and reads its (sequence, KV
// head)'s cache rows itself, so the cache is read once per slice (twice
// at a group of 16, four times at 32).  Partials and ticket counters are
// per (sequence, KV head, slice).  The number of slices grows with the
// group; nothing caps it but the grid's y extent (Hkv * n_slices <=
// 65535).  A group of at most 8 is one slice: the grid, the
// instantiation and the scratch layout are those of the kernel before.
//
// Head widths: a lane loads EPL contiguous elements at once (16 bytes
// where hd allows).  Where the row fits one load per lane on at most 32
// lanes and hd <= 128 (NV = 1), the row lies on the fewest lanes that
// hold it, as above.  Any other hd up to 256 (odd widths past 32, hd
// past 128, float32 past 128) spreads the row over all 32 lanes with NV
// loads each, a lane's loads row_lanes * EPL elements apart, NV * EPL <=
// 8 elements a lane per head, so the registers a lane holds stay those
// of the NV = 1 kernel at hd 128 in bf16.  Those instantiations keep a
// 256-wide row of shared memory for the warps' merge; the NV = 1 ones
// keep their 128.  They are compiled for slices of 8 heads only (a
// smaller slice leaves heads unused): no model in the repository has
// such a width, so they trade a little speed for half the build.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 256;
constexpr int kOneLoadHeadDim = 128;  // the widest row the NV = 1 kernels take
constexpr int kMaxLaneElems = 8;      // NV * EPL: a lane's elements of one head row
constexpr int kMaxSlice = 8;   // query heads one block serves
constexpr int kMaxSplits = 64;  // blocks per (sequence, KV head)

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

template <int BYTES>
struct Raw;
template <>
struct alignas(2) Raw<2> {
  uint16_t x;
};
template <>
struct alignas(4) Raw<4> {
  uint32_t x;
};
template <>
struct alignas(8) Raw<8> {
  uint2 x;
};
template <>
struct alignas(16) Raw<16> {
  uint4 x;
};

// EPL contiguous elements of T, loaded at once (aligned to their size)
template <typename T, int EPL>
using Vec = Raw<(int)(EPL * sizeof(T))>;

template <typename T, int EPL>
__device__ __forceinline__ float elem(const Vec<T, EPL>& raw, int e) {
  return to_float(reinterpret_cast<const T*>(&raw)[e]);
}

// weight of a softmax state with max m against the common max mt (0 for
// an empty state, m = -inf)
__device__ __forceinline__ float rescale(float m, float mt) {
  return m == -INFINITY ? 0.f : expf(m - mt);
}

// NG: most query heads per KV head this instantiation serves (G <= NG);
// EPL: elements of a head row per lane and load (hd % EPL == 0); NV:
// loads of a head row per lane.  NV = 1: the row's hd / EPL lanes,
// rounded up to a power of two, fit one warp and hd <= 128; NV > 1: the
// row on all 32 lanes, hd <= 32 * EPL * NV <= 256.
template <typename T, int NG, int EPL, int NV>
__global__ void __launch_bounds__(kThreads, NG <= 2 ? 4 : 2)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int* __restrict__ pos,
                            T* __restrict__ out, float* __restrict__ out32,
                            float* __restrict__ lse, float* __restrict__ part,
                            int* __restrict__ tickets, int n_heads, int n_kv_heads,
                            int t_len, int hd, int group, int slice_heads,
                            int n_slices, int chunk, int splits, int lanes_log2,
                            float scale) {
  constexpr int U0 = NG <= 2 ? 8 : 4;
  constexpr int U = NV >= 4 ? U0 / 2 : U0;  // key rows a lane has in flight
  constexpr int kRow = NV == 1 ? kOneLoadHeadDim : kMaxHeadDim;
  static_assert(NV * EPL <= kMaxLaneElems, "a lane holds at most 8 elements of a row");
  __shared__ float sm_m[kWarps][NG];
  __shared__ float sm_l[kWarps][NG];
  __shared__ float sm_acc[kWarps][NG][kRow];
  __shared__ int sm_last;

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_slices;
  const int slice = blockIdx.y - kvh * n_slices;
  const int b = blockIdx.z;
  const int g0 = slice * slice_heads;                // its first head in the group
  const int gs = min(slice_heads, group - g0);       // the heads this block serves
  const int h0 = kvh * group + g0;                   // ... as a query head index
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row_lanes = 1 << lanes_log2;      // lanes holding one cache row
  const int rows_per_warp = 32 >> lanes_log2;  // key slots of a warp
  const int sub = lane >> lanes_log2;          // this lane's key slot in its warp
  const int d0 = (lane & (row_lanes - 1)) * EPL;  // this lane's first element
  const int dstep = row_lanes * EPL;                // between its NV loads
  const int last = min(pos[b], t_len - 1);  // last key that takes part
  const size_t bh = (size_t)b * n_kv_heads + kvh;  // its cache rows
  const size_t bs = bh * n_slices + slice;          // its partials and ticket
  const int row_p = hd + 2;  // a partial row: acc[hd], m, l
  float* pb = part + (bs * splits + split) * slice_heads * row_p;

  if (split * chunk <= last) {
    const size_t kv_base = bh * (size_t)t_len * hd;
    const T* kb = k + kv_base;
    const T* vb = v + kv_base;
    float qr[NG][NV][EPL];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        Vec<T, EPL> raw{};
        if (g < gs && d0 + j * dstep < hd) {
          raw = *reinterpret_cast<const Vec<T, EPL>*>(
              q + ((size_t)b * n_heads + (size_t)h0 + g) * hd + d0 + j * dstep);
        }
#pragma unroll
        for (int e = 0; e < EPL; ++e) qr[g][j][e] = elem<T, EPL>(raw, e) * scale;
      }
    }

    float m[NG], l[NG], acc[NG][NV][EPL];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][j][e] = 0.f;
    }

    const int slots = kWarps * rows_per_warp;
    // this block's chunks, then within each a warp-uniform loop (its lanes
    // shuffle together) in which key slot `sub` takes keys
    // t0 + sub + u * slots
    for (int c0 = split * chunk; c0 <= last; c0 += splits * chunk) {
      const int k1 = min(c0 + chunk, last + 1);
      for (int t0 = c0 + warp * rows_per_warp; t0 < k1; t0 += U * slots) {
        Vec<T, EPL> kr[U][NV], vr[U][NV];  // raw: converted where used
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = t0 + sub + u * slots;
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            kr[u][j] = vr[u][j] = Vec<T, EPL>{};
            const int d = d0 + j * dstep;
            if (t < k1 && d < hd) {
              kr[u][j] = *reinterpret_cast<const Vec<T, EPL>*>(kb + (size_t)t * hd + d);
              vr[u][j] = *reinterpret_cast<const Vec<T, EPL>*>(vb + (size_t)t * hd + d);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          if (g >= gs) break;
          float s[U];
          float mx = m[g];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float dot = 0.f;
#pragma unroll
            for (int j = 0; j < NV; ++j)
#pragma unroll
              for (int e = 0; e < EPL; ++e) dot += qr[g][j][e] * elem<T, EPL>(kr[u][j], e);
            for (int off = row_lanes >> 1; off > 0; off >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, off);
            s[u] = t0 + sub + u * slots < k1 ? dot : -INFINITY;
            mx = fmaxf(mx, s[u]);
          }
          const float corr = rescale(m[g], mx);
          l[g] *= corr;
#pragma unroll
          for (int j = 0; j < NV; ++j)
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][j][e] *= corr;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float p = rescale(s[u], mx);  // 0 for a key past k1
            l[g] += p;
#pragma unroll
            for (int j = 0; j < NV; ++j)
#pragma unroll
              for (int e = 0; e < EPL; ++e) acc[g][j][e] += p * elem<T, EPL>(vr[u][j], e);
          }
          m[g] = mx;
        }
      }
    }

    // the warp's key slots into slot 0, then the warps into one partial
    for (int off = row_lanes; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mt = fmaxf(m[g], mo);
        const float fa = rescale(m[g], mt);
        const float fb = rescale(mo, mt);
        l[g] = l[g] * fa + lo * fb;
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const float ao = __shfl_xor_sync(0xffffffffu, acc[g][j][e], off);
            acc[g][j][e] = acc[g][j][e] * fa + ao * fb;
          }
        m[g] = mt;
      }
    }
    if (sub == 0) {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        if (lane == 0) {
          sm_m[warp][g] = m[g];
          sm_l[warp][g] = l[g];
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (d0 + j * dstep < hd) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) sm_acc[warp][g][d0 + j * dstep + e] = acc[g][j][e];
          }
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < gs * hd; idx += kThreads) {
      const int g = idx / hd;
      const int d = idx - g * hd;
      float mt = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w][g]);
      float lt = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = rescale(sm_m[w][g], mt);
        lt += sm_l[w][g] * f;
        o += sm_acc[w][g][d] * f;
      }
      pb[g * row_p + d] = o;
      if (d == 0) {
        pb[g * row_p + hd] = mt;
        pb[g * row_p + hd + 1] = lt;
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < gs * row_p; idx += kThreads) {
      pb[idx] = idx % row_p == hd ? -INFINITY : 0.f;
    }
  }

  // the last block of this (sequence, KV head) to finish merges
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sm_last = atomicAdd(&tickets[bs], 1) == splits - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  // one pass over the splits' partials, their loads independent of one
  // another (an empty partial is m = -inf, l = 0, acc = 0)
  const float* pbh = part + bs * splits * slice_heads * row_p;
  for (int idx = threadIdx.x; idx < gs * hd; idx += kThreads) {
    const int g = idx / hd;
    const int d = idx - g * hd;
    float mt = -INFINITY, lt = 0.f, o = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      const float* ps = pbh + ((size_t)sp * slice_heads + g) * row_p;
      const float m = __ldcg(ps + hd);
      const float l = __ldcg(ps + hd + 1);
      const float a = __ldcg(ps + d);
      const float mn = fmaxf(mt, m);
      const float fa = rescale(mt, mn);
      const float fb = rescale(m, mn);
      lt = lt * fa + l * fb;
      o = o * fa + a * fb;
      mt = mn;
    }
    const size_t row = (size_t)b * n_heads + (size_t)h0 + g;
    const float val = lt > 0.f ? o / lt : 0.f;
    if (lse == nullptr) {
      out[row * hd + d] = from_float<T>(val);
    } else {  // partial mode: fp32 out and the head's log-sum-exp
      out32[row * hd + d] = val;
      if (d == 0) lse[row] = lt > 0.f ? mt + logf(lt) : -INFINITY;
    }
  }
  if (threadIdx.x == 0) tickets[bs] = 0;
}

struct Args {
  const void *q, *k, *v;
  const int* pos;
  void* out;
  float* lse;
  float* part;
  int* tickets;
  int batch, n_heads, n_kv_heads, t_len, hd, group, slice_heads, n_slices, chunk, splits;
  float scale;
};

template <typename T, int NG, int EPL, int NV>
int launch_one(const Args& a, cudaStream_t s) {
  int lanes_log2 = 5;  // NV > 1: the row on all 32 lanes
  if (NV == 1) {
    lanes_log2 = 0;
    while ((1 << lanes_log2) * EPL < a.hd) ++lanes_log2;
    if (lanes_log2 > 5 || a.hd > kOneLoadHeadDim) return (int)cudaErrorInvalidValue;
  } else if (a.hd > 32 * EPL * NV) {
    return (int)cudaErrorInvalidValue;
  }
  decode_attention_kernel<T, NG, EPL, NV>
      <<<dim3(a.splits, a.n_kv_heads * a.n_slices, a.batch), kThreads, 0, s>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
          a.pos, a.lse ? nullptr : static_cast<T*>(a.out),
          a.lse ? static_cast<float*>(a.out) : nullptr, a.lse, a.part, a.tickets, a.n_heads,
          a.n_kv_heads, a.t_len,
          a.hd, a.group, a.slice_heads, a.n_slices, a.chunk, a.splits, lanes_log2, a.scale);
  return (int)cudaGetLastError();
}

// NV loads a lane: NV = 1 at every slice width; NV > 1 (with NV * EPL
// <= 8) for slices of 8 heads only
template <typename T, int NG, int EPL>
int launch_nv(const Args& a, int nv, cudaStream_t s) {
  if (nv == 1) return launch_one<T, NG, EPL, 1>(a, s);
  if constexpr (NG == kMaxSlice) {
    switch (nv) {
      case 2:
        if constexpr (EPL * 2 <= kMaxLaneElems) return launch_one<T, NG, EPL, 2>(a, s);
        break;
      case 4:
        if constexpr (EPL * 4 <= kMaxLaneElems) return launch_one<T, NG, EPL, 4>(a, s);
        break;
      case 8:
        if constexpr (EPL * 8 <= kMaxLaneElems) return launch_one<T, NG, EPL, 8>(a, s);
        break;
      default:
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int NG>
int launch_epl(const Args& a, int epl, int nv, cudaStream_t s) {
  switch (epl) {
    case 1:
      return launch_nv<T, NG, 1>(a, nv, s);
    case 2:
      return launch_nv<T, NG, 2>(a, nv, s);
    case 4:
      return launch_nv<T, NG, 4>(a, nv, s);
    case 8:
      if constexpr (sizeof(T) == 2) return launch_nv<T, NG, 8>(a, nv, s);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the instantiation serving a slice of slice_heads query heads (of 8
// where a lane loads its row more than once)
template <typename T>
int launch(const Args& a, int epl, int nv, cudaStream_t s) {
  if (nv > 1) return launch_epl<T, kMaxSlice>(a, epl, nv, s);
  if (a.slice_heads <= 1) return launch_epl<T, 1>(a, epl, nv, s);
  if (a.slice_heads <= 2) return launch_epl<T, 2>(a, epl, nv, s);
  if (a.slice_heads <= 4) return launch_epl<T, 4>(a, epl, nv, s);
  return launch_epl<T, kMaxSlice>(a, epl, nv, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  epl: elements of a head row each lane
// loads at once (the wrapper's choice: 16 bytes where hd allows); nv:
// loads of a head row per lane (1, or 2, 4, 8 with the row on 32 lanes;
// the wrapper's lane_plan).  The
// caller gives the split plan (chunks of `chunk` keys dealt to `splits`
// blocks per (sequence, KV head, slice)), a float32 scratch of
// B * Hkv * n_slices * splits * slice_heads * (hd + 2) elements, and an
// int32 ticket counter per (sequence, KV head, slice), 0 before the launch
// (the kernel leaves it 0).  The group G = H / Hkv is cut into n_slices =
// ceil(G / 8) slices of slice_heads = ceil(G / n_slices) heads (the last
// may hold fewer); the caller sizes its buffers by the same rule.
// lse: null, or a float32 (B, H) buffer for the partial mode (out is
// then float32 too; see the header).
// Launches on `stream` and returns cudaGetLastError() after the launch (0
// on success); nothing here synchronises.  Refuses (cudaErrorInvalidValue)
// what the kernel does not take: hd past 256 or not a multiple of epl; a
// row the (epl, nv) plan does not hold (nv = 1: more than 32 lanes of epl
// or hd past 128; nv > 1: hd past 32 * epl * nv, or nv * epl past 8); H
// not a multiple of Hkv; Hkv * n_slices past the grid's 65535; more than
// 64 splits.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* part,
                                       void* tickets, void* lse, int batch, int n_heads,
                                       int n_kv_heads, int t_len, int hd, int chunk,
                                       int splits, int epl, int nv, float scale, int dtype,
                                       void* stream) {
  if (batch < 1 || batch > 65535 || n_kv_heads < 1 || n_kv_heads > 65535 ||
      n_heads % n_kv_heads || t_len < 1 || hd < 1 || hd > kMaxHeadDim || epl < 1 ||
      hd % epl || nv < 1 || splits < 1 || splits > kMaxSplits || chunk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int group = n_heads / n_kv_heads;
  if (group < 1) return (int)cudaErrorInvalidValue;
  const int n_slices = (group + kMaxSlice - 1) / kMaxSlice;
  const int slice_heads = (group + n_slices - 1) / n_slices;
  if ((long long)n_kv_heads * n_slices > 65535) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(pos), out, static_cast<float*>(lse),
               static_cast<float*>(part),
               static_cast<int*>(tickets), batch, n_heads, n_kv_heads, t_len, hd, group,
               slice_heads, n_slices, chunk, splits, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(a, epl, nv, s);
    case 1:
      return launch<__nv_bfloat16>(a, epl, nv, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
