// Single-token decode attention for Hopper (sm_90a): one query token per
// sequence against its KV cache, grouped-query, masked past `pos`.
//
// Replaces src/repro/kernels/decode_attention.py::_decode_kernel (launched
// by decode_attention_pallas on a (batch, q_heads) grid, streaming 512-row
// KV slices with the online-softmax recurrence).
//
// Contract: q (B, H, hd), k and v (B, Hkv, T, hd), out (B, H, hd), all
// contiguous and of one dtype (float or bfloat16); pos (B,) int32, the
// last valid cache index of each sequence.  Query head h reads KV head
// h / (H / Hkv).  Keys t <= pos take part; the rest are skipped, which is
// the reference's mask (their logit is -1e30, so their weight is exactly
// 0).  Any T: the cache length need not be a multiple of a slice.  Logits,
// softmax and the weighted sum of V run in fp32; the result is cast back
// to the input dtype.
//
// What bounds it on this card: the cache is read once, 2 * T * hd
// elements per (sequence, KV head), with about 4 * G operations per
// element read, so device-memory bandwidth bounds it.
//
// What the design does about it: one block per (sequence, KV head) serves
// all G query heads of the group, so the cache is read once, not G times
// as the TPU grid reads it.  Each of the block's 8 warps takes its own
// keys, U at a time, every lane loading its hd / 32 contiguous elements
// of each key and value row in one vector load, so a warp keeps U rows of
// K and V in flight.  A warp keeps its own online-softmax state (running
// max, sum, accumulator) per query head; the 8 states are merged through
// shared memory at the end.  Only slices up to pos are read.  Splitting
// long caches across blocks (split-KV) and tensor-core dot products are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;

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

// EPL contiguous elements in one load; p is aligned to EPL * sizeof(T)
template <typename T, int EPL>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[EPL]) {
  using R = Raw<(int)(EPL * sizeof(T))>;
  const R raw = *reinterpret_cast<const R*>(p);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < EPL; ++e) out[e] = to_float(v[e]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NG: most query heads per KV head this instantiation serves (G <= NG);
// EPL: elements of a head row per lane (hd <= 32 * EPL, hd % EPL == 0)
template <typename T, int NG, int EPL>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int* __restrict__ pos,
                            T* __restrict__ out, int n_heads, int n_kv_heads,
                            int t_len, int hd, int group, float scale) {
  constexpr int U = NG >= 4 ? 4 : 8;  // keys a warp has in flight
  __shared__ float sm_m[kWarps][NG];
  __shared__ float sm_l[kWarps][NG];
  __shared__ float sm_acc[kWarps][NG][kMaxHeadDim];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * EPL;
  const bool lane_on = d0 < hd;
  const int last = min(pos[b], t_len - 1);  // last key that takes part

  const size_t kv_base = ((size_t)b * n_kv_heads + kvh) * (size_t)t_len * hd;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;

  float qr[NG][EPL];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    float tmp[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) tmp[e] = 0.f;
    if (g < group && lane_on) {
      load_vec<T, EPL>(q + ((size_t)b * n_heads + (size_t)kvh * group + g) * hd + d0, tmp);
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = tmp[e] * scale;
  }

  float m[NG], l[NG], acc[NG][EPL];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = warp * U; t0 <= last; t0 += kWarps * U) {
    float kr[U][EPL], vr[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
      const int t = t0 + u;
      if (t <= last && lane_on) {
        load_vec<T, EPL>(kb + (size_t)t * hd + d0, kr[u]);
        load_vec<T, EPL>(vb + (size_t)t * hd + d0, vr[u]);
      }
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (g >= group) break;
      float s[U];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot += qr[g][e] * kr[u][e];
        dot = warp_sum(dot);
        s[u] = t0 + u <= last ? dot : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float corr = expf(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[u] - mx);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += p * vr[u][e];
      }
      m[g] = mx;
    }
  }

#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
    if (lane_on) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < group * hd; idx += kThreads) {
    const int g = idx / hd;
    const int d = idx - g * hd;
    float mt = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w][g]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - mt);
      lt += sm_l[w][g] * f;
      o += sm_acc[w][g][d] * f;
    }
    out[((size_t)b * n_heads + (size_t)kvh * group + g) * hd + d] =
        from_float<T>(o / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int NG, int EPL>
void launch_one(const void* q, const void* k, const void* v, const int* pos,
                void* out, int batch, int n_heads, int n_kv_heads, int t_len,
                int hd, int group, float scale, cudaStream_t s) {
  decode_attention_kernel<T, NG, EPL><<<dim3(n_kv_heads, batch), kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      pos, static_cast<T*>(out), n_heads, n_kv_heads, t_len, hd, group, scale);
}

template <typename T, int NG>
int launch_epl(const void* q, const void* k, const void* v, const int* pos,
               void* out, int batch, int n_heads, int n_kv_heads, int t_len,
               int hd, int group, float scale, cudaStream_t s) {
  if (hd <= 32) {
    launch_one<T, NG, 1>(q, k, v, pos, out, batch, n_heads, n_kv_heads, t_len, hd,
                         group, scale, s);
  } else if (hd <= 64) {
    if (hd % 2) return (int)cudaErrorInvalidValue;
    launch_one<T, NG, 2>(q, k, v, pos, out, batch, n_heads, n_kv_heads, t_len, hd,
                         group, scale, s);
  } else {
    if (hd % 4) return (int)cudaErrorInvalidValue;
    launch_one<T, NG, 4>(q, k, v, pos, out, batch, n_heads, n_kv_heads, t_len, hd,
                         group, scale, s);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out,
           int batch, int n_heads, int n_kv_heads, int t_len, int hd, int group,
           float scale, cudaStream_t s) {
  if (group <= 1)
    return launch_epl<T, 1>(q, k, v, pos, out, batch, n_heads, n_kv_heads, t_len, hd,
                            group, scale, s);
  if (group <= 2)
    return launch_epl<T, 2>(q, k, v, pos, out, batch, n_heads, n_kv_heads, t_len, hd,
                            group, scale, s);
  if (group <= 4)
    return launch_epl<T, 4>(q, k, v, pos, out, batch, n_heads, n_kv_heads, t_len, hd,
                            group, scale, s);
  return launch_epl<T, 8>(q, k, v, pos, out, batch, n_heads, n_kv_heads, t_len, hd,
                          group, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success); nothing here
// synchronises.  Refuses (cudaErrorInvalidValue) what the kernel does not
// take: hd past 128 or not a multiple of its per-lane width, more than 8
// query heads per KV head, H not a multiple of Hkv.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, int batch,
                                       int n_heads, int n_kv_heads, int t_len,
                                       int hd, float scale, int dtype,
                                       void* stream) {
  if (batch < 1 || n_kv_heads < 1 || n_heads % n_kv_heads || t_len < 1 || hd < 1 ||
      hd > kMaxHeadDim || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int group = n_heads / n_kv_heads;
  if (group < 1 || group > 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, p, out, batch, n_heads, n_kv_heads, t_len, hd,
                           group, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, p, out, batch, n_heads, n_kv_heads,
                                   t_len, hd, group, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
