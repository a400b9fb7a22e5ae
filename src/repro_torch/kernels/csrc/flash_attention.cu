// Flash attention (prefill) for Hopper (sm_90a): grouped-query attention
// over whole sequences, causal or not, without materialising the S x T
// score matrix.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (launched
// by flash_attention_pallas on a (batch, q_heads, S / 128) grid, walking
// 128-row KV blocks with the online-softmax recurrence and skipping the
// blocks above the causal diagonal).
//
// Contract: q (B, H, S, hd), k and v (B, Hkv, T, hd), out (B, H, S, hd),
// of one dtype (float or bfloat16), each given by its base pointer and
// its batch, head and row strides in elements; the head dimension is
// contiguous.  So the model passes its (B, S, H, hd) projections as they
// are, without a transpose.  Query head h reads KV head h / (H / Hkv).
// Causal means row i attends to columns j <= i (no offset, as in the
// reference, also when S != T).  Any S and T: the ragged last tiles are
// masked.  Logits, softmax and the weighted sum of V run in fp32; the
// result is cast back to the input dtype.
//
// What bounds it on this card: 4 * B * H * S * T * hd operations (half
// that when causal) against about (2 * B * H * S + 2 * B * Hkv * T) * hd
// elements moved, so at the model's sequence lengths it is bound by
// arithmetic: the tensor cores' bf16 rate is the card's ceiling.
//
// What the design does about it, for now: a block of 256 threads owns a
// 64-row query tile of one (sequence, head) and walks 64-row KV tiles
// staged in shared memory as fp32, skipping every tile above the causal
// diagonal; each thread computes a 4 x 4 block of scores and keeps a
// 4 x (hd / 16) block of the output accumulator in registers, with the
// online-softmax row statistics reduced across the 16 threads of a row by
// warp shuffles.  The products run on the CUDA cores in fp32, well below
// the tensor cores' rate: mma.sync / wgmma tiles fed by TMA are the
// redesign this kernel waits for.  Query tiles are issued from the
// diagonal's far end first, so the longest causal tiles start first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRowsPerThread = 4;  // kBlockQ / 16
constexpr int kColsPerThread = 4;  // kBlockK / 16
constexpr float kNegInf = -1e30f;
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

struct Strides {
  long long b, h, s;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBlockQ * (HD + 1) + (size_t)kBlockK * (HD + 1) +
                          (size_t)kBlockK * HD + (size_t)kBlockQ * (kBlockK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int n_heads,
                           int n_kv_heads, int s_len, int t_len, Strides qs,
                           Strides ks, Strides vs, Strides os, int causal,
                           float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kDPerThread = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                              // kBlockQ x (HD + 1)
  float* k_s = q_s + kBlockQ * (HD + 1);          // kBlockK x (HD + 1)
  float* v_s = k_s + kBlockK * (HD + 1);          // kBlockK x HD
  float* p_s = v_s + kBlockK * HD;                // kBlockQ x (kBlockK + 1)

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv_heads);
  const int q0 = q_tile * kBlockQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = threadIdx.x; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int row = q0 + r;
    q_s[r * (HD + 1) + d] = row < s_len ? to_float(qb[row * qs.s + d]) * scale : 0.f;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][kDPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPerThread; ++e) acc[i][e] = 0.f;
  }

  int n_tiles = (t_len + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockQ - 1) / kBlockK + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    for (int i = threadIdx.x; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD;
      const int d = i - r * HD;
      const int t = k0 + r;
      const bool ok = t < t_len;
      k_s[r * (HD + 1) + d] = ok ? to_float(kb[t * ks.s + d]) : 0.f;
      v_s[r * HD + d] = ok ? to_float(vb[t * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = q_s[(ty * kRowsPerThread + i) * (HD + 1) + d];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) kv[c] = k_s[(tx + 16 * c) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) s[i][c] += qv[i] * kv[c];
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty * kRowsPerThread + i;
      const int row = q0 + r;
      float mx = m[i];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int col = k0 + tx + 16 * c;
        if (col >= t_len || (causal && col > row)) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m[i] - mx);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const float p = expf(s[i][c] - mx);
        p_s[r * (kBlockK + 1) + tx + 16 * c] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = mx;
#pragma unroll
      for (int e = 0; e < kDPerThread; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBlockK; ++t) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = p_s[(ty * kRowsPerThread + i) * (kBlockK + 1) + t];
#pragma unroll
      for (int e = 0; e < kDPerThread; ++e) {
        const float vv = v_s[t * HD + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i][e] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = q0 + ty * kRowsPerThread + i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < kDPerThread; ++e)
      ob[row * os.s + tx + 16 * e] = from_float<T>(acc[i][e] / denom);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int batch,
              int n_heads, int n_kv_heads, int s_len, int t_len, Strides qs,
              Strides ks, Strides vs, Strides os, int causal, float scale,
              cudaStream_t st) {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  constexpr size_t bytes = smem_bytes<HD>();
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const int q_tiles = (s_len + kBlockQ - 1) / kBlockQ;
  flash_attention_kernel<T, HD><<<dim3(q_tiles, n_heads, batch), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), n_heads, n_kv_heads, s_len, t_len, qs, ks, vs, os, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n_heads, int n_kv_heads, int s_len, int t_len, int hd, Strides qs,
           Strides ks, Strides vs, Strides os, int causal, float scale,
           cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len,
                              qs, ks, vs, os, causal, scale, st);
    case 32:
      return launch_hd<T, 32>(q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len,
                              qs, ks, vs, os, causal, scale, st);
    case 64:
      return launch_hd<T, 64>(q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len,
                              qs, ks, vs, os, causal, scale, st);
    case 80:
      return launch_hd<T, 80>(q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len,
                              qs, ks, vs, os, causal, scale, st);
    case 128:
      return launch_hd<T, 128>(q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len,
                               qs, ks, vs, os, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, in the order
// (batch, head, row).  Launches on `stream` and returns cudaGetLastError()
// after the launch (0 on success); nothing here synchronises.  Refuses
// (cudaErrorInvalidValue) a head dim other than 16, 32, 64, 80 or 128, or H
// not a multiple of Hkv.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int n_heads,
    int n_kv_heads, int s_len, int t_len, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, float scale, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || n_heads < 1 || n_heads > 65535 ||
      n_kv_heads < 1 || n_heads % n_kv_heads || s_len < 1 || t_len < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len, hd,
                           qs, ks, vs, os, causal, scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, o, batch, n_heads, n_kv_heads, s_len,
                                   t_len, hd, qs, ks, vs, os, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
