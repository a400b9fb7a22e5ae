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
// of one dtype, each given by its base pointer and its batch, head and
// row strides in elements; the head dimension is contiguous.  So the
// model passes its (B, S, H, hd) projections as they are, without a
// transpose.  Query head h reads KV head h / (H / Hkv).  Causal means row
// i attends to columns j <= i (no offset, as in the reference, also when
// S != T).  Any S and T: the ragged last tiles are masked.  Logits,
// softmax statistics and the accumulator are fp32; the result is written
// in the input dtype with the output's strides.
//
// What bounds it on this card: 4 * B * H * S * T * hd operations (half
// that when causal) against about (2 * B * H * S + 2 * B * Hkv * T) * hd
// elements moved, so at the model's sequence lengths it is bound by
// arithmetic: the tensor cores' bf16 rate is the card's ceiling.
//
// Three kernels, chosen by dtype and head width before the launch (the
// wrapper calls one entry point; none is a fallback of another):
//
// bfloat16 -> flash_attention_bf16_launch, on the tensor cores.  A block
//   of three roles owns 128 query rows of one (sequence, head): one
//   producer warp issues TMA copies (Q once, then K and V tiles of 128
//   keys into a ring of three stages, completed on mbarriers); two consumer
//   warpgroups of 64 rows each compute S = Q K^T with wgmma (A and B from
//   shared memory, K-major), the fp32 online softmax in the accumulator
//   layout (a row lives in a quad of lanes: two shfl_xor reduce it), and
//   O += P V with wgmma taking P from registers, rounded to bf16, and V
//   from shared memory through the transpose bit (MN-major).  The tensor
//   maps are 4-D (hd, row, head, batch) over the caller's strides, so
//   strided views need no copy and TMA zero-fills rows past S and T
//   (columns >= T are still masked: a zero key gives logit 0, not -inf).
//   Head widths that are multiples of 64 are loaded as 64-column boxes
//   with the 128-byte swizzle; 16, 32 and 80 (Zamba2's heads: a 160-byte
//   row is no swizzle width) as 16-column boxes with the 32-byte swizzle,
//   one box per 16-deep wgmma step.  Tiles above the causal diagonal are
//   skipped and only tiles that cross it or the end of T are masked.
//   Compiled at every multiple of 16 up to 128 (16, 32, 48, 64, 80, 96,
//   112, 128): past 128 a 128-key tile ring of three stages no longer
//   fits a block's 227 KB of shared memory.
//
// float32 -> flash_attention_f32_launch, on the CUDA cores (the model's
//   float32 paths are held to 5e-5 of the reference; TF32 tensor cores
//   would not meet that): a block of 256 threads owns a 64-row query tile
//   and walks 64-row KV tiles staged in shared memory, each thread
//   computing a 4 x 4 block of scores and a 4 x (hd / 16) block of the
//   output, with the softmax statistics reduced by warp shuffles.
//   Compiled at hd 16, 32, 64, 80 and 128.
//
// any other head width from 1 to 256, either dtype ->
//   flash_attention_any_launch, on the CUDA cores: the float32 kernel's
//   tiling with hd a run-time argument (rows of hd + 1 floats in shared
//   memory, ~209 KB at hd 256), each thread holding ceil(hd / 16) output
//   columns of its 4 rows in registers (the instance is chosen by the
//   bound 4, 8 or 16 on that count), inputs converted to fp32 as they
//   are staged and the result converted back.  It reads through strides
//   with no alignment beyond the element's, so odd widths and strided
//   views need no copy.  Bounded by the CUDA cores' fp32 rate, it is the
//   slow route: it serves widths no model in the repository uses today.
//
// Both issue query tiles from the far end first, so the longest causal
// tiles start first.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;

struct Strides {
  long long b, h, s;
};

// ---- float32: CUDA cores ----------------------------------------------------

namespace cc {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRowsPerThread = 4;  // kBlockQ / 16
constexpr int kColsPerThread = 4;  // kBlockK / 16
constexpr float kNegInf = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBlockQ * (HD + 1) + (size_t)kBlockK * (HD + 1) +
                          (size_t)kBlockK * HD + (size_t)kBlockQ * (kBlockK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int n_heads,
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

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = threadIdx.x; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int row = q0 + r;
    q_s[r * (HD + 1) + d] = row < s_len ? qb[row * qs.s + d] * scale : 0.f;
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
      k_s[r * (HD + 1) + d] = ok ? kb[t * ks.s + d] : 0.f;
      v_s[r * HD + d] = ok ? vb[t * vs.s + d] : 0.f;
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
      ob[row * os.s + tx + 16 * e] = acc[i][e] / denom;
  }
}

template <int HD>
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
    err = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const int q_tiles = (s_len + kBlockQ - 1) / kBlockQ;
  flash_attention_kernel<HD><<<dim3(q_tiles, n_heads, batch), kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n_heads, n_kv_heads, s_len,
      t_len, qs, ks, vs, os, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace cc

// ---- any head width up to 256, float32 or bfloat16: CUDA cores ----------------

namespace anyw {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRowsPerThread = 4;
constexpr int kColsPerThread = 4;
constexpr int kMaxHeadDim = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

inline size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)kBlockQ * (hd + 1) + (size_t)kBlockK * (hd + 1) +
                          (size_t)kBlockK * hd + (size_t)kBlockQ * (kBlockK + 1));
}

// MAXD: the most output columns a thread holds per row (hd <= 16 * MAXD)
template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_any_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ o, int n_heads,
                               int n_kv_heads, int s_len, int t_len, int hd, Strides qs,
                               Strides ks, Strides vs, Strides os, int causal, float scale) {
  extern __shared__ float smem[];
  const int hp = hd + 1;
  float* q_s = smem;                    // kBlockQ x (hd + 1)
  float* k_s = q_s + kBlockQ * hp;      // kBlockK x (hd + 1)
  float* v_s = k_s + kBlockK * hp;      // kBlockK x hd
  float* p_s = v_s + kBlockK * hd;      // kBlockQ x (kBlockK + 1)

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv_heads);
  const int q0 = q_tile * kBlockQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int dpt = (hd + 15) / 16;  // output columns a thread holds (<= MAXD)

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = threadIdx.x; i < kBlockQ * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int row = q0 + r;
    q_s[r * hp + d] = row < s_len ? to_f(qb[row * qs.s + d]) * scale : 0.f;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][MAXD];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < MAXD; ++e) acc[i][e] = 0.f;
  }

  int n_tiles = (t_len + kBlockK - 1) / kBlockK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBlockQ - 1) / kBlockK + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    for (int i = threadIdx.x; i < kBlockK * hd; i += kThreads) {
      const int r = i / hd;
      const int d = i - r * hd;
      const int t = k0 + r;
      const bool ok = t < t_len;
      k_s[r * hp + d] = ok ? to_f(kb[t * ks.s + d]) : 0.f;
      v_s[r * hd + d] = ok ? to_f(vb[t * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) qv[i] = q_s[(ty * kRowsPerThread + i) * hp + d];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) kv[c] = k_s[(tx + 16 * c) * hp + d];
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
      for (int e = 0; e < MAXD; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBlockK; ++t) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = p_s[(ty * kRowsPerThread + i) * (kBlockK + 1) + t];
#pragma unroll
      for (int e = 0; e < MAXD; ++e) {
        const int d = tx + 16 * e;
        const float vv = e < dpt && d < hd ? v_s[t * hd + d] : 0.f;
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
    for (int e = 0; e < MAXD; ++e) {
      const int d = tx + 16 * e;
      if (e < dpt && d < hd) store(ob + row * os.s + d, acc[i][e] / denom);
    }
  }
}

template <typename T, int MAXD>
int launch_maxd(const void* q, const void* k, const void* v, void* o, int batch,
                int n_heads, int n_kv_heads, int s_len, int t_len, int hd, Strides qs,
                Strides ks, Strides vs, Strides os, int causal, float scale,
                cudaStream_t st) {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {  // room for the widest hd this instance takes
    err = cudaFuncSetAttribute(flash_attention_any_kernel<T, MAXD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes(16 * MAXD));
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const int q_tiles = (s_len + kBlockQ - 1) / kBlockQ;
  flash_attention_any_kernel<T, MAXD>
      <<<dim3(q_tiles, n_heads, batch), kThreads, smem_bytes(hd), st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(o), n_heads, n_kv_heads, s_len, t_len, hd, qs, ks, vs, os, causal,
          scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int n_heads,
           int n_kv_heads, int s_len, int t_len, int hd, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, float scale, cudaStream_t st) {
  if (hd < 1 || hd > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  if (hd <= 64)
    return launch_maxd<T, 4>(q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len, hd, qs,
                             ks, vs, os, causal, scale, st);
  if (hd <= 128)
    return launch_maxd<T, 8>(q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len, hd, qs,
                             ks, vs, os, causal, scale, st);
  return launch_maxd<T, 16>(q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len, hd, qs, ks,
                            vs, os, causal, scale, st);
}

}  // namespace anyw

// ---- bfloat16: tensor cores (wgmma + TMA) -----------------------------------

namespace tc {

constexpr int kBM = 128;              // query rows per block
constexpr int kBN = 128;              // keys per K/V tile
constexpr int kStages = 3;            // K/V tiles in flight
constexpr int kConsumerWarps = 8;     // two warpgroups of 64 query rows
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory layout of one head width.  A tile of R rows is stored
// as HD / kCW boxes of R x kCW elements, each box swizzled by TMA; the
// wgmma descriptors describe the same swizzle (layout 1: 128 B, 3: 32 B).
template <int HD>
struct Tile {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int kCW = HD % 64 == 0 ? 64 : 16;  // columns per box: one swizzle row
  static constexpr int kBoxes = HD / kCW;
  static constexpr uint64_t kLayout = kCW == 64 ? 1 : 3;
  static constexpr uint32_t kAtom = 8 * kCW * 2;  // bytes of 8 swizzled rows
  static constexpr uint32_t kQBox = kBM * kCW * 2;
  static constexpr uint32_t kKVBox = kBN * kCW * 2;
  static constexpr uint32_t kQBytes = kQBox * kBoxes;
  static constexpr uint32_t kKVBytes = kKVBox * kBoxes;  // one of K or V
  // 1 KB of slack to align the tiles to the 128-byte swizzle's 1 KB
  // period, then Q, the K ring, the V ring and the barriers
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
  static_assert(kSmem <= 232448, "past the shared memory a block can have");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (hd, row, head, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(head),
      "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins the accumulators' reads and writes to their side of a wgmma
// fence or wait (no data dependence tells the compiler otherwise)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (+)= A * B, A and B K-major in shared memory; m64n128k16, fp32 accumulators
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A * B, A (bf16 pairs) in registers, B MN-major in shared memory (the
// transpose bit); m64n16k16, fp32 accumulators
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A * B, A (bf16 pairs) in registers, B MN-major in shared memory (the
// transpose bit); m64n32k16, fp32 accumulators
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A * B, A (bf16 pairs) in registers, B MN-major in shared memory (the
// transpose bit); m64n64k16, fp32 accumulators
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A * B, A (bf16 pairs) in registers, B MN-major in shared memory (the
// transpose bit); m64n80k16, fp32 accumulators
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A * B, A (bf16 pairs) in registers, B MN-major in shared memory (the
// transpose bit); m64n48k16, fp32 accumulators
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A * B, A (bf16 pairs) in registers, B MN-major in shared memory (the
// transpose bit); m64n96k16, fp32 accumulators
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A * B, A (bf16 pairs) in registers, B MN-major in shared memory (the
// transpose bit); m64n112k16, fp32 accumulators
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A * B, A (bf16 pairs) in registers, B MN-major in shared memory (the
// transpose bit); m64n128k16, fp32 accumulators
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) {
    wgmma_rs_n16(d, a, db);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, db);
  } else if constexpr (N == 48) {
    wgmma_rs_n48(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 80) {
    wgmma_rs_n80(d, a, db);
  } else if constexpr (N == 96) {
    wgmma_rs_n96(d, a, db);
  } else if constexpr (N == 112) {
    wgmma_rs_n112(d, a, db);
  } else {
    static_assert(N == 128, "unsupported head dim");
    wgmma_rs_n128(d, a, db);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              __nv_bfloat16* __restrict__ o, int n_heads, int n_kv_heads,
                              int s_len, int t_len, Strides os, int causal,
                              float scale_log2) {
  using G = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + G::kQBytes;            // kStages K tiles
  const uint32_t v_s = k_s + kStages * G::kKVBytes;  // kStages V tiles
  const uint32_t q_bar = v_s + kStages * G::kKVBytes;
  const uint32_t full_bar = q_bar + 8;               // + 8 * stage: K and V landed
  const uint32_t empty_bar = full_bar + 8 * kStages;  // + 8 * stage: consumed

  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv_heads);
  const int q0 = q_tile * kBM;
  int n_tiles = (t_len + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBM, s_len) - 1) / kBN + 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(q_bar, G::kQBytes);
      for (int c = 0; c < G::kBoxes; ++c)
        tma_load(q_s + c * G::kQBox, &tm_q, q_bar, c * G::kCW, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(empty_bar + 8 * st, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * st, 2 * G::kKVBytes);
        for (int c = 0; c < G::kBoxes; ++c) {
          const uint32_t off = st * G::kKVBytes + c * G::kKVBox;
          tma_load(k_s + off, &tm_k, full_bar + 8 * st, c * G::kCW, j * kBN, kvh, b);
          tma_load(v_s + off, &tm_v, full_bar + 8 * st, c * G::kCW, j * kBN, kvh, b);
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns rows q0 + 64 wg .. + 63; in the wgmma
  // accumulator layout this thread holds rows row0 and row0 + 8, and of
  // each 8-column block the columns 2 tq and 2 tq + 1
  const int wg = warp >> 2;
  const int tq = lane & 3;
  const int row0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const uint32_t q_wg = q_s + wg * 64 * G::kCW * 2;
  float acc[HD / 2];
  float s[kBN / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) s[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sum

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(full_bar + 8 * st, (j / kStages) & 1);
    const uint32_t k_t = k_s + st * G::kKVBytes;
    const uint32_t v_t = v_s + st * G::kKVBytes;

    // S = Q K^T over hd in 16-deep steps
    wg_fence();
    fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t box = kk * 16 / G::kCW;
      const uint32_t in_row = (kk * 16 % G::kCW) * 2;  // bytes into the swizzled row
      wgmma_ss_n128(s,
                    smem_desc(q_wg + box * G::kQBox + in_row, 16, G::kAtom, G::kLayout),
                    smem_desc(k_t + box * G::kKVBox + in_row, 16, G::kAtom, G::kLayout),
                    kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    const int col0 = j * kBN;
    if (col0 + kBN > t_len || (causal && col0 + kBN - 1 > q0 + wg * 64)) {
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + 8 * i + 2 * tq + e;
            if (col >= t_len || (causal && col > row0 + 8 * r)) s[4 * i + 2 * r + e] = -INFINITY;
          }
    }

    // online softmax, fp32, in base 2
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i)
        mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float m_sc = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      const float corr = fast_exp2(m_run[r] * scale_log2 - m_sc);
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(fmaf(s[4 * i + 2 * r + e], scale_log2, -m_sc));
          s[4 * i + 2 * r + e] = p;
          sum += p;
        }
      l_run[r] = l_run[r] * corr + sum;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[4 * i + 2 * r] *= corr;
        acc[4 * i + 2 * r + 1] *= corr;
      }
    }

    // P as the A operand: the accumulator's 16-column slice kk is exactly
    // the A fragment of the kk-th 16-deep step
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);

    // O += P V over the tile's keys in 16-deep steps
    wg_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs<HD>(acc, pa[kk],
                   smem_desc(v_t + kk * 16 * G::kCW * 2, G::kKVBox, G::kAtom, G::kLayout));
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * st);
  }

  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = row0 + 8 * r;
    if (row >= s_len) continue;
    __nv_bfloat16* orow = ob + row * os.s + 2 * tq;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime so
// that the library needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// (hd, rows, heads, batch) over the caller's strides (elements), boxes of
// kCW columns x box_rows rows
template <int HD>
bool encode(CUtensorMap* map, const void* ptr, int rows, int heads, int batch, Strides st,
            int box_rows) {
  using G = Tile<HD>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::kCW, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             G::kCW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int batch, int n_heads,
              int n_kv_heads, int s_len, int t_len, Strides qs, Strides ks, Strides vs,
              Strides os, int causal, float scale, cudaStream_t st) {
  using G = Tile<HD>;
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(flash_attention_tc_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode<HD>(&tm_q, q, s_len, n_heads, batch, qs, kBM) ||
      !encode<HD>(&tm_k, k, t_len, n_kv_heads, batch, ks, kBN) ||
      !encode<HD>(&tm_v, v, t_len, n_kv_heads, batch, vs, kBN)) {
    return (int)cudaErrorInvalidValue;
  }
  const int q_tiles = (s_len + kBM - 1) / kBM;
  flash_attention_tc_kernel<HD><<<dim3(q_tiles, n_heads, batch), kThreads, G::kSmem, st>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), n_heads, n_kv_heads, s_len, t_len,
      os, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tc

// the head width's instance of the float32 CUDA-core launcher
#define FA_DISPATCH_CC(hd, ...)                       \
  switch (hd) {                                       \
    case 16:                                          \
      return cc::launch_hd<16>(__VA_ARGS__);          \
    case 32:                                          \
      return cc::launch_hd<32>(__VA_ARGS__);          \
    case 64:                                          \
      return cc::launch_hd<64>(__VA_ARGS__);          \
    case 80:                                          \
      return cc::launch_hd<80>(__VA_ARGS__);          \
    case 128:                                         \
      return cc::launch_hd<128>(__VA_ARGS__);         \
    default:                                          \
      return (int)cudaErrorInvalidValue;              \
  }

// the head width's instance of the tensor-core launcher: every multiple
// of 16 up to 128
#define FA_DISPATCH_TC(hd, ...)                       \
  switch (hd) {                                       \
    case 16:                                          \
      return tc::launch_hd<16>(__VA_ARGS__);          \
    case 32:                                          \
      return tc::launch_hd<32>(__VA_ARGS__);          \
    case 48:                                          \
      return tc::launch_hd<48>(__VA_ARGS__);          \
    case 64:                                          \
      return tc::launch_hd<64>(__VA_ARGS__);          \
    case 80:                                          \
      return tc::launch_hd<80>(__VA_ARGS__);          \
    case 96:                                          \
      return tc::launch_hd<96>(__VA_ARGS__);          \
    case 112:                                         \
      return tc::launch_hd<112>(__VA_ARGS__);         \
    case 128:                                         \
      return tc::launch_hd<128>(__VA_ARGS__);         \
    default:                                          \
      return (int)cudaErrorInvalidValue;              \
  }

bool shape_ok(int batch, int n_heads, int n_kv_heads, int s_len, int t_len) {
  return batch >= 1 && batch <= 65535 && n_heads >= 1 && n_heads <= 65535 &&
         n_kv_heads >= 1 && n_heads % n_kv_heads == 0 && s_len >= 1 && t_len >= 1;
}

}  // namespace

// Strides are in elements, in the order (batch, head, row).  Each entry
// point launches on `stream` and returns cudaGetLastError() after the
// launch (0 on success); nothing here synchronises.  Each refuses
// (cudaErrorInvalidValue) a head dim it was not compiled for (float32:
// 16, 32, 64, 80, 128; bfloat16: the multiples of 16 up to 128; the
// any-width kernel: 1 to 256), or H not a multiple of Hkv.

// float32 inputs, on the CUDA cores
extern "C" int flash_attention_f32_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int n_heads,
    int n_kv_heads, int s_len, int t_len, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, float scale, void* stream) {
  if (!shape_ok(batch, n_heads, n_kv_heads, s_len, t_len)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  FA_DISPATCH_CC(hd, q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len, qs, ks, vs, os,
                 causal, scale, static_cast<cudaStream_t>(stream))
}

// bfloat16 inputs, on the tensor cores.  TMA's preconditions, which the
// wrapper checks first: q, k and v 16-byte aligned, and every stride of a
// dimension longer than 1 a multiple of 8 elements (16 bytes); the output
// 4-byte aligned with even strides.
extern "C" int flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int n_heads,
    int n_kv_heads, int s_len, int t_len, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, float scale, void* stream) {
  if (!shape_ok(batch, n_heads, n_kv_heads, s_len, t_len)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  FA_DISPATCH_TC(hd, q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len, qs, ks, vs, os,
                 causal, scale, static_cast<cudaStream_t>(stream))
}

// float32 (dtype 0) or bfloat16 (dtype 1) inputs at any head width from 1
// to 256, on the CUDA cores; the element's own alignment suffices.
extern "C" int flash_attention_any_launch(
    const void* q, const void* k, const void* v, void* o, int batch, int n_heads,
    int n_kv_heads, int s_len, int t_len, int hd, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, float scale, int dtype, void* stream) {
  if (!shape_ok(batch, n_heads, n_kv_heads, s_len, t_len)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return anyw::launch<float>(q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len, hd, qs,
                                 ks, vs, os, causal, scale, st);
    case 1:
      return anyw::launch<__nv_bfloat16>(q, k, v, o, batch, n_heads, n_kv_heads, s_len, t_len,
                                         hd, qs, ks, vs, os, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
