// Mamba2 SSD chunk scan for Hopper (sm_90a): the state-space recurrence
//   h_t = exp(dt_t * a) * h_t-1 + (dt_t * x_t) B_t^T,   y_t = h_t C_t
// of one head over a whole sequence, in its chunked dual form, with the
// (P, N) fp32 state kept in shared memory from one tile of rows to the next.
//
// Replaces src/repro/kernels/ssd_scan.py::_ssd_kernel (launched by
// ssd_scan_pallas on a (batch, heads) grid, walking 128-row chunks with a
// fori_loop that carries the state in VMEM scratch).
//
// Contract (the model's, repro/models/ssm.py::ssd_chunked with h0 = None,
// not the Pallas kernel's): x (B, S, H, P) in float or bfloat16, dt
// (B, S, H) fp32 (post-softplus), a (H,) fp32 (negative), bm and cm
// (B, S, N) in x's dtype; each given by its base pointer and its strides in
// elements (the last dim contiguous), so the model hands over its slices of
// the conv output without a copy.  Writes y (B, S, H, P) fp32 and the final
// state h_last (B, H, P, N) fp32, both contiguous; the state starts at zero.
// Any S >= 1: the rows of a ragged last tile are read as dt = 0, x = B = C
// = 0, so they add no input and no decay.
//
// Per tile of Q = 64 rows, with cum the tile's inclusive prefix sum of
// dt * a (all sums and products in fp32):
//   S_ij   = (C_i . B_j) * exp(cum_i - cum_j)            for j <= i, else 0
//   y_i    = sum_j S_ij (dt_j x_j) + exp(cum_i) * (h C_i)
//   h     <- exp(cum_Q-1) * h + sum_j exp(cum_Q-1 - cum_j) (dt_j x_j) B_j^T
//
// What bounds it on this card: it reads x, B and C once and writes an
// fp32 y, so by bytes it is memory-bound (about 25 us at Mamba2-130M's
// prefill of 4 x 2048 tokens); its 4 P N + Q (N + P) operations per row
// and head would take a few us on the tensor cores.
//
// What the design does about it, for now: one block of 256 threads per
// (sequence, head), so the state never leaves shared memory; tiles of x*dt,
// B, C, the Q x Q scores and the state are staged in dynamic shared memory
// as fp32 (about 130 KB at P = 64, N = 128, through cudaFuncSetAttribute).
// Each product runs on the CUDA cores in fp32 with a 16 x 16 thread grid,
// a thread owning a small block of rows and every 16th column, so that the
// lanes of a warp read neighbouring words.  Score blocks above the diagonal
// are skipped whole warps at a time, and the intra-tile product walks
// only j <= i.  Tensor-core tiles and one C.B^T shared by the heads (B and
// C have one group) are the redesign this kernel waits for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;  // rows per tile
constexpr int kRowsPerThread = kQ / 16;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Strides3 {
  long long b, s, h;
};

template <int P, int N>
constexpr size_t smem_floats() {
  return (size_t)kQ * P                   // xd: x * dt, (Q, P)
         + 2 * (size_t)kQ * (N + 1)       // B and C tiles, (Q, N + 1)
         + (size_t)P * (N + 1)            // the state, (P, N + 1)
         + (size_t)kQ * (kQ + 1)          // scores, (Q, Q + 1)
         + 2 * (size_t)kQ;                // cum, decay to the tile's end
}

// Scores of one warp's rows against the first NC column blocks of 16; the
// blocks past them lie above the diagonal for every row of the warp.
template <int N, int NC>
__device__ __forceinline__ void scores_part(const float* c_s, const float* b_s,
                                            const float* cum, float* s_s, int ty,
                                            int tx) {
  float acc[kRowsPerThread][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    float cv[kRowsPerThread], bv[NC];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) cv[r] = c_s[(ty * kRowsPerThread + r) * (N + 1) + n];
#pragma unroll
    for (int c = 0; c < NC; ++c) bv[c] = b_s[(tx + 16 * c) * (N + 1) + n];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] += cv[r] * bv[c];
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = ty * kRowsPerThread + r;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = tx + 16 * c;
      s_s[i * (kQ + 1) + j] = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) : 0.f;
    }
  }
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, float* __restrict__ y,
                    float* __restrict__ h_last, int seq, int heads, Strides3 xs,
                    Strides3 ds, Strides3 bs, Strides3 cs) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N must be multiples of 16");
  constexpr int kPC = P / 16;  // y columns per thread
  constexpr int kPR = P / 16;  // state rows per thread
  constexpr int kNC = N / 16;  // state columns per thread
  extern __shared__ float smem[];
  float* xd_s = smem;                       // (Q, P)
  float* b_s = xd_s + kQ * P;               // (Q, N + 1)
  float* c_s = b_s + kQ * (N + 1);          // (Q, N + 1)
  float* h_s = c_s + kQ * (N + 1);          // (P, N + 1)
  float* s_s = h_s + P * (N + 1);           // (Q, Q + 1)
  float* cum = s_s + kQ * (kQ + 1);         // (Q,)
  float* w_end = cum + kQ;                  // (Q,)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float a_h = a[h];

  const T* xb = x + b * xs.b + h * xs.h;
  const float* db = dt + b * ds.b + h * ds.h;
  const T* bb = bm + b * bs.b;
  const T* cb = cm + b * cs.b;
  float* yb = y + ((size_t)b * seq * heads + h) * P;

  for (int i = tid; i < P * (N + 1); i += kThreads) h_s[i] = 0.f;

  const int n_tiles = (seq + kQ - 1) / kQ;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * kQ;
    __syncthreads();  // the previous tile's reads of every buffer are done
    if (tid < kQ) {
      const int t = s0 + tid;
      cum[tid] = t < seq ? db[(long long)t * ds.s] * a_h : 0.f;
    }
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P;
      const int p = i - r * P;
      const int t = s0 + r;
      xd_s[i] = t < seq ? to_float(xb[(long long)t * xs.s + p]) * db[(long long)t * ds.s] : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N;
      const int n = i - r * N;
      const int t = s0 + r;
      const bool ok = t < seq;
      b_s[r * (N + 1) + n] = ok ? to_float(bb[(long long)t * bs.s + n]) : 0.f;
      c_s[r * (N + 1) + n] = ok ? to_float(cb[(long long)t * cs.s + n]) : 0.f;
    }
    __syncthreads();
    // inclusive prefix sum of dt * a over the tile's 64 rows: warp 0, two
    // rows a lane
    if (warp == 0) {
      const float v0 = cum[2 * lane];
      const float v1 = cum[2 * lane + 1];
      float run = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += o;
      }
      float before = __shfl_up_sync(0xffffffffu, run, 1);
      if (lane == 0) before = 0.f;
      cum[2 * lane] = before + v0;
      cum[2 * lane + 1] = run;
      const float last = __shfl_sync(0xffffffffu, run, 31);
      w_end[2 * lane] = expf(last - (before + v0));
      w_end[2 * lane + 1] = expf(last - run);
    }
    __syncthreads();

    // scores, the lower triangle: warp w owns rows 8w .. 8w + 7
    switch ((8 * warp + 7) / 16) {
      case 0: scores_part<N, 1>(c_s, b_s, cum, s_s, ty, tx); break;
      case 1: scores_part<N, 2>(c_s, b_s, cum, s_s, ty, tx); break;
      case 2: scores_part<N, 3>(c_s, b_s, cum, s_s, ty, tx); break;
      default: scores_part<N, 4>(c_s, b_s, cum, s_s, ty, tx); break;
    }
    __syncthreads();

    // y = S (x dt) + exp(cum) * (C h^T); rows 4ty .. 4ty + 3, columns tx + 16c
    {
      float acc[kRowsPerThread][kPC], off[kRowsPerThread][kPC];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int c = 0; c < kPC; ++c) acc[r][c] = off[r][c] = 0.f;
      const int j_end = 8 * warp + 8;  // the warp's last row + 1; S is 0 past i
#pragma unroll 4
      for (int j = 0; j < j_end; ++j) {
        float sv[kRowsPerThread], xv[kPC];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) sv[r] = s_s[(ty * kRowsPerThread + r) * (kQ + 1) + j];
#pragma unroll
        for (int c = 0; c < kPC; ++c) xv[c] = xd_s[j * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
          for (int c = 0; c < kPC; ++c) acc[r][c] += sv[r] * xv[c];
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[kRowsPerThread], hv[kPC];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) cv[r] = c_s[(ty * kRowsPerThread + r) * (N + 1) + n];
#pragma unroll
        for (int c = 0; c < kPC; ++c) hv[c] = h_s[(tx + 16 * c) * (N + 1) + n];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
          for (int c = 0; c < kPC; ++c) off[r][c] += cv[r] * hv[c];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = ty * kRowsPerThread + r;
        const int t = s0 + i;
        if (t >= seq) continue;
        const float decay_in = expf(cum[i]);
        float* yrow = yb + (size_t)t * heads * P;
#pragma unroll
        for (int c = 0; c < kPC; ++c) yrow[tx + 16 * c] = acc[r][c] + decay_in * off[r][c];
      }
    }
    __syncthreads();  // every read of the entering state is done

    // h <- exp(cum_last) h + (x dt * w_end)^T B; rows ty * P/16 + r, columns
    // tx + 16c; each thread reads and writes only its own elements
    {
      const float decay_all = expf(cum[kQ - 1]);
      float acc[kPR][kNC];
#pragma unroll
      for (int r = 0; r < kPR; ++r)
#pragma unroll
        for (int c = 0; c < kNC; ++c) acc[r][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kQ; ++j) {
        const float wj = w_end[j];
        float xv[kPR], bv[kNC];
#pragma unroll
        for (int r = 0; r < kPR; ++r) xv[r] = xd_s[j * P + ty * kPR + r] * wj;
#pragma unroll
        for (int c = 0; c < kNC; ++c) bv[c] = b_s[j * (N + 1) + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < kPR; ++r)
#pragma unroll
          for (int c = 0; c < kNC; ++c) acc[r][c] += xv[r] * bv[c];
      }
#pragma unroll
      for (int r = 0; r < kPR; ++r)
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          float* hp = h_s + (ty * kPR + r) * (N + 1) + tx + 16 * c;
          *hp = decay_all * *hp + acc[r][c];
        }
    }
  }
  __syncthreads();
  float* hb = h_last + ((size_t)b * heads + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N;
    hb[i] = h_s[p * (N + 1) + (i - p * N)];
  }
}

template <typename T, int P, int N>
int launch_pn(const void* x, const float* dt, const float* a, const void* bm,
              const void* cm, float* y, float* h_last, int batch, int seq, int heads,
              Strides3 xs, Strides3 ds, Strides3 bs, Strides3 cs, cudaStream_t st) {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  constexpr size_t bytes = smem_floats<P, N>() * sizeof(float);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(ssd_scan_kernel<T, P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  ssd_scan_kernel<T, P, N><<<dim3(heads, batch), kThreads, bytes, st>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), y, h_last, seq, heads, xs, ds, bs, cs);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_p(const void* x, const float* dt, const float* a, const void* bm,
             const void* cm, float* y, float* h_last, int batch, int seq, int heads,
             int n, Strides3 xs, Strides3 ds, Strides3 bs, Strides3 cs,
             cudaStream_t st) {
  switch (n) {
    case 16:
      return launch_pn<T, P, 16>(x, dt, a, bm, cm, y, h_last, batch, seq, heads, xs, ds,
                                 bs, cs, st);
    case 32:
      return launch_pn<T, P, 32>(x, dt, a, bm, cm, y, h_last, batch, seq, heads, xs, ds,
                                 bs, cs, st);
    case 64:
      return launch_pn<T, P, 64>(x, dt, a, bm, cm, y, h_last, batch, seq, heads, xs, ds,
                                 bs, cs, st);
    case 128:
      return launch_pn<T, P, 128>(x, dt, a, bm, cm, y, h_last, batch, seq, heads, xs,
                                  ds, bs, cs, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bm,
           const void* cm, float* y, float* h_last, int batch, int seq, int heads,
           int p, int n, Strides3 xs, Strides3 ds, Strides3 bs, Strides3 cs,
           cudaStream_t st) {
  switch (p) {
    case 16:
      return launch_p<T, 16>(x, dt, a, bm, cm, y, h_last, batch, seq, heads, n, xs, ds,
                             bs, cs, st);
    case 32:
      return launch_p<T, 32>(x, dt, a, bm, cm, y, h_last, batch, seq, heads, n, xs, ds,
                             bs, cs, st);
    case 64:
      return launch_p<T, 64>(x, dt, a, bm, cm, y, h_last, batch, seq, heads, n, xs, ds,
                             bs, cs, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, bm and cm; dt, a, y and h_last
// are float32).  Strides are in elements, in the order (batch, row, head);
// bm and cm have no head stride.  Launches on `stream` and returns
// cudaGetLastError() after the launch (0 on success); nothing here
// synchronises.  Refuses (cudaErrorInvalidValue) P other than 16, 32 or
// 64 and N other than 16, 32, 64 or 128.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y, void* h_last,
                               int batch, int seq, int heads, int p, int n,
                               long long x_sb, long long x_ss, long long x_sh,
                               long long dt_sb, long long dt_ss, long long dt_sh,
                               long long b_sb, long long b_ss, long long c_sb,
                               long long c_ss, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || seq < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides3 xs{x_sb, x_ss, x_sh}, ds{dt_sb, dt_ss, dt_sh}, bs{b_sb, b_ss, 0},
      cs{c_sb, c_ss, 0};
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_last);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, dtf, af, bm, cm, yf, hf, batch, seq, heads, p, n, xs, ds,
                           bs, cs, st);
    case 1:
      return launch<__nv_bfloat16>(x, dtf, af, bm, cm, yf, hf, batch, seq, heads, p, n,
                                   xs, ds, bs, cs, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
