// Mamba2 SSD chunk scan for Hopper (sm_90a): the state-space recurrence
//   h_t = exp(dt_t * a) * h_t-1 + (dt_t * x_t) B_t^T,   y_t = h_t C_t
// of every head over whole sequences, in its chunked dual form.
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
// Any S >= 1: the rows of a ragged last chunk are read as dt = 0, x = B = C
// = 0, so they add no input and no decay.
//
// Per chunk of Q = 64 rows, with cum the chunk's inclusive prefix sum of
// dt * a (all sums and products in fp32):
//   S_ij   = (C_i . B_j) * exp(cum_i - cum_j)            for j <= i, else 0
//   y_i    = sum_j S_ij (dt_j x_j) + exp(cum_i) * (h C_i)
//   h     <- exp(cum_Q-1) * h + sum_j exp(cum_Q-1 - cum_j) (dt_j x_j) B_j^T
//
// What bounds it on this card: it reads x, B and C once and writes an
// fp32 y, so by bytes it is memory-bound (about 25 us at Mamba2-130M's
// prefill of 4 x 2048 tokens); its 4 P N + Q (N + P) operations per row
// and head take a few us on the tensor cores.
//
// bfloat16 inputs (the models' prefill) take two launches, on the
// decomposition of the reference model's ssd_chunked (chunk states, their
// carry across chunks, then y per chunk):
//   1. ssd_state_kernel, one block per (sequence, head, 16 rows of the
//      state) walking the chunks in order: each chunk's local state
//      sum_j w_j (dt_j x_j) B_j^T with
//      w_j = exp(cum_Q-1 - cum_j), then h <- exp(cum_Q-1) h + local, the
//      carried state held in registers; the state entering each chunk goes
//      to an fp32 scratch (B, chunks, H, P, N), written once;
//   2. ssd_chunk_scan_kernel, one block per (chunk, sequence, group of
//      heads), every chunk in parallel: C.B^T once for the block (B and C
//      have one group, so every head shares it) and kept in registers,
//      then per head y = (S o dt) x + exp(cum) (C h^T), the entering state
//      read once.
// Every product runs on the tensor cores as bf16 mma.sync m16n8k16 with
// fp32 accumulation.  C.B^T is exact: both operands arrive in bf16.  In
// the other three one operand is exact bf16 (x, B or C) and the other is
// fp32 (the decayed scores, x dt w, the carried state); that one is split
// into three bf16 terms hi + mid + lo, which hold its 24 bits, and the
// product is the sum of three mma's, so each product keeps fp32 accuracy.
// The scratch crosses device memory twice (written, read).  Global tiles
// are loaded 16 bytes a piece where the tensor's alignment allows (else
// element by element into the same pieces), all of a thread's loads
// issued before it waits; step 1 loads the next chunk while computing
// this one.

// float32 inputs stay on the CUDA cores, one block of 256 threads per
// (sequence, head) walking the 64-row tiles in order with the (P, N) state
// in shared memory: a split of both fp32 operands would take six mma's per
// product.  Tiles of x*dt, B, C, the Q x Q scores and the state are staged
// in dynamic shared memory as fp32 (about 130 KB at P = 64, N = 128); each
// product runs with a 16 x 16 thread grid, score blocks above the diagonal
// skipped whole warps at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;  // rows per tile
constexpr int kRowsPerThread = kQ / 16;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float v) { return v; }

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

// ---- bfloat16: chunk-parallel, on the tensor cores --------------------------

constexpr int kTcThreads = 128;      // four warps; warp w owns rows 16w..16w+15
constexpr int kPadQ = kQ + 8;        // bf16 row pitch of Q-wide tiles
constexpr int kMaxHeadsPerBlock = 8;
constexpr int kMinBlocks = 4 * 132;  // heads per block shrink until the grid has this many

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned ld_u32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack2(bf16 lo, bf16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

// v = hi + mid + lo to within 2^-24 |v|: each term the bf16 rounding of
// what the terms before it left over (the differences are exact in fp32)
__device__ __forceinline__ void split3(float v, bf16 (&o)[3]) {
  o[0] = __float2bfloat16_rn(v);
  float r = v - __bfloat162float(o[0]);
  o[1] = __float2bfloat16_rn(r);
  r = r - __bfloat162float(o[1]);
  o[2] = __float2bfloat16_rn(r);
}

__device__ __forceinline__ void split3_pair(float v0, float v1, unsigned* o, int stride) {
  bf16 a[3], b[3];
  split3(v0, a);
  split3(v1, b);
#pragma unroll
  for (int s = 0; s < 3; ++s) o[s * stride] = pack2(a[s], b[s]);
}

// D += A B: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), D fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cum[r] holds dt * a of row r on entry (0 past the sequence) and its
// inclusive prefix over the chunk on exit; w_end[r] = exp(cum_Q-1 - cum_r)
// where w_end is given.  Warp 0, two rows a lane; both kernels run this
// same code, so they see the same bits.
__device__ __forceinline__ void chunk_prefix(float* cum, float* w_end) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
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
    if (w_end != nullptr) {
      const float last = __shfl_sync(0xffffffffu, run, 31);
      w_end[2 * lane] = expf(last - (before + v0));
      w_end[2 * lane + 1] = expf(last - run);
    }
  }
}

// dt of the chunk's rows for head h (0 past the sequence) into dtv, dt * a
// into cum, then the prefix.  Ends with a barrier.
__device__ __forceinline__ void chunk_decay(const float* db, long long dt_s, float a_h,
                                            int s0, int seq, float* dtv, float* cum) {
  if (threadIdx.x < kQ) {
    const int t = s0 + threadIdx.x;
    const float d = t < seq ? db[(long long)t * dt_s] : 0.f;
    dtv[threadIdx.x] = d;
    cum[threadIdx.x] = d * a_h;
  }
  __syncthreads();
  chunk_prefix(cum, nullptr);
  __syncthreads();
}

// A bf16 tile of ROWS x COLS in registers, 16 bytes (8 columns) a piece,
// the pieces dealt round-robin over the block's threads.
template <int ROWS, int COLS>
struct Tile {
  static constexpr int kV = COLS / 8;
  static constexpr int kTotal = ROWS * kV;
  static constexpr int kIters = (kTotal + kTcThreads - 1) / kTcThreads;
  uint4 v[kIters];
};

// Load rows [0, ROWS) x columns [0, COLS) of a bf16 matrix whose row r
// starts at src + r * ld (elements), rows >= valid read as zero.  Every
// load is issued before any is used.  vec: 16-byte loads (src and ld
// 16-byte aligned, checked by the caller); else eight 2-byte loads a piece.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(Tile<ROWS, COLS>& t, const bf16* src, long long ld,
                                          int valid, bool vec) {
  using T = Tile<ROWS, COLS>;
#pragma unroll
  for (int it = 0; it < T::kIters; ++it) {
    const int idx = threadIdx.x + it * kTcThreads;
    const int r = idx / T::kV;
    const int c = (idx - r * T::kV) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (idx < T::kTotal && r < valid) {
      const bf16* p = src + r * ld + c;
      if (vec) {
        v = *reinterpret_cast<const uint4*>(p);
      } else {
        v.x = pack2(p[0], p[1]);
        v.y = pack2(p[2], p[3]);
        v.z = pack2(p[4], p[5]);
        v.w = pack2(p[6], p[7]);
      }
    }
    t.v[it] = v;
  }
}

// Store a loaded tile into shared memory rows of `pitch` elements
// (pitch * 2 bytes a multiple of 16).
template <int ROWS, int COLS>
__device__ __forceinline__ void store_tile(const Tile<ROWS, COLS>& t, bf16* dst, int pitch) {
  using T = Tile<ROWS, COLS>;
#pragma unroll
  for (int it = 0; it < T::kIters; ++it) {
    const int idx = threadIdx.x + it * kTcThreads;
    const int r = idx / T::kV;
    const int c = (idx - r * T::kV) * 8;
    if (idx < T::kTotal) *reinterpret_cast<uint4*>(dst + r * pitch + c) = t.v[it];
  }
}

// Two bf16 of a row-major tile, rows k and k + 1 of one column, as the
// packed k-pair an mma B operand takes.
__device__ __forceinline__ unsigned col_pair(const bf16* t, int pitch, int k, int col) {
  return pack2(t[k * pitch + col], t[(k + 1) * pitch + col]);
}

constexpr int kStrip = 16;  // rows of the state a block of step 1 carries

template <int N>
constexpr size_t state_smem_bytes() {
  return 2 * (2 * (size_t)kQ * (N + 8) + 2 * (size_t)kQ * (kStrip + 8) +
              3 * (size_t)kStrip * kPadQ) +
         4 * kQ * sizeof(float);
}

// 1. The states, one block per (sequence, head, 16-row strip of P)
// walking the chunks in order.  Per chunk: the strip of its local state
// (x dt w)^T B, an mma of M = 16 (rows p), N = N (columns n, split over
// the four warps), K = Q, with A = x dt w split in three (p-major, rows
// along the chunk) and B = the chunk's B, exact, read as row pairs from
// its row-major tile; then h <- exp(cum_Q-1) h + local.  The carried state
// stays in registers in the accumulator layout; the state entering each
// chunk after the first goes to `states` once, for step 2, and the last
// one to h_last.  The next chunk's B, x and dt are loaded into registers
// while this one computes, into the other of two shared-memory buffers.
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads)
    ssd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const bf16* __restrict__ bm,
                     float* __restrict__ states, float* __restrict__ h_last, int seq,
                     int heads, int n_chunks, int vec_x, int vec_b, Strides3 xs, Strides3 ds,
                     Strides3 bs) {
  constexpr int kNT = N / 8;                  // column tiles of the state
  constexpr int kNTW = (kNT + 3) / 4;         // column tiles per warp
  constexpr int kPadN = N + 8;
  constexpr int kPadS = kStrip + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw);  // 2 x (Q, N) B
  bf16* x_s = b_s + 2 * kQ * kPadN;                // 2 x (Q, 16) x, the strip's columns
  bf16* xw = x_s + 2 * kQ * kPadS;                 // (3, 16, Q) x dt w, split
  float* dts = reinterpret_cast<float*>(xw + 3 * kStrip * kPadQ);  // 2 x (Q,) dt
  float* cum = dts + 2 * kQ;
  float* w_end = cum + kQ;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.z * kStrip;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;
  const float a_h = a[h];
  const bf16* xb = x + b * xs.b + h * xs.h + p0;
  const bf16* bb = bm + b * bs.b;
  const float* db = dt + b * ds.b + h * ds.h;

  Tile<kQ, N> tb;
  Tile<kQ, kStrip> tx;
  float tdt = 0.f;
  auto fetch = [&](int c) {
    const int s0 = c * kQ;
    load_tile(tb, bb + s0 * bs.s, bs.s, seq - s0, vec_b);
    load_tile(tx, xb + s0 * xs.s, xs.s, seq - s0, vec_x);
    if (tid < kQ) tdt = s0 + tid < seq ? db[(long long)(s0 + tid) * ds.s] : 0.f;
  };
  auto commit = [&](int buf) {
    store_tile(tb, b_s + buf * kQ * kPadN, kPadN);
    store_tile(tx, x_s + buf * kQ * kPadS, kPadS);
    if (tid < kQ) dts[buf * kQ + tid] = tdt;
  };

  float hs[kNTW][4];  // the carried state: rows p0 + g (+8), columns nt*8 + 2t4 (+1)
#pragma unroll
  for (int u = 0; u < kNTW; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) hs[u][e] = 0.f;
  fetch(0);
  commit(0);
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const bf16* bcur = b_s + buf * kQ * kPadN;
    const bf16* xcur = x_s + buf * kQ * kPadS;
    const float* dtv = dts + buf * kQ;
    if (c + 1 < n_chunks) fetch(c + 1);  // in flight while this chunk computes
    if (tid < kQ) cum[tid] = dtv[tid] * a_h;
    __syncthreads();
    chunk_prefix(cum, w_end);
    __syncthreads();
    for (int i = tid; i < kQ * kStrip; i += kTcThreads) {
      const int r = i / kStrip;
      const int p = i - r * kStrip;
      // x dt as the CUDA-core route forms it, then the decay to the end
      const float xd = __bfloat162float(xcur[r * kPadS + p]) * dtv[r];
      bf16 o[3];
      split3(xd * w_end[r], o);
#pragma unroll
      for (int s = 0; s < 3; ++s) xw[(s * kStrip + p) * kPadQ + r] = o[s];
    }
    __syncthreads();

    float acc[kNTW][4];
#pragma unroll
    for (int u = 0; u < kNTW; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kQ / 16; ++ks) {
      const int col = ks * 16 + 2 * t4;
      unsigned af[3][4];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const bf16* base = xw + (s * kStrip + g) * kPadQ + col;
        af[s][0] = ld_u32(base);
        af[s][1] = ld_u32(base + 8 * kPadQ);
        af[s][2] = ld_u32(base + 8);
        af[s][3] = ld_u32(base + 8 * kPadQ + 8);
      }
#pragma unroll
      for (int u = 0; u < kNTW; ++u) {
        const int nt = warp + 4 * u;
        if (nt < kNT) {
          const unsigned b0 = col_pair(bcur, kPadN, col, nt * 8 + g);
          const unsigned b1 = col_pair(bcur, kPadN, col + 8, nt * 8 + g);
#pragma unroll
          for (int s = 0; s < 3; ++s) mma_bf16(acc[u], af[s], b0, b1);
        }
      }
    }
    float* st = states + (((size_t)b * n_chunks + c) * heads + h) * P * N + (size_t)p0 * N;
    const float decay = expf(cum[kQ - 1]);
#pragma unroll
    for (int u = 0; u < kNTW; ++u) {
      const int nt = warp + 4 * u;
      if (nt < kNT) {
        const int n = nt * 8 + 2 * t4;
        if (c > 0) {  // the state entering chunk c (zero for the first)
          *reinterpret_cast<float2*>(st + g * N + n) = make_float2(hs[u][0], hs[u][1]);
          *reinterpret_cast<float2*>(st + (g + 8) * N + n) = make_float2(hs[u][2], hs[u][3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[u][e] = decay * hs[u][e] + acc[u][e];
      }
    }
    if (c + 1 < n_chunks) commit(buf ^ 1);
    __syncthreads();  // the next chunk reads the other buffer and rewrites cum, w_end, xw
  }
  float* hl = h_last + ((size_t)b * heads + h) * P * N + (size_t)p0 * N;
#pragma unroll
  for (int u = 0; u < kNTW; ++u) {
    const int nt = warp + 4 * u;
    if (nt < kNT) {
      const int n = nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(hl + g * N + n) = make_float2(hs[u][0], hs[u][1]);
      *reinterpret_cast<float2*>(hl + (g + 8) * N + n) = make_float2(hs[u][2], hs[u][3]);
    }
  }
}

template <int P, int N>
constexpr size_t scan_smem_bytes() {
  return 2 * (2 * (size_t)kQ * (N + 8) + (size_t)kQ * (P + 8) + 3 * (size_t)P * (N + 8)) +
         2 * kQ * sizeof(float);
}

// The (P, N) fp32 state entering a chunk, split in three bf16 terms into
// h_s (3, P, N + 8): float4 loads, eight in flight a thread.
template <int P, int N>
__device__ __forceinline__ void stage_state(const float* st, bf16* h_s) {
  constexpr int kPadN = N + 8;
  constexpr int kTotal = P * N / 4;
  constexpr int kIters = kTotal / kTcThreads > 0 ? kTotal / kTcThreads : 1;
  constexpr int kBatch = kIters < 8 ? kIters : 8;
#pragma unroll
  for (int it0 = 0; it0 < kIters; it0 += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = threadIdx.x + (it0 + u) * kTcThreads;
      v[u] = idx < kTotal ? reinterpret_cast<const float4*>(st)[idx]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = threadIdx.x + (it0 + u) * kTcThreads;
      if (idx < kTotal) {
        const int p = (4 * idx) / N;
        const int n = 4 * idx - p * N;
        unsigned lo[3], hi[3];
        split3_pair(v[u].x, v[u].y, lo, 1);
        split3_pair(v[u].z, v[u].w, hi, 1);
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          *reinterpret_cast<uint2*>(h_s + (s * P + p) * kPadN + n) = make_uint2(lo[s], hi[s]);
        }
      }
    }
  }
}

// 2. y for one chunk and a group of heads.  Warp w owns rows 16w..16w+15
// of the chunk: their C.B^T row strip (the columns j <= the strip's last
// row) stays in registers for every head, in the accumulator layout that
// is also the A operand's layout of the next product.
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads)
    ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ a, const bf16* __restrict__ bm,
                          const bf16* __restrict__ cm, const float* __restrict__ states,
                          float* __restrict__ y, int seq, int heads, int n_chunks, int hb,
                          int vec_x, int vec_b, int vec_c, Strides3 xs, Strides3 ds,
                          Strides3 bs, Strides3 cs) {
  constexpr int kPadN = N + 8;
  constexpr int kPadP = P + 8;
  constexpr int kPT = P / 8;   // column tiles of y
  constexpr int kKN = N / 16;  // k-steps over the state dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);  // (Q, N) C
  bf16* b_s = c_s + kQ * kPadN;                    // (Q, N) B
  bf16* x_s = b_s + kQ * kPadN;                    // (Q, P) x of one head
  bf16* h_s = x_s + kQ * kPadP;                    // (3, P, N) entering state, split
  float* cum = reinterpret_cast<float*>(h_s + 3 * P * kPadN);
  float* dtv = cum + kQ;

  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int s0 = c * kQ;
  const int valid = seq - s0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t4 = tid & 3;

  {
    Tile<kQ, N> tb, tc;  // both tiles' loads in flight together
    load_tile(tb, bm + b * bs.b + s0 * bs.s, bs.s, valid, vec_b);
    load_tile(tc, cm + b * cs.b + s0 * cs.s, cs.s, valid, vec_c);
    store_tile(tb, b_s, kPadN);
    store_tile(tc, c_s, kPadN);
  }
  __syncthreads();

  // C.B^T for rows i0 = 16w + g and i1 = i0 + 8, columns nt*8 + 2t4 (+1)
  const int i0 = warp * 16 + g;
  const int i1 = i0 + 8;
  float cbt[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cbt[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kKN; ++ks) {
    const int col = ks * 16 + 2 * t4;
    const unsigned af[4] = {ld_u32(c_s + i0 * kPadN + col), ld_u32(c_s + i1 * kPadN + col),
                            ld_u32(c_s + i0 * kPadN + col + 8),
                            ld_u32(c_s + i1 * kPadN + col + 8)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt <= 2 * warp + 1) {  // tiles past the strip's diagonal are not needed
        const bf16* bp = b_s + (nt * 8 + g) * kPadN + col;
        mma_bf16(cbt[nt], af, ld_u32(bp), ld_u32(bp + 8));
      }
    }
  }

  const int h_end = min((int)(blockIdx.z + 1) * hb, heads);
  for (int h = blockIdx.z * hb; h < h_end; ++h) {
    Tile<kQ, P> tx;  // in flight while the entering state loads
    load_tile(tx, x + b * xs.b + h * xs.h + s0 * xs.s, xs.s, valid, vec_x);
    if (c > 0) stage_state<P, N>(states + (((size_t)b * n_chunks + c) * heads + h) * P * N, h_s);
    store_tile(tx, x_s, kPadP);
    chunk_decay(dt + b * ds.b + h * ds.h, ds.s, a[h], s0, seq, dtv, cum);

    float acc_d[kPT][4], acc_o[kPT][4];
#pragma unroll
    for (int nt = 0; nt < kPT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_d[nt][e] = acc_o[nt][e] = 0.f;
    const float cum0 = cum[i0];
    const float cum1 = cum[i1];

    // (S o dt) x over the columns j <= the strip's rows
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks <= warp) {
        const int j0 = ks * 16 + 2 * t4;
        float sv[8];  // (i0, j0), (i0, j0+1), (i1, j0), (i1, j0+1), then j + 8
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? i0 : i1;
            const int j = j0 + 8 * half + (e & 1);
            const float ci = e < 2 ? cum0 : cum1;
            sv[4 * half + e] = j <= i ? cbt[2 * ks + half][e] * expf(ci - cum[j]) * dtv[j] : 0.f;
          }
        }
        unsigned af[3][4];
        split3_pair(sv[0], sv[1], &af[0][0], 4);
        split3_pair(sv[2], sv[3], &af[0][1], 4);
        split3_pair(sv[4], sv[5], &af[0][2], 4);
        split3_pair(sv[6], sv[7], &af[0][3], 4);
#pragma unroll
        for (int nt = 0; nt < kPT; ++nt) {
          const unsigned b0 = col_pair(x_s, kPadP, j0, nt * 8 + g);
          const unsigned b1 = col_pair(x_s, kPadP, j0 + 8, nt * 8 + g);
#pragma unroll
          for (int s = 0; s < 3; ++s) mma_bf16(acc_d[nt], af[s], b0, b1);
        }
      }
    }
    // C h^T, h the state entering the chunk (zero for the first)
    if (c > 0) {
#pragma unroll
      for (int ks = 0; ks < kKN; ++ks) {
        const int col = ks * 16 + 2 * t4;
        const unsigned af[4] = {ld_u32(c_s + i0 * kPadN + col), ld_u32(c_s + i1 * kPadN + col),
                                ld_u32(c_s + i0 * kPadN + col + 8),
                                ld_u32(c_s + i1 * kPadN + col + 8)};
#pragma unroll
        for (int nt = 0; nt < kPT; ++nt) {
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            const bf16* bp = h_s + (s * P + nt * 8 + g) * kPadN + col;
            mma_bf16(acc_o[nt], af, ld_u32(bp), ld_u32(bp + 8));
          }
        }
      }
    }
    const float e0 = expf(cum0);
    const float e1 = expf(cum1);
    const int t0 = s0 + i0;
    const int t1 = s0 + i1;
    float* yb = y + ((size_t)b * seq * heads + h) * P;
#pragma unroll
    for (int nt = 0; nt < kPT; ++nt) {
      const int p = nt * 8 + 2 * t4;
      if (t0 < seq) {
        *reinterpret_cast<float2*>(yb + (size_t)t0 * heads * P + p) =
            make_float2(acc_d[nt][0] + e0 * acc_o[nt][0], acc_d[nt][1] + e0 * acc_o[nt][1]);
      }
      if (t1 < seq) {
        *reinterpret_cast<float2*>(yb + (size_t)t1 * heads * P + p) =
            make_float2(acc_d[nt][2] + e1 * acc_o[nt][2], acc_d[nt][3] + e1 * acc_o[nt][3]);
      }
    }
    __syncthreads();  // the next head rewrites x_s, h_s, cum and dtv
  }
}

// Raise a kernel's dynamic shared-memory ceiling once per device.
template <typename Kernel>
cudaError_t configure_smem(Kernel kernel, bool* configured, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

struct Launch {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  float* y;
  float* h_last;
  void* scratch;  // bf16: (B, chunks, H, P, N), the state entering each chunk
  int batch, seq, heads;
  Strides3 xs, ds, bs, cs;
  cudaStream_t st;
};

// A bf16 tensor read as 16-byte vectors along its last dim: base and the
// batch, row and head strides all multiples of 16 bytes.
int aligned16(const void* base, const Strides3& st) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && st.b % 8 == 0 && st.s % 8 == 0 &&
         st.h % 8 == 0;
}

template <int P, int N>
int launch_tensor_core(const Launch& l) {
  static bool configured_state[kMaxDevices] = {};
  static bool configured_scan[kMaxDevices] = {};
  constexpr size_t state_bytes = state_smem_bytes<N>();
  constexpr size_t scan_bytes = scan_smem_bytes<P, N>();
  cudaError_t err = configure_smem(ssd_state_kernel<P, N>, configured_state, state_bytes);
  if (err != cudaSuccess) return (int)err;
  err = configure_smem(ssd_chunk_scan_kernel<P, N>, configured_scan, scan_bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (l.seq + kQ - 1) / kQ;
  int hb = kMaxHeadsPerBlock;
  while (hb > 1 && (long long)n_chunks * l.batch * ((l.heads + hb - 1) / hb) < kMinBlocks) {
    hb >>= 1;
  }
  float* states = static_cast<float*>(l.scratch);
  const bf16* x = static_cast<const bf16*>(l.x);
  const bf16* bm = static_cast<const bf16*>(l.bm);
  // 16-byte loads where a tensor's base and row strides allow them
  const int vec_x = aligned16(l.x, l.xs);
  const int vec_b = aligned16(l.bm, l.bs);
  const int vec_c = aligned16(l.cm, l.cs);
  ssd_state_kernel<P, N><<<dim3(l.heads, l.batch, P / kStrip), kTcThreads, state_bytes,
                           l.st>>>(
      x, l.dt, l.a, bm, states, l.h_last, l.seq, l.heads, n_chunks, vec_x, vec_b, l.xs, l.ds,
      l.bs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<P, N><<<dim3(n_chunks, l.batch, (l.heads + hb - 1) / hb), kTcThreads,
                                scan_bytes, l.st>>>(
      x, l.dt, l.a, bm, static_cast<const bf16*>(l.cm), states, l.y, l.seq, l.heads,
      n_chunks, hb, vec_x, vec_b, vec_c, l.xs, l.ds, l.bs, l.cs);
  return (int)cudaGetLastError();
}

template <int P, int N>
int launch_cuda_core(const Launch& l) {
  static bool configured[kMaxDevices] = {};
  constexpr size_t bytes = smem_floats<P, N>() * sizeof(float);
  const cudaError_t err = configure_smem(ssd_scan_kernel<float, P, N>, configured, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<float, P, N><<<dim3(l.heads, l.batch), kThreads, bytes, l.st>>>(
      static_cast<const float*>(l.x), l.dt, l.a, static_cast<const float*>(l.bm),
      static_cast<const float*>(l.cm), l.y, l.h_last, l.seq, l.heads, l.xs, l.ds, l.bs, l.cs);
  return (int)cudaGetLastError();
}

template <int P, int N>
int launch_pn(const Launch& l, int dtype) {
  return dtype == 1 ? launch_tensor_core<P, N>(l) : launch_cuda_core<P, N>(l);
}

template <int P>
int launch_p(const Launch& l, int n, int dtype) {
  switch (n) {
    case 16: return launch_pn<P, 16>(l, dtype);
    case 32: return launch_pn<P, 32>(l, dtype);
    case 64: return launch_pn<P, 64>(l, dtype);
    case 128: return launch_pn<P, 128>(l, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// route; x, bm and cm in bf16).  dt, a, y and h_last are float32.  Strides
// are in elements, in the order (batch, row, head); bm and cm have no head
// stride.  `scratch` must hold batch * ceil(seq / 64) * heads * p * n
// floats for bfloat16 and is ignored for float32.  Launches on `stream` and returns
// cudaGetLastError() after the launches (0 on success); nothing here
// synchronises.  Refuses (cudaErrorInvalidValue) P other than 16, 32 or
// 64 and N other than 16, 32, 64 or 128.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y, void* h_last,
                               void* scratch, int batch, int seq, int heads, int p, int n,
                               long long x_sb, long long x_ss, long long x_sh,
                               long long dt_sb, long long dt_ss, long long dt_sh,
                               long long b_sb, long long b_ss, long long c_sb,
                               long long c_ss, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || seq < 1 ||
      (dtype != 0 && dtype != 1) || (dtype == 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Launch l{x, static_cast<const float*>(dt), static_cast<const float*>(a), bm, cm,
                 static_cast<float*>(y), static_cast<float*>(h_last), scratch, batch, seq,
                 heads, Strides3{x_sb, x_ss, x_sh}, Strides3{dt_sb, dt_ss, dt_sh},
                 Strides3{b_sb, b_ss, 0}, Strides3{c_sb, c_ss, 0},
                 static_cast<cudaStream_t>(stream)};
  switch (p) {
    case 16: return launch_p<16>(l, n, dtype);
    case 32: return launch_p<32>(l, n, dtype);
    case 64: return launch_p<64>(l, n, dtype);
    default: return (int)cudaErrorInvalidValue;
  }
}
