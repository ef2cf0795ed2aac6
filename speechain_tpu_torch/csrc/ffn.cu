// Fused position-wise feed-forward kernels for Hopper (sm_90a).
//
// Forward: replaces speechain_tpu/ops/pallas_ffn.py::fused_ffn (pl.pallas_call
// at :180) and ::fused_ffn_residual (:264), one body (_fwd_kernel :59):
//     out = [res + alpha * resdrop](drop(act(x W1^T + b1)) W2^T + b2)
// with the (rows, F) intermediate kept on chip.
//
// Backward: replaces the backward pl.pallas_call at :207 and :293, one body
// (_bwd_kernel :93): dx, dW1, db1, dW2, db2 with the intermediate recomputed
// from x and both dropout masks regenerated. The TPU kernel accumulates the
// weight gradients across its sequential grid; blocks here run in parallel,
// and per-block partials of both matrices would not fit (50 row tiles x 8
// MB at N = 3184, D = 512, F = 2048). So the backward is split:
//   1. a row pass writes dx and, in the compute dtype, ht (the dropped
//      activation), dz, and g_c (the scaled output cotangent), plus g in
//      float32 for db2;
//   2. a weight-gradient pass: one block per 64 x 64 tile of dW1 = dz^T x
//      and of dW2 = g_c^T ht, summing rows in a fixed order (deterministic,
//      no atomics);
//   3. db1 = sum dz, db2 = sum g, in a fixed order (float32: colsum_kernel;
//      bf16: folded into the weight-gradient pass).
// Weight gradients stay float32, as the TPU kernel returns them.
//
// Rounding points follow the TPU kernel: z = x W1^T + b1 accumulates in
// float32 and is rounded to the compute dtype before the activation; the
// activation, the dropped activation ht, g_c and dz are rounded to the
// compute dtype; biases are added in float32; every product takes operands
// in the compute dtype and sums in float32 (the TPU kernel's
// preferred_element_type=float32). Dropout bits come from
// common.cuh::dropout_bits with stream seed + row / pick and element
// (row % pick) * C + col, pick = pallas_ffn.py::_pick_rows(N): they depend
// on an element's position only, not on the tiling.
// Weights are PyTorch Linear layout: W1 (F, D), W2 (Do, F); biases float32.
//
// What bounds it on the H100: the operations. At transformer-wide training
// (N = 3184, D = 512, F = 2048) the forward is 13.4 GFLOP (0.0135 ms at
// bf16's 989 TFLOP/s) against ~10 MB of traffic (0.003 ms), the backward
// 33 GFLOP against ~22 MB. The decode step (N = 256) moves 1 MB of weights
// for 0.27 GFLOP and is bound by the bytes, and in practice by latency.
//
// bf16 design (ffn_fwd_tc, ffn_bwd_rows_tc, ffn_wgrad_tc): every product on
// the tensor cores, mma.sync m16n8k16 with bf16 operands from shared memory
// by ldmatrix (.trans where the operand's K runs down the rows) and float32
// sums (mma.cuh); the epilogues are the FMA-unit code of the float32
// kernels, at each accumulator element's (row, column).
// - Tiles: a block of 8 warps owns a 64-row tile of x, staged once (rows
//   padded to an odd number of 16-byte units: conflict-free ldmatrix) and
//   walks F in chunks of 64. Weights stream through a ring of 64 x 64 tiles
//   (3 slots, 2 where the staged rows leave no room; 16-byte cp.async,
//   zero-filled past every edge, so ragged N, D, F and Do need no other
//   masking in the products). Warp w computes rows 16 (w % 4) .. + 16 and
//   columns 32 (w / 4) .. + 32 of every 64 x 64 product.
// - Forward: per chunk, z = x W1[c]^T over D / 64 ring tiles, the epilogue
//   in registers, h (bf16) into a 64 x 64 shared tile, then y += h
//   W2[o, c]^T for the block's output tiles. y stays in registers over the
//   whole F loop (NT 64-wide output tiles: 16 NT float32 registers a
//   thread); the residual epilogue writes out once. One launch.
// - Filling the card: a block owns NT of the Do / 64 output tiles (NT = 1,
//   2 or 4, one instance each), so Do is split over column groups, each
//   recomputing its rows' h. The wrapper (ops/cuda_ffn.py::tc_geometry)
//   picks NT from N, D and Do and the blocks an SM each instance holds.
// - Backward row pass: per chunk, z = x W1[c]^T (D / 64 ring tiles; z kept
//   as bf16 pairs, ht written), dht = g_c W2[:, c] (Do / 64 tiles, read
//   transposed; g_c staged once per block), dz = act'(z) round(dht * mask)
//   written and put in a shared tile, then dx += dz W1[c] over the block's
//   NT dx tiles (read transposed), in registers over the F loop. Column
//   groups split D as the forward splits Do; only group 0 writes ht, dz,
//   g_c and g.
// - Weight gradients: one launch for both matrices, one block of 4 warps
//   per 64 x 64 output tile (each warp 32 x 32); A^T B with both operands
//   read by ldmatrix.trans from 64-row stages of a 4-slot ring; rows past
//   N are zeros. The tiles alone fill the card at the paths' widths (128
//   blocks at D 256, F 1024; 512 at D 512, F 2048), so N is not split and
//   no partials are needed. The blocks of each matrix's first tile column
//   also form db1 (from the staged dz tiles) and db2 (from g in float32,
//   loaded a stage ahead), in a fixed order.
// - What a step costs: each ring tile is one barrier and 16 mma a warp, so
//   the per-step instructions count. The copy loop has a fixed trip count,
//   the ring walks its tiles with cursors (no division or modulo a step),
//   an epilogue dispatches its activation once (with_act) and loads its
//   biases before the chunk's products, and each thread's two rows' dropout
//   streams are computed once (RowDrop; the backward keeps the activation
//   mask's bits for dz). Each of these showed on the H100 (chip_smoke.py
//   phase 2b times the result; PERF.md records it).
//
// float32 keeps the FMA-unit kernels (ffn_kernel, ffn_bwd_rows,
// wgrad_kernel: rows of float32 in shared memory, 256 threads): float32 on
// the tensor cores means TF32, about three decimal digits, which breaks
// the 1e-4 contract a float32 step holds the card to against the CPU.

#include <cstdint>
#include <type_traits>

#include "mma.cuh"
#include "tiles.cuh"

namespace {

using namespace sct;

struct Drop {          // one dropout site; thresh/scale from ops/dropout.py
  int on;
  unsigned int seed, thresh;
  float scale;
  __device__ __forceinline__ float keep(int row, int col, int C,
                                        int pick) const {
    return dropout_keep((unsigned int)((row % pick) * C + col),
                        seed + (unsigned int)(row / pick), thresh, scale);
  }
};

// One row's dropout stream at a site of C columns: the stream seed +
// row / pick and the element base (row % pick) * C, so that a column's
// keep costs the mixer alone.
struct RowDrop {
  unsigned int seed, base;
  __device__ __forceinline__ RowDrop(const Drop& d, int row, int C, int pick)
      : seed(d.seed + (unsigned int)(row / pick)),
        base((unsigned int)((row % pick) * C)) {}
  __device__ __forceinline__ bool kept(const Drop& d, int col) const {
    return dropout_bits(base + (unsigned int)col, seed) >= d.thresh;
  }
};

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1,
           const float* __restrict__ b1, const T* __restrict__ w2,
           const float* __restrict__ b2, const T* __restrict__ res,
           T* __restrict__ out, int N, int D, int Fd, int Do, int act,
           float alpha, int pick, Drop drop, Drop rdrop) {
  extern __shared__ float smem[];
  float* xs = smem;                  // [R][D]
  float* hs = xs + R * D;            // [R][Fd]
  float* ws = hs + R * Fd;           // [THREADS][BK + 1]
  const int row0 = blockIdx.x * R;

  for (int i = threadIdx.x; i < R * D; i += THREADS) {
    const int r = i / D;
    xs[i] = row0 + r < N ? to_f(x[(size_t)row0 * D + i]) : 0.f;
  }
  __syncthreads();

  rows_times_wt<T, R>(xs, D, w1, Fd, ws, [&](int r, int c, float acc) {
    const float z = round_to<T>(acc + b1[c]);
    float h = round_to<T>(activate(z, act));
    if (drop.on && row0 + r < N)
      h = round_to<T>(h * drop.keep(row0 + r, c, Fd, pick));
    hs[r * Fd + c] = h;
  });
  __syncthreads();

  rows_times_wt<T, R>(hs, Fd, w2, Do, ws, [&](int r, int c, float acc) {
    const int row = row0 + r;
    if (row >= N) return;
    float y = acc + b2[c];
    const size_t o = (size_t)row * Do + c;
    if (res != nullptr) {
      if (rdrop.on) y = y * rdrop.keep(row, c, Do, pick);
      y = to_f(res[o]) + alpha * y;
    }
    out[o] = from_f<T>(y);
  });
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_rows(const T* __restrict__ x, const T* __restrict__ w1,
             const float* __restrict__ b1, const T* __restrict__ w2,
             const T* __restrict__ g, T* __restrict__ dx, T* __restrict__ ht,
             T* __restrict__ dz, T* __restrict__ gc, float* __restrict__ gs,
             int N, int D, int Fd, int Do, int act, float alpha, int pick,
             Drop drop, Drop rdrop) {
  extern __shared__ float smem[];
  const int W = D > Do ? D : Do;
  float* buf = smem;                 // [R][W]: x, then g_c
  float* hs = buf + R * W;           // [R][Fd]: z (rounded), then dz
  float* ws = hs + R * Fd;           // [THREADS][BK + 1]
  const int row0 = blockIdx.x * R;

  for (int i = threadIdx.x; i < R * D; i += THREADS) {
    const int r = i / D;
    buf[i] = row0 + r < N ? to_f(x[(size_t)row0 * D + i]) : 0.f;
  }
  __syncthreads();

  // recompute z and the dropped activation ht
  rows_times_wt<T, R>(buf, D, w1, Fd, ws, [&](int r, int c, float acc) {
    const float z = round_to<T>(acc + b1[c]);
    hs[r * Fd + c] = z;
    const int row = row0 + r;
    if (row >= N) return;
    float h = round_to<T>(activate(z, act));
    if (drop.on) h = round_to<T>(h * drop.keep(row, c, Fd, pick));
    ht[(size_t)row * Fd + c] = from_f<T>(h);
  });
  __syncthreads();

  // output cotangent of the inner branch: alpha * resmask * g
  for (int i = threadIdx.x; i < R * Do; i += THREADS) {
    const int r = i / Do, c = i - r * Do, row = row0 + r;
    float v = 0.f;
    if (row < N) {
      const size_t o = (size_t)row * Do + c;
      v = to_f(g[o]);
      if (rdrop.on) v = v * rdrop.keep(row, c, Do, pick);
      v = alpha * v;
      gs[o] = v;
      v = round_to<T>(v);
      gc[o] = from_f<T>(v);
    }
    buf[r * Do + c] = v;
  }
  __syncthreads();

  // dht = g_c W2; dz = act'(z) * (dht * mask), in the compute dtype
  rows_times_w<T, R>(buf, Do, w2, Fd, [&](int r, int c, float acc) {
    const int row = row0 + r;
    float v = 0.f;
    if (row < N) {
      float dh = acc;
      if (drop.on) dh = dh * drop.keep(row, c, Fd, pick);
      v = round_to<T>(activate_grad(hs[r * Fd + c], act) * round_to<T>(dh));
      dz[(size_t)row * Fd + c] = from_f<T>(v);
    }
    hs[r * Fd + c] = v;
  });
  __syncthreads();

  // dx = dz W1
  rows_times_w<T, R>(hs, Fd, w1, D, [&](int r, int c, float acc) {
    const int row = row0 + r;
    if (row < N) dx[(size_t)row * D + c] = from_f<T>(acc);
  });
}

// C (M1, M2) float32 = A^T B over N rows (tiles.cuh::wgrad_tile).
template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const T* __restrict__ A, const T* __restrict__ B,
             float* __restrict__ C, int N, int M1, int M2) {
  wgrad_tile<T>(A, B, C, N, M1, M2);
}

// out[c] = sum over rows of A[r][c]; 32 columns x 8 row groups per block,
// partial sums added in a fixed order.
template <typename T>
__global__ void __launch_bounds__(THREADS)
colsum_kernel(const T* __restrict__ A, float* __restrict__ out, int N,
              int M) {
  __shared__ float part[8][33];
  const int cx = threadIdx.x % 32, rg = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cx;
  float s = 0.f;
  if (c < M)
    for (int r = rg; r < N; r += 8) s += to_f(A[(size_t)r * M + c]);
  part[rg][cx] = s;
  __syncthreads();
  if (rg == 0 && c < M) {
    float t = 0.f;
    for (int k = 0; k < 8; ++k) t += part[k][cx];
    out[c] = t;
  }
}

template <typename T, int R>
size_t fwd_smem(int D, int Fd) {
  return sizeof(float) * ((size_t)R * D + (size_t)R * Fd + THREADS * (BK + 1));
}

template <typename T, int R>
int launch_fwd(const void* x, const void* w1, const float* b1, const void* w2,
               const float* b2, const void* res, void* out, int N, int D,
               int Fd, int Do, int act, float alpha, int pick, Drop drop,
               Drop rdrop, cudaStream_t stream) {
  const size_t smem = fwd_smem<T, R>(D, Fd);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (N + R - 1) / R;
  ffn_kernel<T, R><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w1, b1, (const T*)w2, b2, (const T*)res,
      (T*)out, N, D, Fd, Do, act, alpha, pick, drop, rdrop);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(int R, const void* x, const void* w1, const float* b1,
                 const void* w2, const float* b2, const void* res, void* out,
                 int N, int D, int Fd, int Do, int act, float alpha, int pick,
                 Drop drop, Drop rdrop, cudaStream_t s) {
#define FFN_FWD(RR)                                                        \
  case RR:                                                                 \
    return launch_fwd<T, RR>(x, w1, b1, w2, b2, res, out, N, D, Fd, Do,    \
                             act, alpha, pick, drop, rdrop, s);
  switch (R) {
    FFN_FWD(1) FFN_FWD(2) FFN_FWD(4) FFN_FWD(8) FFN_FWD(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFN_FWD
}

template <typename T, int R>
int launch_bwd_rows(const void* x, const void* w1, const float* b1,
                    const void* w2, const void* g, void* dx, void* ht,
                    void* dz, void* gc, float* gs, int N, int D, int Fd,
                    int Do, int act, float alpha, int pick, Drop drop,
                    Drop rdrop, cudaStream_t stream) {
  const int W = D > Do ? D : Do;
  const size_t smem =
      sizeof(float) * ((size_t)R * W + (size_t)R * Fd + THREADS * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_rows<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_rows<T, R><<<(N + R - 1) / R, THREADS, smem, stream>>>(
      (const T*)x, (const T*)w1, b1, (const T*)w2, (const T*)g, (T*)dx,
      (T*)ht, (T*)dz, (T*)gc, gs, N, D, Fd, Do, act, alpha, pick, drop,
      rdrop);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(int R, const void* x, const void* w1, const float* b1,
             const void* w2, const void* g, void* dx, void* ht, void* dz,
             void* gc, float* gs, float* dw1, float* db1, float* dw2,
             float* db2, int N, int D, int Fd, int Do, int act, float alpha,
             int pick, Drop drop, Drop rdrop, cudaStream_t s) {
  int err;
#define FFN_BWD(RR)                                                        \
  case RR:                                                                 \
    err = launch_bwd_rows<T, RR>(x, w1, b1, w2, g, dx, ht, dz, gc, gs, N,  \
                                 D, Fd, Do, act, alpha, pick, drop, rdrop, \
                                 s);                                       \
    break;
  switch (R) {
    FFN_BWD(1) FFN_BWD(2) FFN_BWD(4) FFN_BWD(8) FFN_BWD(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FFN_BWD
  if (err) return err;
  wgrad_kernel<T><<<dim3((D + WT - 1) / WT, (Fd + WT - 1) / WT), THREADS, 0,
                    s>>>((const T*)dz, (const T*)x, dw1, N, Fd, D);
  if ((err = (int)cudaGetLastError())) return err;
  wgrad_kernel<T><<<dim3((Fd + WT - 1) / WT, (Do + WT - 1) / WT), THREADS, 0,
                    s>>>((const T*)gc, (const T*)ht, dw2, N, Do, Fd);
  if ((err = (int)cudaGetLastError())) return err;
  colsum_kernel<T><<<(Fd + 31) / 32, THREADS, 0, s>>>((const T*)dz, db1, N,
                                                      Fd);
  if ((err = (int)cudaGetLastError())) return err;
  colsum_kernel<float><<<(Do + 31) / 32, THREADS, 0, s>>>(gs, db2, N, Do);
  return (int)cudaGetLastError();
}

// ---- bf16: the products on the tensor cores -----------------------------

typedef __nv_bfloat16 bf16;

constexpr int TR = 64;                 // rows of a block's row tile
constexpr int TW = 64;                 // an F chunk, a K slice, an output tile
constexpr int LDT = TW + 8;            // padded row of a staged 64 x 64 tile
constexpr int TILE = TR * LDT;         // elements of a staged tile
constexpr size_t TILE_B = (size_t)TILE * sizeof(bf16);     // 9216 bytes
constexpr int TCT = 256;               // threads of the row kernels: 8 warps
constexpr int WGT = 128;               // threads of ffn_wgrad_tc: 4 warps
constexpr int WG_SLOTS = 4;            // ring slots of ffn_wgrad_tc
constexpr size_t SMEM_MAX = 232448;    // dynamic shared memory a block may use

// blocks an SM that the launch bounds ask for: as many as the output
// tiles' accumulators allow (a thread's registers: at most 85 for 3
// blocks, 128 for 2). Co-resident blocks hide each other's barriers,
// copies and epilogues (ops/cuda_ffn.py CO_RESIDENT_GAIN; chip_smoke.py
// phase 2b's tile sweep times every instance at the paths' shapes).
constexpr int fwd_blocks(int nt) { return nt <= 1 ? 3 : 2; }
constexpr int bwd_blocks(int nt) { return nt <= 2 ? 2 : 1; }
constexpr int WG_BLOCKS = 3;

__host__ __device__ __forceinline__ int pad64(int n) {
  return (n + TW - 1) / TW * TW;
}
__host__ __device__ __forceinline__ int tiles64(int n) {
  return (n + TW - 1) / TW;
}

// Shared memory of the row kernels: the staged 64-row tiles (x; and g_c in
// the backward), one 64 x 64 tile (h; dz), and the ring. The ring has 3
// slots where they fit, else 2 (the wrapper raises where 2 do not).
size_t fwd_tc_smem(int D, int slots) {
  return (size_t)TR * (pad64(D) + 8) * sizeof(bf16) + (1 + slots) * TILE_B;
}
size_t bwd_tc_smem(int D, int Do, int slots) {
  return (size_t)TR * (pad64(D) + 8 + pad64(Do) + 8) * sizeof(bf16) +
         (1 + slots) * TILE_B;
}
int fwd_slots(int D) { return fwd_tc_smem(D, 3) <= SMEM_MAX ? 3 : 2; }
int bwd_slots(int D, int Do) {
  return bwd_tc_smem(D, Do, 3) <= SMEM_MAX ? 3 : 2;
}
constexpr size_t WG_SMEM = WG_SLOTS * 2 * TILE_B;

// fn(std::integral_constant<int, NT>) for the instance owning nt output
// tiles; cudaErrorInvalidValue for any other nt
template <typename Fn>
int by_tiles(int nt, Fn fn) {
  switch (nt) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// rows [r0, r0 + 64) of X (rows x W, row-major) -> S, row stride
// pad64(W) + 8, by 16-byte cp.async copies; zeros past the rows and past W
template <int NTH>
__device__ __forceinline__ void stage_rows(bf16* S, const bf16* __restrict__ X,
                                           int r0, int rows, int W) {
  const int ch = pad64(W) / 8, ld = pad64(W) + 8;
  for (int e = threadIdx.x; e < TR * ch; e += NTH) {
    const int r = e / ch, c = (e - r * ch) * 8;
    const bool ok = r0 + r < rows && c < W;
    cp_async16(S + r * ld + c, ok ? X + (size_t)(r0 + r) * W + c : X, ok);
  }
}

// the 64 x 64 tile at (row0, col0) of M (rows x cols, row-major) -> S (row
// stride LDT); zeros past the rows and columns. cols is a multiple of 8, so
// a 16-byte chunk lies wholly inside or wholly outside. Thread t copies
// chunks t, t + NTH, ...: a loop of known length, unrolled.
template <int NTH>
__device__ __forceinline__ void stage_tile(bf16* S, const bf16* __restrict__ M,
                                           int row0, int col0, int rows,
                                           int cols) {
#pragma unroll
  for (int k = 0; k < TR * (TW / 8) / NTH; ++k) {
    const int e = threadIdx.x + k * NTH;
    const int r = e >> 3, c = (e & 7) * 8;
    const bool ok = row0 + r < rows && col0 + c < cols;
    cp_async16(S + r * LDT + c,
               ok ? M + (size_t)(row0 + r) * cols + col0 + c : M, ok);
  }
}

// A ring of `slots` staged tiles, filled in the order the block uses them.
// start() issues the first slots - 1 tiles, one cp.async group each
// (copies issued before join the first tile's group); next(), before each
// tile is used, waits for it, syncs the block (which also frees the slot
// of the tile used before) and issues the tile slots - 1 ahead. load(S)
// stages the next tile of the block's sequence into S and advances its
// own cursor; every thread calls it in the same order.
struct Ring {
  bf16* base;
  int slots, n;
  int issued, wr, rd;
  __device__ __forceinline__ Ring(bf16* b, int s, int count)
      : base(b), slots(s), n(count), issued(0), wr(0), rd(0) {}
  template <typename Load>
  __device__ __forceinline__ void issue(Load& load) {
    if (issued < n) {
      load(base + wr * TILE);
      ++issued;
      wr = wr + 1 == slots ? 0 : wr + 1;
    }
    cp_async_commit();
  }
  template <typename Load>
  __device__ __forceinline__ void start(Load& load) {
    for (int k = 0; k < slots - 1; ++k) issue(load);
  }
  template <typename Load>
  __device__ __forceinline__ const bf16* next(Load& load) {
    if (slots == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const bf16* t = base + rd * TILE;
    rd = rd + 1 == slots ? 0 : rd + 1;
    issue(load);
    return t;
  }
};

// acc (16 x 32) += A (16 rows, row stride lda, K = 64 from column ka) times
// the staged 64 x 64 tile B over its columns [c0, c0 + 32):
//   TRANS false: B's rows are the product's columns, K along the row
//                (x W^T);
//   TRANS true:  B's rows are K, the product's columns along the row
//                (g_c W2, dz W1: B read by ldmatrix.trans).
// Accumulator element i of n-tile n: row lane / 4 + 8 (i / 2), column
// c0 + 8 n + 2 (lane % 4) + i % 2 (mma.cuh).
template <bool TRANS>
__device__ __forceinline__ void warp_mma64(float (&acc)[4][4], const bf16* A,
                                           int lda, int ka, const bf16* B,
                                           int c0) {
  const int lane = threadIdx.x & 31;
  const bf16* pa =
      A + ((lane & 7) + 8 * ((lane >> 3) & 1)) * lda + ka + 8 * (lane >> 4);
  const bf16* pb =
      TRANS ? B + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDT + c0 +
                  8 * (lane >> 4)
            : B + (c0 + (lane & 7) + 8 * (lane >> 4)) * LDT +
                  8 * ((lane >> 3) & 1);
#pragma unroll
  for (int ks = 0; ks < TW / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, pa + 16 * ks);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      if (TRANS)
        ldmatrix_x4_trans(b, pb + 16 * ks * LDT + 16 * np);
      else
        ldmatrix_x4(b, pb + 16 * np * LDT + 16 * ks);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
}

// b1 at this lane's 8 columns of chunk c (0 past F), loaded before the
// chunk's products so that their latency hides behind them
__device__ __forceinline__ void chunk_bias(float (&bb)[4][2],
                                           const float* __restrict__ b1,
                                           int f0, int Fd) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bb[n][e] = f0 + 8 * n + e < Fd ? b1[f0 + 8 * n + e] : 0.f;
}

__device__ __forceinline__ void put2(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

// In the row kernels, warp w owns rows 16 (w % 4) + lane / 4 + 8 hr (hr =
// 0, 1) and, of each 64-wide tile, columns 32 (w / 4) + 8 n + 2 (lane % 4)
// (+ 1): element pair (n, hr) holds accumulators 2 hr and 2 hr + 1.

template <int NT>
__global__ void __launch_bounds__(TCT, fwd_blocks(NT))
ffn_fwd_tc(const bf16* __restrict__ x, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, const bf16* __restrict__ res,
           bf16* __restrict__ out, int N, int D, int Fd, int Do, int act,
           float alpha, int pick, int slots, Drop drop, Drop rdrop) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int ldx = pad64(D) + 8;
  bf16* Xs = reinterpret_cast<bf16*>(tc_smem);          // [64][ldx]
  bf16* Hs = Xs + TR * ldx;                           // [64][LDT]
  const int r0 = blockIdx.x * TR, o0 = blockIdx.y * NT * TW;
  const int KD = tiles64(D), nto = min(NT, tiles64(Do - o0));
  const int per = KD + nto, nch = tiles64(Fd);
  Ring ring(Hs + TILE, slots, nch * per);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rw = 16 * (w & 3), cw = 32 * (w >> 2);
  const int g = lane >> 2, q = 2 * (lane & 3);

  // the tiles in order: for each chunk c, the D / 64 slices of W1[c],
  // then the block's output tiles of W2[:, c]
  int lc = 0, lt = 0;
  auto load = [&](bf16* S) {
    if (lt < KD)
      stage_tile<TCT>(S, w1, lc * TW, lt * TW, Fd, D);
    else
      stage_tile<TCT>(S, w2, o0 + (lt - KD) * TW, lc * TW, Do, Fd);
    if (++lt == per) lt = 0, ++lc;
  };
  stage_rows<TCT>(Xs, x, r0, N, D);    // joins the first tile's group
  ring.start(load);

  // this thread's two rows' streams at the activation and at the output
  const RowDrop hd[2] = {RowDrop(drop, r0 + rw + g, Fd, pick),
                         RowDrop(drop, r0 + rw + g + 8, Fd, pick)};
  const RowDrop od[2] = {RowDrop(rdrop, r0 + rw + g, Do, pick),
                         RowDrop(rdrop, r0 + rw + g + 8, Do, pick)};
  float y[NT][4][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) zero(y[t]);
  for (int c = 0; c < nch; ++c) {
    float z[4][4], bb[4][2];
    zero(z);
    chunk_bias(bb, b1, c * TW + cw + q, Fd);
    for (int kd = 0; kd < KD; ++kd)
      warp_mma64<false>(z, Xs + rw * ldx, ldx, kd * TW, ring.next(load),
                        cw);
    // h = drop(act(round(z + b1))), rounded at each step, into Hs
    with_act(act, [&](auto a) {
      constexpr int A = decltype(a)::value;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int rl = rw + g + 8 * hr, cl = cw + 8 * n + q;
          const int row = r0 + rl, f = c * TW + cl;
          float h[2] = {0.f, 0.f};
          if (f < Fd) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float zz = round_to<bf16>(z[n][2 * hr + e] + bb[n][e]);
              h[e] = round_to<bf16>(activate(zz, A));
              if (drop.on && row < N)
                h[e] = hd[hr].kept(drop, f + e)
                           ? round_to<bf16>(h[e] * drop.scale) : 0.f;
            }
          }
          put2(Hs + rl * LDT + cl, h[0], h[1]);
        }
    });
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t < nto)                    // next()'s barrier publishes Hs
        warp_mma64<false>(y[t], Hs + rw * LDT, LDT, 0, ring.next(load), cw);
    }
  }

  // out = [res + alpha * rdrop](y + b2), written once
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t >= nto) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + rw + g + 8 * hr;
        const int col = o0 + t * TW + cw + 8 * n + q;
        if (row >= N || col >= Do) continue;
        float v[2];
        const size_t o = (size_t)row * Do + col;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = y[t][n][2 * hr + e] + b2[col + e];
          if (res != nullptr) {
            if (rdrop.on)
              v[e] = od[hr].kept(rdrop, col + e) ? v[e] * rdrop.scale : 0.f;
            v[e] = to_f(res[o + e]) + alpha * v[e];
          }
        }
        put2(out + o, v[0], v[1]);
      }
  }
}

template <int NT>
__global__ void __launch_bounds__(TCT, bwd_blocks(NT))
ffn_bwd_rows_tc(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const float* __restrict__ b1, const bf16* __restrict__ w2,
                const bf16* __restrict__ g, bf16* __restrict__ dx,
                bf16* __restrict__ ht, bf16* __restrict__ dz,
                bf16* __restrict__ gc, float* __restrict__ gs, int N, int D,
                int Fd, int Do, int act, float alpha, int pick, int slots,
                Drop drop, Drop rdrop) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int ldx = pad64(D) + 8, ldg = pad64(Do) + 8;
  bf16* Xs = reinterpret_cast<bf16*>(tc_smem);          // [64][ldx]
  bf16* Gs = Xs + TR * ldx;                           // [64][ldg]: g_c
  bf16* Ds = Gs + TR * ldg;                           // [64][LDT]: dz
  const int r0 = blockIdx.x * TR, d0 = blockIdx.y * NT * TW;
  const bool lead = blockIdx.y == 0;   // writes ht, dz, g_c and g
  const int KD = tiles64(D), KO = tiles64(Do);
  const int ntd = min(NT, tiles64(D - d0));
  const int per = KD + KO + ntd, nch = tiles64(Fd);
  Ring ring(Ds + TILE, slots, nch * per);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rw = 16 * (w & 3), cw = 32 * (w >> 2);
  const int gq = lane >> 2, q = 2 * (lane & 3);

  // the tiles in order: for each chunk c, the D / 64 slices of W1[c] (z),
  // the Do / 64 slices of W2[:, c] (dht; K = Do down the rows), then the
  // block's dx tiles of W1[c] (K = F down the rows)
  int lc = 0, lt = 0;
  auto load = [&](bf16* S) {
    if (lt < KD)
      stage_tile<TCT>(S, w1, lc * TW, lt * TW, Fd, D);
    else if (lt < KD + KO)
      stage_tile<TCT>(S, w2, (lt - KD) * TW, lc * TW, Do, Fd);
    else
      stage_tile<TCT>(S, w1, lc * TW, d0 + (lt - KD - KO) * TW, Fd, D);
    if (++lt == per) lt = 0, ++lc;
  };
  stage_rows<TCT>(Xs, x, r0, N, D);    // joins the first tile's group
  ring.start(load);

  // g_c = alpha * (g * resmask), rounded, into Gs (zeros past N and Do);
  // the lead group writes g_c and its float32 value
  const int hp = pad64(Do) / 2;
  for (int e = threadIdx.x; e < TR * hp; e += TCT) {
    const int r = e / hp, col = 2 * (e - r * hp), row = r0 + r;
    float v[2] = {0.f, 0.f};
    if (row < N && col < Do) {
      const size_t o = (size_t)row * Do + col;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        v[k] = to_f(g[o + k]);
        if (rdrop.on) v[k] = v[k] * rdrop.keep(row, col + k, Do, pick);
        v[k] = alpha * v[k];
      }
      if (lead) {
        *reinterpret_cast<float2*>(gs + o) = make_float2(v[0], v[1]);
        put2(gc + o, v[0], v[1]);
      }
    }
    put2(Gs + r * ldg + col, v[0], v[1]);
  }

  const RowDrop hd[2] = {RowDrop(drop, r0 + rw + gq, Fd, pick),
                         RowDrop(drop, r0 + rw + gq + 8, Fd, pick)};
  float dxa[NT][4][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) zero(dxa[t]);
  for (int c = 0; c < nch; ++c) {
    float acc[4][4], bb[4][2];
    zero(acc);
    chunk_bias(bb, b1, c * TW + cw + q, Fd);
    for (int kd = 0; kd < KD; ++kd)
      warp_mma64<false>(acc, Xs + rw * ldx, ldx, kd * TW, ring.next(load),
                        cw);
    // z rounded (kept as bf16 pairs); ht = drop(act(z)), rounded; the
    // mask's dropped elements as bits (n, hr, e), for dz
    uint32_t zp[4][2], dropped = 0;
    with_act(act, [&](auto a) {
      constexpr int A = decltype(a)::value;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = r0 + rw + gq + 8 * hr, f = c * TW + cw + 8 * n + q;
          float z[2] = {0.f, 0.f}, h[2];
          if (f < Fd) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              z[e] = round_to<bf16>(acc[n][2 * hr + e] + bb[n][e]);
              h[e] = round_to<bf16>(activate(z[e], A));
              if (drop.on && row < N) {
                const bool k = hd[hr].kept(drop, f + e);
                h[e] = k ? round_to<bf16>(h[e] * drop.scale) : 0.f;
                dropped |= (k ? 0u : 1u) << (4 * n + 2 * hr + e);
              }
            }
            if (lead && row < N) put2(ht + (size_t)row * Fd + f, h[0], h[1]);
          }
          zp[n][hr] = pack_bf16(z[0], z[1]);
        }
    });
    zero(acc);
    for (int ko = 0; ko < KO; ++ko)
      warp_mma64<true>(acc, Gs + rw * ldg, ldg, ko * TW, ring.next(load), cw);
    // dz = round(act'(z) * round(dht * mask)), into Ds (zeros past N, F)
    with_act(act, [&](auto a) {
      constexpr int A = decltype(a)::value;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int rl = rw + gq + 8 * hr, cl = cw + 8 * n + q;
          const int row = r0 + rl, f = c * TW + cl;
          float d[2] = {0.f, 0.f};
          if (row < N && f < Fd) {
            const __nv_bfloat162 z2 =
                *reinterpret_cast<const __nv_bfloat162*>(&zp[n][hr]);
            const float z[2] = {__low2float(z2), __high2float(z2)};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float dh = acc[n][2 * hr + e];
              if (drop.on)
                dh = (dropped >> (4 * n + 2 * hr + e)) & 1u ? 0.f
                                                             : dh * drop.scale;
              d[e] = round_to<bf16>(activate_grad(z[e], A) *
                                    round_to<bf16>(dh));
            }
            if (lead) put2(dz + (size_t)row * Fd + f, d[0], d[1]);
          }
          put2(Ds + rl * LDT + cl, d[0], d[1]);
        }
    });
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t < ntd)                    // next()'s barrier publishes Ds
        warp_mma64<true>(dxa[t], Ds + rw * LDT, LDT, 0, ring.next(load), cw);
    }
  }

#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t >= ntd) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + rw + gq + 8 * hr;
        const int col = d0 + t * TW + cw + 8 * n + q;
        if (row < N && col < D)
          put2(dx + (size_t)row * D + col, dxa[t][n][2 * hr],
               dxa[t][n][2 * hr + 1]);
      }
  }
}

// C = A^T B in float32 over the N rows of A (N x M1) and B (N x M2), bf16:
// blocks [0, T1) take the 64 x 64 tiles of dW1 = dz^T x (F x D), the rest
// those of dW2 = g_c^T ht (Do x F). Rows are summed in 64-row stages in
// order, each stage's two tiles staged K-major (rows of N) and read by
// ldmatrix.trans; warp w owns rows 32 (w % 2) and columns 32 (w / 2) of
// the tile. Rows past N are zero-filled and add nothing. The blocks of
// each matrix's first tile column also sum the biases' gradients over the
// rows, in the same fixed order: db1 = sum dz from the staged dz tiles,
// db2 = sum g from its float32 copy gs.
__global__ void __launch_bounds__(WGT, WG_BLOCKS)
ffn_wgrad_tc(const bf16* __restrict__ dzm, const bf16* __restrict__ x,
             float* __restrict__ dw1, float* __restrict__ db1,
             const bf16* __restrict__ gcm, const bf16* __restrict__ htm,
             const float* __restrict__ gs, float* __restrict__ dw2,
             float* __restrict__ db2, int N, int D, int Fd, int Do) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* S = reinterpret_cast<bf16*>(tc_smem);   // WG_SLOTS x (A tile, B tile)
  const int T1 = tiles64(Fd) * tiles64(D);
  int b = blockIdx.x;
  const bf16 *A, *Bm;
  float* C;
  int M1, M2;
  if (b < T1) {
    A = dzm; Bm = x; C = dw1; M1 = Fd; M2 = D;
  } else {
    b -= T1;
    A = gcm; Bm = htm; C = dw2; M1 = Do; M2 = Fd;
  }
  const int i0 = b / tiles64(M2) * TW, j0 = b % tiles64(M2) * TW;
  const int ns = tiles64(N);
  // bias sums: 0 none, 1 db1 (dW1's first tile column), 2 db2 (dW2's)
  const int bias = j0 != 0 ? 0 : blockIdx.x < T1 ? 1 : 2;
  // db1: thread t sums column t % 64 over rows 32 (t / 64) .. + 32 of each
  // staged dz tile; db2: columns 4 (t % 16) .. + 4 over rows t / 16 + 8 k
  // of each stage, from gs, loaded one stage ahead
  const int bc = threadIdx.x & 63, bh = threadIdx.x >> 6;
  const int gc4 = 4 * (threadIdx.x & 15), grow = threadIdx.x >> 4;
  float bsum = 0.f;
  float4 gsum = make_float4(0.f, 0.f, 0.f, 0.f), gcur[8], gnext[8];
  const auto gload = [&](float4 (&v)[8], int st) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int row = st * TW + grow + 8 * k;
      v[k] = row < N && i0 + gc4 < M1
                 ? *reinterpret_cast<const float4*>(
                       gs + (size_t)row * Do + i0 + gc4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  if (bias == 2) gload(gcur, 0);
  const auto load = [&](int s) {
    bf16* St = S + (s % WG_SLOTS) * 2 * TILE;
    stage_tile<WGT>(St, A, s * TW, i0, N, M1);
    stage_tile<WGT>(St + TILE, Bm, s * TW, j0, N, M2);
  };
  for (int s = 0; s < WG_SLOTS - 1; ++s) {
    if (s < ns) load(s);
    cp_async_commit();
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int mw = 32 * (w & 1), nw = 32 * (w >> 1);
  float acc[2][4][4];
  zero(acc[0]);
  zero(acc[1]);
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<WG_SLOTS - 2>();
    __syncthreads();
    if (s + WG_SLOTS - 1 < ns) load(s + WG_SLOTS - 1);
    cp_async_commit();
    const bf16* At = S + (s % WG_SLOTS) * 2 * TILE;
    const bf16* Bt = At + TILE;
    if (bias == 2 && s + 1 < ns) gload(gnext, s + 1);
    // A fragments of the transposed operand: matrix l / 8 covers K rows
    // 8 (l / 16) and columns 8 ((l / 8) % 2) of its 16 x 16
    const bf16* pa = At + ((lane & 7) + 8 * (lane >> 4)) * LDT + mw +
                     8 * ((lane >> 3) & 1);
    const bf16* pb = Bt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDT + nw +
                     8 * (lane >> 4);
#pragma unroll
    for (int ks = 0; ks < TW / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4_trans(a[mt], pa + 16 * ks * LDT + 16 * mt);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, pb + 16 * ks * LDT + 16 * np);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][2 * np], a[mt], bv[0], bv[1]);
          mma16816(acc[mt][2 * np + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
    if (bias == 1) {               // rows 32 bh .. + 32 of the dz tile
#pragma unroll
      for (int r = 0; r < 32; ++r) bsum += to_f(At[(32 * bh + r) * LDT + bc]);
    } else if (bias == 2) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        gsum.x += gcur[k].x;
        gsum.y += gcur[k].y;
        gsum.z += gcur[k].z;
        gsum.w += gcur[k].w;
        gcur[k] = gnext[k];
      }
    }
  }
  const int gq = lane >> 2, q = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = i0 + mw + 16 * mt + gq + 8 * hr;
        const int col = j0 + nw + 8 * n + q;
        if (row < M1 && col < M2)
          *reinterpret_cast<float2*>(C + (size_t)row * M2 + col) =
              make_float2(acc[mt][n][2 * hr], acc[mt][n][2 * hr + 1]);
      }
  if (bias) {                      // the partial sums, in a fixed order
    cp_async_wait<0>();
    __syncthreads();               // the ring's last reads are done
    float* part = reinterpret_cast<float*>(tc_smem);   // [8][64]
    if (bias == 1) {
      if (bh == 1) part[bc] = bsum;
    } else {
      *reinterpret_cast<float4*>(part + 64 * grow + gc4) = gsum;
    }
    __syncthreads();
    if (threadIdx.x < 64 && i0 + threadIdx.x < M1) {
      const int col = threadIdx.x;
      if (bias == 1) {
        db1[i0 + col] = bsum + part[col];
      } else {
        float t = 0.f;
        for (int k = 0; k < 8; ++k) t += part[64 * k + col];
        db2[i0 + col] = t;
      }
    }
  }
}

int forward_tc(int nt, const void* x, const void* w1, const float* b1,
               const void* w2, const float* b2, const void* res, void* out,
               int N, int D, int Fd, int Do, int act, float alpha, int pick,
               Drop drop, Drop rdrop, cudaStream_t s) {
  const int slots = fwd_slots(D);
  const size_t smem = fwd_tc_smem(D, slots);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  return by_tiles(nt, [&](auto v) {
    constexpr int NT = decltype(v)::value;
    static SmemSet set;
    cudaError_t err = allow_smem(ffn_fwd_tc<NT>, smem, set);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(tiles64(N), (tiles64(Do) + NT - 1) / NT);
    ffn_fwd_tc<NT><<<grid, TCT, smem, s>>>(
        (const bf16*)x, (const bf16*)w1, b1, (const bf16*)w2, b2,
        (const bf16*)res, (bf16*)out, N, D, Fd, Do, act, alpha, pick, slots,
        drop, rdrop);
    return (int)cudaGetLastError();
  });
}

int backward_tc(int nt, const void* x, const void* w1, const float* b1,
                const void* w2, const void* g, void* dx, void* ht, void* dz,
                void* gc, float* gs, float* dw1, float* db1, float* dw2,
                float* db2, int N, int D, int Fd, int Do, int act,
                float alpha, int pick, Drop drop, Drop rdrop,
                cudaStream_t s) {
  const int slots = bwd_slots(D, Do);
  const size_t smem = bwd_tc_smem(D, Do, slots);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  int err = by_tiles(nt, [&](auto v) {
    constexpr int NT = decltype(v)::value;
    static SmemSet set;
    cudaError_t e = allow_smem(ffn_bwd_rows_tc<NT>, smem, set);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(tiles64(N), (tiles64(D) + NT - 1) / NT);
    ffn_bwd_rows_tc<NT><<<grid, TCT, smem, s>>>(
        (const bf16*)x, (const bf16*)w1, b1, (const bf16*)w2, (const bf16*)g,
        (bf16*)dx, (bf16*)ht, (bf16*)dz, (bf16*)gc, gs, N, D, Fd, Do, act,
        alpha, pick, slots, drop, rdrop);
    return (int)cudaGetLastError();
  });
  if (err) return err;
  static SmemSet wg_set;
  if ((err = (int)allow_smem(ffn_wgrad_tc, WG_SMEM, wg_set))) return err;
  const int blocks = tiles64(Fd) * tiles64(D) + tiles64(Do) * tiles64(Fd);
  ffn_wgrad_tc<<<blocks, WGT, WG_SMEM, s>>>(
      (const bf16*)dz, (const bf16*)x, dw1, db1, (const bf16*)gc,
      (const bf16*)ht, gs, dw2, db2, N, D, Fd, Do);
  return (int)cudaGetLastError();
}

// a kernel's shared memory (static plus `dynamic`), registers and local
// (spill) bytes a thread -> out[0..2]
template <typename Kern>
int attrs_of(Kern kern, size_t dynamic, long long* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return (int)err;
  out[0] = (long long)(a.sharedSizeBytes + dynamic);
  out[1] = a.numRegs;
  out[2] = (long long)a.localSizeBytes;
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. res may be null (no residual epilogue).
// rows: float32, the rows of a block (1, 2, 4, 8 or 16); bfloat16, the
// 64-wide output tiles of a block (1, 2 or 4; ops/cuda_ffn.py
// tc_geometry). drop_*/rdrop_*: inner and residual dropout (on, seed,
// threshold, scale).
extern "C" int ffn_forward(const void* x, const void* w1, const float* b1,
                           const void* w2, const float* b2, const void* res,
                           void* out, int N, int D, int Fd, int Do, int rows,
                           int act, float alpha, int dtype, int pick,
                           int drop_on, unsigned int seed,
                           unsigned int thresh, float scale, int rdrop_on,
                           unsigned int rseed, unsigned int rthresh,
                           float rscale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Drop drop{drop_on, seed, thresh, scale};
  const Drop rdrop{rdrop_on, rseed, rthresh, rscale};
  if (dtype == 0)
    return dispatch_fwd<float>(rows, x, w1, b1, w2, b2, res, out, N, D, Fd,
                               Do, act, alpha, pick, drop, rdrop, s);
  if (dtype == 1)
    return forward_tc(rows, x, w1, b1, w2, b2, res, out, N, D, Fd, Do, act,
                      alpha, pick, drop, rdrop, s);
  return (int)cudaErrorInvalidValue;
}

// g: output cotangent (N, Do). Scratch ht, dz (N, Fd), gc (N, Do) in the
// compute dtype and gs (N, Do) float32; outputs dx (N, D) in the compute
// dtype, dw1 (Fd, D), db1 (Fd), dw2 (Do, Fd), db2 (Do) float32. rows: as
// ffn_forward's (bfloat16: the block's 64-wide dx tiles).
extern "C" int ffn_backward(const void* x, const void* w1, const float* b1,
                            const void* w2, const void* g, void* dx,
                            void* ht, void* dz, void* gc, float* gs,
                            float* dw1, float* db1, float* dw2, float* db2,
                            int N, int D, int Fd, int Do, int rows, int act,
                            float alpha, int dtype, int pick, int drop_on,
                            unsigned int seed, unsigned int thresh,
                            float scale, int rdrop_on, unsigned int rseed,
                            unsigned int rthresh, float rscale,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Drop drop{drop_on, seed, thresh, scale};
  const Drop rdrop{rdrop_on, rseed, rthresh, rscale};
  if (dtype == 0)
    return backward<float>(rows, x, w1, b1, w2, g, dx, ht, dz, gc, gs, dw1,
                           db1, dw2, db2, N, D, Fd, Do, act, alpha, pick,
                           drop, rdrop, s);
  if (dtype == 1)
    return backward_tc(rows, x, w1, b1, w2, g, dx, ht, dz, gc, gs, dw1, db1,
                       dw2, db2, N, D, Fd, Do, act, alpha, pick, drop, rdrop,
                       s);
  return (int)cudaErrorInvalidValue;
}

// The built bf16 kernels' resources, for the reckoning in ops/cuda_ffn.py
// (tc_smem_bytes, tc_register_budget), which the smoke run holds them to:
// kind 0 ffn_fwd_tc<nt> at width D, 1 ffn_bwd_rows_tc<nt> at widths D, Do,
// 2 ffn_wgrad_tc; out[0] shared memory (static plus dynamic), out[1]
// registers a thread, out[2] local (spill) bytes a thread, out[3] ring
// slots.
extern "C" int ffn_tc_attrs(int kind, int nt, int D, int Do,
                            long long* out) {
  if (kind == 2) {
    out[3] = WG_SLOTS;
    return attrs_of(ffn_wgrad_tc, WG_SMEM, out);
  }
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  return by_tiles(nt, [&](auto v) {
    constexpr int NT = decltype(v)::value;
    if (kind == 0) {
      out[3] = fwd_slots(D);
      return attrs_of(ffn_fwd_tc<NT>, fwd_tc_smem(D, (int)out[3]), out);
    }
    out[3] = bwd_slots(D, Do);
    return attrs_of(ffn_bwd_rows_tc<NT>, bwd_tc_smem(D, Do, (int)out[3]),
                    out);
  });
}
