// The fused Conv2d-prenet core, forward and backward:
//   out = conv2(act(g1 * conv1(mel) + b1))      pre-BN2, (B, T2, F2, C)
// conv1 3x3/2 from one channel to C (w1 (9, C)), the BatchNorm-1 affine and
// the activation in the same pass, conv2 3x3/2 from C to C (w2 (9, C, C):
// tap, input channel, output channel), both VALID.
//
// Replaces speechain_tpu/ops/pallas_prenet.py::fused_prenet_core (forward
// pl.pallas_call at :492, body _fwd_kernel :278; backward at :536, body
// _bwd_kernel :320). Rounding points as there: the mel in the compute type
// T, w1 rounded to T before conv1 (:297), z * g1 + b1 in float32 (:269),
// h = act(.) rounded to T before each tap (:313), w2 rounded (:315), float32
// sums, the output in T. Backward (:320-400): dh = conv2^T(du) in float32,
// dy = act'(z g1 + b1) dh, dw2[t] = sum h(shifted by t)^T du, A = sum
// patch^T dy with patch and dy in T (:374), sum dy and sum dy z in float32;
// the wrapper forms dw1 = A g1 and returns zero for the mel (:404-426).
//
// What bounds it on the H100: the operations. At conformer-small (mel (16,
// 801, 80), C = 256) conv2 is 60,496 output positions x 9 x 256^2
// multiply-adds: 71.4 GFLOP, 0.072 ms at bf16's tensor-core rate, 1.07 ms
// at float32's 67 TFLOP/s; the backward ~145 GFLOP. In bf16 every product
// runs on the tensor cores (mma.sync m16n8k16, float32 sums), conv1's too,
// with the weight and cotangent tiles brought in by 16-byte cp.async into
// three-stage rings (prenet_fwd_tc, prenet_bwd_dy_tc, prenet_bwd_dw2_tc,
// below the float32 kernels); in float32 on the FMA units (prenet_fwd,
// prenet_bwd_dy, prenet_bwd_dw2), as the design below says.
//
// Design of the float32 kernels. The TPU kernel's 8-row halos and
// read-modify-write sums over a sequential grid exist for Mosaic and are not
// carried over (the bf16 kernels take its phase split and 16-lane patches).
// - Forward (prenet_fwd): conv2 as an implicit product. A block owns 64
//   output channels of RT = 64 / F2 output rows of one utterance (64
//   positions at most), stages the 4 RT + 3 mel rows they read once, and
//   for every 16 input channels recomputes conv1 + affine + activation for
//   the 2 RT + 1 conv1 rows it needs into shared memory (9 multiply-adds a
//   value against conv2's 9 x 64), then adds the 9 taps' products into a
//   4 x 4 register tile per thread. The conv1 activation never reaches
//   device memory.
// - Backward, dy pass (prenet_bwd_dy): conv1 positions are walked by stride
//   phase (t1 % 2, f1 % 2), so the 64 positions of a tile are read by the
//   same conv2 taps (4, 2, 2 or 1 of them); dh is their product with w2,
//   dy follows from z recomputed from the mel, and each block keeps its
//   A, sum dy and sum dy z in registers over the work items it owns, then
//   writes one partial row. Positions that no conv2 output reads get dh = 0
//   and add nothing, so every real conv1 position counts exactly once.
// - Backward, dw2 pass (prenet_bwd_dw2): per tap and 64 x 64 tile of dw2,
//   a product over the output positions, split over S2 blocks; h is
//   recomputed from the mel for each 32-position step.
// - Partial sums are added in block order by prenet_sum_parts: no atomics,
//   the same result every run.
// In float32, conv1 is summed with explicit float32 roundings (no fused
// multiply-add), in tap order, in every kernel: the backward sees the
// forward's z and y bit for bit, and so does ops/cuda_prenet.py::
// conv1_preact on the card. In bf16 every kernel forms z by conv1_z_tc.

#include <cstdint>
#include <type_traits>

#include "mma.cuh"
#include "tiles.cuh"

namespace {

using namespace sct;

constexpr int TILE = 64;    // output positions (rows) of a block tile
constexpr int CO = 64;      // channels of a block tile
constexpr int CK = 16;      // input channels one forward step stages
constexpr int KC = 32;      // reduction depth one backward step stages
constexpr int NSUM = 11;    // dy pass sums per channel: A (9), dy, dy z

// z = sum_j m[j] w[j], j = 3 a + c reading m[a * rs + c] and w[j * ws]
__device__ __forceinline__ float conv1_z(const float* m, int rs,
                                         const float* w, int ws) {
  float z = __fmul_rn(m[0], w[0]);
#pragma unroll
  for (int j = 1; j < 9; ++j)
    z = __fadd_rn(z, __fmul_rn(m[(j / 3) * rs + j % 3], w[j * ws]));
  return z;
}

__device__ __forceinline__ float conv1_y(float z, float g, float b) {
  return __fadd_rn(__fmul_rn(z, g), b);
}

__host__ __device__ __forceinline__ int round4(int n) {
  return (n + 3) / 4 * 4;
}

// forward dynamic shared memory, in floats
__host__ __device__ __forceinline__ int fwd_smem_floats(int F, int F1,
                                                        int RT) {
  return round4((4 * RT + 3) * F) + (2 * RT + 1) * F1 * CK + 9 * CK * CO +
         9 * CK + 2 * CK;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
prenet_fwd(const T* __restrict__ mel, const T* __restrict__ w1c,
           const float* __restrict__ g1, const float* __restrict__ b1,
           const T* __restrict__ w2c, T* __restrict__ out, int Tm, int F,
           int C, int U1, int F1, int T2, int F2, int RT, int act) {
  extern __shared__ float4 smem4[];
  float* mel_s = reinterpret_cast<float*>(smem4);       // (4RT+3) x F
  float* h_s = mel_s + round4((4 * RT + 3) * F);        // conv1 pos x CK
  float* w2_s = h_s + (2 * RT + 1) * F1 * CK;           // 9 x CK x CO
  float* w1_s = w2_s + 9 * CK * CO;                     // 9 x CK
  float* gb_s = w1_s + 9 * CK;                          // g1, b1 (CK each)
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z, co0 = blockIdx.y * CO, t2_0 = blockIdx.x * RT;
  const int nmel = (4 * RT + 3) * F, nh = (2 * RT + 1) * F1 * CK;
  const T* melb = mel + (size_t)b * Tm * F;
  for (int i = tid; i < nmel; i += THREADS) {
    const int r = i / F, t = 4 * t2_0 + r;
    mel_s[i] = t < Tm ? to_f(melb[(size_t)t * F + (i - r * F)]) : 0.f;
  }
  int base[4];
  bool ok[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ty + 16 * u, lt = r / F2, f2 = r - lt * F2;
    ok[u] = r < RT * F2 && t2_0 + lt < T2;
    base[u] = ok[u] ? 2 * lt * F1 + 2 * f2 : 0;
  }
  float acc[4][4] = {};
  for (int ci0 = 0; ci0 < C; ci0 += CK) {
    __syncthreads();                   // the previous step's reads are done
    for (int i = tid; i < 9 * CK; i += THREADS)
      w1_s[i] = to_f(w1c[(size_t)(i / CK) * C + ci0 + i % CK]);
    if (tid < CK) {
      gb_s[tid] = g1[ci0 + tid];
      gb_s[CK + tid] = b1[ci0 + tid];
    }
    for (int i = tid; i < 9 * CK * CO; i += THREADS) {
      const int c = i % CO, k = (i / CO) % CK, t = i / (CO * CK);
      w2_s[i] = to_f(w2c[((size_t)t * C + ci0 + k) * C + co0 + c]);
    }
    __syncthreads();
    for (int i = tid; i < nh; i += THREADS) {
      const int k = i % CK, pos = i / CK, r1 = pos / F1, f1 = pos - r1 * F1;
      float h = 0.f;
      if (2 * t2_0 + r1 < U1) {
        const float z = conv1_z(mel_s + 2 * r1 * F + 2 * f1, F, w1_s + k, CK);
        h = round_to<T>(activate(conv1_y(z, gb_s[k], gb_s[CK + k]), act));
      }
      h_s[i] = h;
    }
    __syncthreads();
    for (int t = 0; t < 9; ++t) {
      const int off = (t / 3) * F1 + t % 3;
      const float* wt = w2_s + t * CK * CO + 4 * tx;
#pragma unroll 4
      for (int k = 0; k < CK; ++k) {
        const float4 w = *reinterpret_cast<const float4*>(wt + k * CO);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float a = h_s[(base[u] + off) * CK + k];
          acc[u][0] = fmaf(a, w.x, acc[u][0]);
          acc[u][1] = fmaf(a, w.y, acc[u][1]);
          acc[u][2] = fmaf(a, w.z, acc[u][2]);
          acc[u][3] = fmaf(a, w.w, acc[u][3]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (!ok[u]) continue;
    const int r = ty + 16 * u, lt = r / F2, f2 = r - lt * F2;
    T* o = out + (((size_t)b * T2 + t2_0 + lt) * F2 + f2) * C + co0 + 4 * tx;
#pragma unroll
    for (int v = 0; v < 4; ++v) o[v] = from_f<T>(acc[u][v]);
  }
}

// dy pass. grid (S1, C / CO). Work items (b, tile, phase), phase fastest;
// block s owns items [n s / S1, n (s + 1) / S1). part (S1, NSUM, C).
template <typename T>
__global__ void __launch_bounds__(THREADS)
prenet_bwd_dy(const T* __restrict__ mel, const T* __restrict__ w1c,
              const float* __restrict__ g1, const float* __restrict__ b1,
              const T* __restrict__ w2c, const T* __restrict__ du,
              float* __restrict__ part, int Tm, int F, int C, int U1, int F1,
              int T2, int F2, int tiles, int n_items, int act) {
  __shared__ float Ds[TILE][KC + 1];     // du at one tap: position x co
  __shared__ __align__(16) float Ws[KC][CO + 4];  // w2[t][ci][co] as [co][ci]
  __shared__ float Ms[TILE][9];          // the positions' patches
  __shared__ float w1_s[9][CO], gb_s[2][CO];
  __shared__ float red[16][CO];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ci0 = blockIdx.y * CO, S = gridDim.x, s = blockIdx.x;
  for (int i = tid; i < 9 * CO; i += THREADS)
    w1_s[i / CO][i % CO] = to_f(w1c[(size_t)(i / CO) * C + ci0 + i % CO]);
  if (tid < CO) {
    gb_s[0][tid] = g1[ci0 + tid];
    gb_s[1][tid] = b1[ci0 + tid];
  }
  float accA[9][4] = {}, asdy[4] = {}, asdyz[4] = {};
  const int lo = (int)((long long)n_items * s / S);
  const int hi = (int)((long long)n_items * (s + 1) / S);
  for (int item = lo; item < hi; ++item) {
    const int p = item % 4, tile = (item / 4) % tiles, b = item / (4 * tiles);
    const int pt = p >> 1, pf = p & 1;
    const int Vq = (F1 - pf + 1) / 2, nq = (U1 - pt + 1) / 2 * Vq;
    const int q0 = tile * TILE;
    if (q0 >= nq) continue;                       // the same for the block
    __syncthreads();                 // the previous item's Ms reads are done
    for (int i = tid; i < TILE * 9; i += THREADS) {
      const int r = i / 9, j = i - r * 9, q = q0 + r;
      float m = 0.f;
      if (q < nq) {
        const int u = q / Vq, v = q - u * Vq;
        const int t1 = 2 * u + pt, f1 = 2 * v + pf;
        m = to_f(mel[((size_t)b * Tm + 2 * t1 + j / 3) * F + 2 * f1 + j % 3]);
      }
      Ms[r][j] = m;
    }
    float acc[4][4] = {};
    for (int dt = pt; dt < 3; dt += 2) {
      for (int df = pf; df < 3; df += 2) {
        const int t = dt * 3 + df, sht = (dt - pt) / 2, shf = (df - pf) / 2;
        for (int k0 = 0; k0 < C; k0 += KC) {
          __syncthreads();
          for (int i = tid; i < TILE * KC; i += THREADS) {
            const int r = i / KC, k = i - r * KC, q = q0 + r;
            float d = 0.f;
            if (q < nq) {
              const int u = q / Vq, v = q - u * Vq;
              const int t2 = u - sht, f2 = v - shf;
              if (t2 >= 0 && t2 < T2 && f2 >= 0 && f2 < F2)
                d = to_f(du[(((size_t)b * T2 + t2) * F2 + f2) * C + k0 + k]);
            }
            Ds[r][k] = d;
          }
          for (int i = tid; i < KC * CO; i += THREADS) {
            const int c = i / KC, k = i - c * KC;
            Ws[k][c] = to_f(w2c[((size_t)t * C + ci0 + c) * C + k0 + k]);
          }
          __syncthreads();
#pragma unroll 4
          for (int k = 0; k < KC; ++k) {
            const float4 w = *reinterpret_cast<const float4*>(&Ws[k][4 * tx]);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float a = Ds[ty + 16 * u][k];
              acc[u][0] = fmaf(a, w.x, acc[u][0]);
              acc[u][1] = fmaf(a, w.y, acc[u][1]);
              acc[u][2] = fmaf(a, w.z, acc[u][2]);
              acc[u][3] = fmaf(a, w.w, acc[u][3]);
            }
          }
        }
      }
    }
    // dy and the sums, rows ty + 16 u, channels ci0 + 4 tx + v
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = ty + 16 * u;
      const bool valid = q0 + r < nq;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = 4 * tx + v;
        const float z = conv1_z(&Ms[r][0], 3, &w1_s[0][c], CO);
        const float y = conv1_y(z, gb_s[0][c], gb_s[1][c]);
        const float dy = valid ? activate_grad(y, act) * acc[u][v] : 0.f;
        const float dyc = round_to<T>(dy);
#pragma unroll
        for (int j = 0; j < 9; ++j) accA[j][v] += Ms[r][j] * dyc;
        asdy[v] += dy;
        asdyz[v] += dy * z;
      }
    }
  }
  // the block's partial: the 16 row groups added in order
  float* o = part + (size_t)s * NSUM * C + ci0;
#pragma unroll
  for (int qi = 0; qi < NSUM; ++qi) {
    __syncthreads();
#pragma unroll
    for (int v = 0; v < 4; ++v)
      red[ty][4 * tx + v] = qi < 9 ? accA[qi < 9 ? qi : 0][v]
                                   : (qi == 9 ? asdy[v] : asdyz[v]);
    __syncthreads();
    if (tid < CO) {
      float acc = 0.f;
      for (int w = 0; w < 16; ++w) acc += red[w][tid];
      o[(size_t)qi * C + tid] = acc;
    }
  }
}

// dw2 pass. grid (S2, (C / CO)^2, 9): split, (ci tile, co tile), tap.
// part (S2, 9, C, C).
template <typename T>
__global__ void __launch_bounds__(THREADS)
prenet_bwd_dw2(const T* __restrict__ mel, const T* __restrict__ w1c,
               const float* __restrict__ g1, const float* __restrict__ b1,
               const T* __restrict__ du, float* __restrict__ part, int B,
               int Tm, int F, int C, int T2, int F2, int act) {
  __shared__ float Ms[KC][9];
  __shared__ float Hs[KC][CO];                  // h: position x ci
  __shared__ __align__(16) float Gs[KC][CO];   // du: position x co
  __shared__ float w1_s[9][CO], gb_s[2][CO];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nt = C / CO, t = blockIdx.z, dt = t / 3, df = t % 3;
  const int ci0 = (blockIdx.y / nt) * CO, co0 = (blockIdx.y % nt) * CO;
  const int S = gridDim.x, s = blockIdx.x, per_b = T2 * F2;
  for (int i = tid; i < 9 * CO; i += THREADS)
    w1_s[i / CO][i % CO] = to_f(w1c[(size_t)(i / CO) * C + ci0 + i % CO]);
  if (tid < CO) {
    gb_s[0][tid] = g1[ci0 + tid];
    gb_s[1][tid] = b1[ci0 + tid];
  }
  const long long n = (long long)B * per_b;
  const int lo = (int)(n * s / S), hi = (int)(n * (s + 1) / S);
  float acc[4][4] = {};
  for (int p0 = lo; p0 < hi; p0 += KC) {
    __syncthreads();
    for (int i = tid; i < KC * 9; i += THREADS) {
      const int k = i / 9, j = i - k * 9, p = p0 + k;
      float m = 0.f;
      if (p < hi) {
        const int b = p / per_b, rem = p - b * per_b;
        const int t2 = rem / F2, f2 = rem - t2 * F2;
        const int t1 = 2 * t2 + dt, f1 = 2 * f2 + df;
        m = to_f(mel[((size_t)b * Tm + 2 * t1 + j / 3) * F + 2 * f1 + j % 3]);
      }
      Ms[k][j] = m;
    }
    for (int i = tid; i < KC * CO; i += THREADS) {
      const int k = i / CO, c = i - k * CO, p = p0 + k;
      Gs[k][c] = p < hi ? to_f(du[(size_t)p * C + co0 + c]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < KC * CO; i += THREADS) {
      const int k = i / CO, c = i - k * CO;
      float h = 0.f;
      if (p0 + k < hi) {
        const float z = conv1_z(&Ms[k][0], 3, &w1_s[0][c], CO);
        h = round_to<T>(activate(conv1_y(z, gb_s[0][c], gb_s[1][c]), act));
      }
      Hs[k][c] = h;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      const float4 g = *reinterpret_cast<const float4*>(&Gs[k][4 * tx]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = Hs[k][ty + 16 * u];
        acc[u][0] = fmaf(a, g.x, acc[u][0]);
        acc[u][1] = fmaf(a, g.y, acc[u][1]);
        acc[u][2] = fmaf(a, g.z, acc[u][2]);
        acc[u][3] = fmaf(a, g.w, acc[u][3]);
      }
    }
  }
  float* o = part + ((size_t)s * 9 + t) * C * C;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      o[(size_t)(ci0 + ty + 16 * u) * C + co0 + 4 * tx + v] = acc[u][v];
}


// ---- bf16: the products on the tensor cores, the tiles by cp.async ----
// mma.sync m16n8k16 (bf16 in, float32 sums; mma.cuh); each block has 8
// warps and one block runs on an SM (launch bounds 256, 1: up to 255
// registers a thread). The products of bf16 values are exact in float32, so
// only the order of the float32 sums differs from the FMA kernels, and every
// rounding point is theirs; conv1 runs on the tensor cores too (conv1_z_tc).

constexpr int STAGES = 3;   // depth of every cp.async ring
// forward
constexpr int TM = 128;     // output positions (rows) of a block tile
constexpr int NB = 256;     // output channels a forward or dw2 block owns
constexpr int RTMAX = 32;   // output rows of a block tile, at most
constexpr int CKF = 64;     // input channels of one h chunk
constexpr int HSF = CKF + 8;  // bf16 row strides: h planes (9 x 16 bytes),
constexpr int WSF = NB + 8;   // w2 / du tiles over NB channels (33 x 16);
// an odd count of 16-byte units puts the 8 rows an ldmatrix phase reads in
// 8 distinct bank groups
// dy pass
constexpr int TQ = 128;     // conv1 positions (of one stride phase) an item
constexpr int NQ = 128;     // input channels a dy block owns
constexpr int KQ = 128;     // output channels (the reduction) of one step
constexpr int DS = KQ + 8;  // bf16 row stride of its du and w2 tiles
// dw2 pass
constexpr int MW = 128;     // input channels a dw2 block owns
constexpr int KP = 64;      // output positions of one step
constexpr int HSW = MW + 8; // bf16 row stride of its h tile

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}

__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// the 8 x 8 bf16 matrix held as mma fragments (lane l: row l / 4, columns
// 2 (l % 4), +1) transposed in registers
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t v) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(r) : "r"(v));
  return r;
}

// conv1 on the tensor cores. The patch matrix has 16 columns, k = 3 a + c
// for the tap (a, c) (mel[2 t1 + a][2 f1 + c]) and zeros from k = 9, as the
// reference's build_patches pads it (pallas_prenet.py:142-173); w1 is its
// (16, C) right factor, rows 9-15 zero.
// The A fragment of 16 patch rows: row g at lo, row g + 8 at hi (pointers to
// the patch's first mel element, row stride rs; null for a zero row).
__device__ __forceinline__ void patch_frag(uint32_t (&a)[4],
                                           const __nv_bfloat16* lo,
                                           const __nv_bfloat16* hi, int rs) {
  const int q = 2 * (threadIdx.x % 4);      // k = q, q + 1 (<= 7)
  const int o0 = (q / 3) * rs + q % 3, o1 = ((q + 1) / 3) * rs + (q + 1) % 3;
  a[0] = lo ? bf16_pair(lo[o0], lo[o1]) : 0u;
  a[1] = hi ? bf16_pair(hi[o0], hi[o1]) : 0u;
  a[2] = lo && q == 0 ? bf16_bits(lo[2 * rs + 2]) : 0u;   // k = 8
  a[3] = hi && q == 0 ? bf16_bits(hi[2 * rs + 2]) : 0u;
}

// w1's B fragment for conv1 output column c (this lane's g; w1c (9, C))
__device__ __forceinline__ void w1_frag(uint32_t& b0, uint32_t& b1,
                                        const __nv_bfloat16* w1c, int C,
                                        int c) {
  const int q = 2 * (threadIdx.x % 4);
  b0 = bf16_pair(w1c[q * C + c], w1c[(q + 1) * C + c]);
  b1 = q == 0 ? bf16_bits(w1c[8 * C + c]) : 0u;
}

// z of a 16 x 8 tile of conv1 outputs: one product from zero. Every bf16
// kernel forms z here, from the same bf16 operands in the same k order, so
// the backward passes see the forward's z, and y = z g1 + b1, bit for bit.
__device__ __forceinline__ void conv1_z_tc(float (&z)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  z[0] = z[1] = z[2] = z[3] = 0.f;
  mma16816(z, a, b0, b1);
}

// Forward. A block owns RT = min(TM / F2, RTMAX) output rows of one
// utterance (RT F2 <= 128 positions; 114 at F2 19; RTMAX keeps h's planes
// within shared memory at F2 < 4) and NB output channels. conv1's activation
// h lives in shared memory as four stride-phase planes (the reference's
// phase split): plane 2 pt + pf, row u Vp + v holds the block's conv1
// position (2 u + pt, 2 v + pf), Up = RT + 1 rows of Vp = F2 + 1, so the
// A rows of a tap (dt, df) are the output rows shifted within plane
// 2 (dt % 2) + df % 2 by (dt / 2) Vp + df / 2, read by ldmatrix with an
// address per lane. The block walks the input channels in chunks of CKF:
// h for the chunk (conv1 on the tensor cores, then the affine, the
// activation and the bf16 rounding in float32 registers), then the 9 taps'
// products, each against a CKF x NB tile of w2 copied straight from its
// [tap][ci][co] layout through a STAGES-deep cp.async ring and read by
// ldmatrix.trans; the copies of the next two tiles overlap each product.
// Warp w owns rows 64 (w / 4) .. + 64 and channels 64 (w % 4) .. + 64 (4 x
// 8 tiles of 16 x 8). L2 traffic: every block reads all of w2, 544 blocks
// x 1.18 MB = 0.64 GB at the path shape (64-row tiles of 3 rows: 1.26 GB).

__host__ __device__ __forceinline__ int fwd_rows_per_block(int F2) {
  const int rows = TM / F2;
  return rows < RTMAX ? rows : RTMAX;
}

// the four planes' rows, rounded up to whole 16-row tiles
__host__ __device__ __forceinline__ int fwd_h_rows(int F2, int RT) {
  return (4 * (RT + 1) * (F2 + 1) + 15) / 16 * 16;
}

// dynamic shared memory of prenet_fwd_tc, in bytes: the ring, h planes and
// the block's mel rows (bf16, rounded to 16 bytes)
__host__ __device__ __forceinline__ size_t fwd_tc_smem_bytes(int F, int F2) {
  const int RT = fwd_rows_per_block(F2);
  return 2 * ((size_t)STAGES * CKF * WSF + (size_t)fwd_h_rows(F2, RT) * HSF +
              ((4 * RT + 3) * F + 7) / 8 * 8);
}

__global__ void __launch_bounds__(THREADS, 1)
prenet_fwd_tc(const __nv_bfloat16* __restrict__ mel,
              const __nv_bfloat16* __restrict__ w1c,
              const float* __restrict__ g1, const float* __restrict__ b1,
              const __nv_bfloat16* __restrict__ w2c,
              __nv_bfloat16* __restrict__ out, int Tm, int F, int C, int T2,
              int F2, int act) {
  extern __shared__ float4 smem4[];
  const int RT = fwd_rows_per_block(F2), Vp = F2 + 1, PL = (RT + 1) * Vp;
  const int NPR = fwd_h_rows(F2, RT);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* h_s = ring + STAGES * CKF * WSF;         // NPR x HSF
  __nv_bfloat16* mel_s = h_s + NPR * HSF;                 // (4RT+3) x F
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = 2 * (lane % 4);
  const int wm = warp >> 2, wn = warp & 3;
  const int b = blockIdx.z, t2_0 = blockIdx.x * RT, cb = blockIdx.y * NB;
  const int ncols = min(NB, C - cb);
  const bool active = 64 * wn < ncols;     // C % 256 = 128: half the warps
  const int nmel = (4 * RT + 3) * F;
  const __nv_bfloat16* melb = mel + ((size_t)b * Tm + 4 * t2_0) * F;
  const int mel_rows = min(4 * RT + 3, Tm - 4 * t2_0);
  for (int i = tid; i < nmel; i += THREADS)
    mel_s[i] = i < mel_rows * F ? melb[i] : __float2bfloat16(0.f);
  // this lane's ldmatrix row in each of its 4 row tiles: the output
  // position's row in a plane (row 0 past the tile's positions)
  int abase[4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int r = 64 * wm + 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int lt = r / F2, f2 = r - lt * F2;
    abase[mt] = r < RT * F2 && t2_0 + lt < T2 ? lt * Vp + f2 : 0;
  }
  const int nsteps = (C / CKF) * 9;
  auto load = [&](int s) {                  // w2 tile (chunk s / 9, tap s % 9)
    const int cc = s / 9, t = s - cc * 9, per_row = ncols / 8;
    __nv_bfloat16* dst = ring + (s % STAGES) * CKF * WSF;
    const __nv_bfloat16* src = w2c + ((size_t)t * C + cc * CKF) * C + cb;
    for (int i = tid; i < CKF * per_row; i += THREADS) {
      const int k = i / per_row, c = (i - k * per_row) * 8;
      cp_async16(dst + k * WSF + c, src + (size_t)k * C + c, true);
    }
  };
  load(0);
  cp_async_commit();
  if (nsteps > 1) load(1);
  cp_async_commit();
  float acc[4][8][4] = {};
  for (int s = 0; s < nsteps; ++s) {
    const int cc = s / 9, t = s - cc * 9;
    if (t == 0) {                       // h for input channels cc CKF ..
      __syncthreads();                  // mel_s is filled (s = 0); the last
                                        // chunk's products are done
      const int ci0 = cc * CKF;
      uint32_t wb0[CKF / 8], wb1[CKF / 8];
#pragma unroll
      for (int n = 0; n < CKF / 8; ++n)
        w1_frag(wb0[n], wb1[n], w1c, C, ci0 + 8 * n + g);
      with_act(act, [&](auto a_) {
        constexpr int A = decltype(a_)::value;
        for (int mt = warp; mt < NPR / 16; mt += 8) {
          const __nv_bfloat16* pp[2];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int R = 16 * mt + g + 8 * hr, pl = R / PL, rem = R - pl * PL;
            const int u = rem / Vp, v = rem - u * Vp;
            const int t1 = 2 * u + (pl >> 1), f1 = 2 * v + (pl & 1);
            pp[hr] = R < 4 * PL && t1 <= 2 * RT && f1 <= 2 * F2
                         ? mel_s + 2 * t1 * F + 2 * f1 : nullptr;
          }
          uint32_t pa[4];
          patch_frag(pa, pp[0], pp[1], F);
#pragma unroll
          for (int n = 0; n < CKF / 8; ++n) {
            float z[4];
            conv1_z_tc(z, pa, wb0[n], wb1[n]);
            const int c = ci0 + 8 * n + q;
            const float ga = g1[c], gb = g1[c + 1], ba = b1[c], bb = b1[c + 1];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const float h0 =
                  pp[hr] ? activate(conv1_y(z[2 * hr], ga, ba), A) : 0.f;
              const float h1 =
                  pp[hr] ? activate(conv1_y(z[2 * hr + 1], gb, bb), A) : 0.f;
              *reinterpret_cast<uint32_t*>(
                  h_s + (16 * mt + g + 8 * hr) * HSF + 8 * n + q) =
                  pack_bf16(h0, h1);
            }
          }
        }
      });
    }
    cp_async_wait<1>();
    __syncthreads();                    // tile s and h are in place
    if (s + 2 < nsteps) load(s + 2);    // into the slot tile s - 1 used
    cp_async_commit();
    if (!active) continue;
    const int dt = t / 3, df = t - dt * 3;
    const int shift = (2 * (dt & 1) + (df & 1)) * PL + (dt >> 1) * Vp +
                      (df >> 1);
    const __nv_bfloat16* wt = ring + (s % STAGES) * CKF * WSF;
#pragma unroll
    for (int ks = 0; ks < CKF / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], h_s + (abase[mt] + shift) * HSF + 16 * ks +
                               8 * (lane >> 4));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, wt + (16 * ks + (lane & 7) +
                                    8 * ((lane >> 3) & 1)) * WSF +
                                  64 * wn + 16 * np + 8 * (lane >> 4));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma16816(acc[mt][2 * np], a[mt], bq[0], bq[1]);
          mma16816(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 64 * wm + 16 * mt + g + 8 * hr, lt = r / F2;
      if (r >= RT * F2 || t2_0 + lt >= T2) continue;
      __nv_bfloat16* o = out + (((size_t)b * T2 + t2_0 + lt) * F2 + r -
                                lt * F2) * C + cb + 64 * wn + q;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<uint32_t*>(o + 8 * nt) =
            pack_bf16(acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1]);
    }
}

// dy pass. Items (utterance, tile of TQ conv1 positions of one stride
// phase), phase fastest, as the FMA kernel walks them: every position of
// an item is read by the same 1, 2 or 4 conv2 taps. grid (S1, C / NQ):
// block s owns items [n s / S1, n (s + 1) / S1) and NQ input channels;
// warp w owns rows 32 (w % 4) .. + 32 and channels 64 (w / 4) .. + 64.
// dh = sum over the taps of du (the position's conv2 output row at the tap,
// or zeros) times w2[tap]^T, on the tensor cores: one step stages a TQ x KQ
// tile of du rows and an NQ x KQ tile of w2 (both copied straight, read by
// ldmatrix) through a STAGES-deep ring that runs on across items, 128
// products a warp a step; the patches of an item's rows are loaded during
// its last step. Then, in registers: z (conv1_z_tc), dy = act'(z g1 + b1)
// dh, sum dy and sum dy z in float32, and A += patch^T round(dy) as one
// more product a 16 x 8 tile: the patch fragment and the rounded dy tile,
// both transposed by movmatrix, give its A and B operands. A stays in
// registers over the block's items, sum dy and sum dy z in shared memory
// (per row warp, added item after item by one lane a column); at the end
// the block adds its 4 row warps' sums in order into one partial row.

__host__ __device__ __forceinline__ size_t dy_tc_smem_bytes() {
  return 2 * (size_t)STAGES * (TQ + NQ) * DS;
}

__device__ __forceinline__ int dy_taps(int p) {
  return (p & 2 ? 1 : 2) * (p & 1 ? 1 : 2);
}

struct DyItem {
  int b, pt, pf, q0, nq, Vq;
};

__device__ __forceinline__ DyItem dy_item(int item, int tiles, int U1,
                                          int F1) {
  DyItem it;
  const int p = item % 4, tile = (item / 4) % tiles;
  it.b = item / (4 * tiles);
  it.pt = p >> 1;
  it.pf = p & 1;
  it.Vq = (F1 - it.pf + 1) / 2;
  it.nq = (U1 - it.pt + 1) / 2 * it.Vq;
  it.q0 = tile * TQ;
  return it;
}

// the first item at or after `item` (before hi) that holds a position
__device__ __forceinline__ int dy_next_item(int item, int hi, int tiles,
                                            int U1, int F1) {
  while (item < hi && dy_item(item, tiles, U1, F1).q0 >=
                          dy_item(item, tiles, U1, F1).nq)
    ++item;
  return item;
}

// a step of the block's walk: item, its tap j, the du column chunk kc
struct DyStep {
  int item, j, kc;
};

__device__ __forceinline__ void dy_advance(DyStep& st, int hi, int tiles,
                                           int U1, int F1, int nkc) {
  if (++st.kc < nkc) return;
  st.kc = 0;
  if (++st.j < dy_taps(st.item % 4)) return;
  st.j = 0;
  st.item = dy_next_item(st.item + 1, hi, tiles, U1, F1);
}

__global__ void __launch_bounds__(THREADS, 1)
prenet_bwd_dy_tc(const __nv_bfloat16* __restrict__ mel,
                 const __nv_bfloat16* __restrict__ w1c,
                 const float* __restrict__ g1, const float* __restrict__ b1,
                 const __nv_bfloat16* __restrict__ w2c,
                 const __nv_bfloat16* __restrict__ du,
                 float* __restrict__ part, int Tm, int F, int C, int U1,
                 int F1, int T2, int F2, int tiles, int n_items, int act) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem4);
  __shared__ float gb_s[2][NQ];
  __shared__ float sums_s[4][2][NQ];       // sum dy, sum dy z by row warp
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = 2 * (lane % 4);
  const int wm = warp & 3, wn = warp >> 2;
  const int ci0 = blockIdx.y * NQ, S = gridDim.x, s = blockIdx.x;
  const int nkc = C / KQ;
  for (int i = tid; i < NQ; i += THREADS) {
    gb_s[0][i] = g1[ci0 + i];
    gb_s[1][i] = b1[ci0 + i];
  }
  for (int i = tid; i < 4 * 2 * NQ; i += THREADS) (&sums_s[0][0][0])[i] = 0.f;
  uint32_t wb0[8], wb1[8];                 // w1 at this warp's 64 channels
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    w1_frag(wb0[nt], wb1[nt], w1c, C, ci0 + 64 * wn + 8 * nt + g);
  const int lo = (int)((long long)n_items * s / S);
  const int hi = (int)((long long)n_items * (s + 1) / S);
  // this thread's 16-byte pieces of a tile: column c_ld of rows r_ld,
  // r_ld + r_step, ...
  const int c_ld = (tid % (KQ / 8)) * 8, r_ld = tid / (KQ / 8);
  const int r_step = THREADS / (KQ / 8);
  auto load = [&](const DyStep& st, int slot) {
    const DyItem it = dy_item(st.item, tiles, U1, F1);
    const int dt = it.pt + 2 * (st.j / (it.pf ? 1 : 2));
    const int df = it.pf + 2 * (st.j % (it.pf ? 1 : 2));
    const int sht = (dt - it.pt) / 2, shf = (df - it.pf) / 2;
    __nv_bfloat16* dd = ring + slot * (TQ + NQ) * DS + c_ld;
    __nv_bfloat16* dw = dd + TQ * DS;
    for (int r = r_ld; r < TQ; r += r_step) {
      const int qq = it.q0 + r, u = qq / it.Vq, v = qq - u * it.Vq;
      const int t2 = u - sht, f2 = v - shf;
      const bool ok = qq < it.nq && t2 >= 0 && t2 < T2 && f2 >= 0 && f2 < F2;
      cp_async16(dd + r * DS,
                 ok ? du + (((size_t)it.b * T2 + t2) * F2 + f2) * C +
                          st.kc * KQ + c_ld
                    : du,
                 ok);
    }
    const __nv_bfloat16* wsrc =
        w2c + ((size_t)(3 * dt + df) * C + ci0) * C + st.kc * KQ + c_ld;
    for (int r = r_ld; r < NQ; r += r_step)
      cp_async16(dw + r * DS, wsrc + (size_t)r * C, true);
  };
  DyStep ld{dy_next_item(lo, hi, tiles, U1, F1), 0, 0};
  DyStep cu = ld;
  for (int pre = 0; pre < 2; ++pre) {
    if (ld.item < hi) {
      load(ld, pre);
      dy_advance(ld, hi, tiles, U1, F1, nkc);
    }
    cp_async_commit();
  }
  float dh[2][8][4] = {}, accA[8][4] = {};
  for (int n = 0; cu.item < hi; ++n) {
    cp_async_wait<1>();
    __syncthreads();                         // step n's tiles are in place
    if (ld.item < hi) {                      // into the slot step n - 1 used
      load(ld, (n + 2) % STAGES);
      dy_advance(ld, hi, tiles, U1, F1, nkc);
    }
    cp_async_commit();
    const __nv_bfloat16* dd = ring + (n % STAGES) * (TQ + NQ) * DS;
    const __nv_bfloat16* dw = dd + TQ * DS;
    // at an item's last step, its rows' patches: their loads overlap the
    // step's products
    const bool last = cu.kc == nkc - 1 && cu.j == dy_taps(cu.item % 4) - 1;
    const DyItem it = dy_item(cu.item, tiles, U1, F1);
    uint32_t pa[2][4];
    bool okr[2][2];
    if (last) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* pp[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int qq = it.q0 + 32 * wm + 16 * mt + g + 8 * hr;
          const int u = qq / it.Vq, v = qq - u * it.Vq;
          const int t1 = 2 * u + it.pt, f1 = 2 * v + it.pf;
          okr[mt][hr] = qq < it.nq;
          pp[hr] = okr[mt][hr] ? mel + ((size_t)it.b * Tm + 2 * t1) * F +
                                     2 * f1 : nullptr;
        }
        patch_frag(pa[mt], pp[0], pp[1], F);
      }
    }
#pragma unroll
    for (int ks = 0; ks < KQ / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], dd + (32 * wm + 16 * mt + (lane & 7) +
                                 8 * ((lane >> 3) & 1)) * DS +
                               16 * ks + 8 * (lane >> 4));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        ldmatrix_x4(bq, dw + (64 * wn + 16 * np + (lane & 7) +
                              8 * (lane >> 4)) * DS +
                            16 * ks + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(dh[mt][2 * np], a[mt], bq[0], bq[1]);
          mma16816(dh[mt][2 * np + 1], a[mt], bq[2], bq[3]);
        }
      }
    }
    if (last) with_act(act, [&](auto a_) {  // the item's dy and its sums
      constexpr int A = decltype(a_)::value;
      float sdy[8][2] = {}, sdyz[8][2] = {};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // patch^T as the A operand of A += patch^T dy: its 8 x 8 blocks
        // transposed (rows j = tap, columns = positions)
        uint32_t pT[4];
        pT[0] = movmatrix_t(pa[mt][0]);
        pT[1] = movmatrix_t(pa[mt][2]);
        pT[2] = movmatrix_t(pa[mt][1]);
        pT[3] = movmatrix_t(pa[mt][3]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          float z[4], dy[4];
          conv1_z_tc(z, pa[mt], wb0[nt], wb1[nt]);
          const int c = 64 * wn + 8 * nt + q;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float y = conv1_y(z[e], gb_s[0][c + (e & 1)],
                                    gb_s[1][c + (e & 1)]);
            dy[e] = okr[mt][e >> 1] ? activate_grad(y, A) * dh[mt][nt][e]
                                    : 0.f;
            sdy[nt][e & 1] += dy[e];
            sdyz[nt][e & 1] += dy[e] * z[e];
            dh[mt][nt][e] = 0.f;
          }
          mma16816(accA[nt], pT, movmatrix_t(pack_bf16(dy[0], dy[1])),
                   movmatrix_t(pack_bf16(dy[2], dy[3])));
        }
      }
      // the item's column sums: the 8 lanes of a column, then added to
      // this row warp's running sums by lane g = 0, item after item
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int m = 4; m < 32; m *= 2) {
            sdy[nt][e] += __shfl_xor_sync(0xffffffffu, sdy[nt][e], m);
            sdyz[nt][e] += __shfl_xor_sync(0xffffffffu, sdyz[nt][e], m);
          }
          if (g == 0) {
            sums_s[wm][0][64 * wn + 8 * nt + q + e] += sdy[nt][e];
            sums_s[wm][1][64 * wn + 8 * nt + q + e] += sdyz[nt][e];
          }
        }
    });
    dy_advance(cu, hi, tiles, U1, F1, nkc);
  }
  // the block's partial: each row warp's A rows and sums, then the 4 row
  // warps added in a fixed order
  cp_async_wait<0>();
  __syncthreads();                           // the ring is free
  float* red = reinterpret_cast<float*>(smem4);          // [4][NSUM][NQ]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 64 * wn + 8 * nt + q + e;
      red[(wm * NSUM + g) * NQ + c] = accA[nt][e];
      if (g == 0) {
        red[(wm * NSUM + 8) * NQ + c] = accA[nt][2 + e];
        red[(wm * NSUM + 9) * NQ + c] = sums_s[wm][0][c];
        red[(wm * NSUM + 10) * NQ + c] = sums_s[wm][1][c];
      }
    }
  __syncthreads();
  float* o = part + (size_t)s * NSUM * C + ci0;
  for (int i = tid; i < NSUM * NQ; i += THREADS) {
    const int row = i / NQ, c = i - row * NQ;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) sum += red[(w * NSUM + row) * NQ + c];
    o[(size_t)row * C + c] = sum;
  }
}

// dw2 pass: dw2[t] = sum over the output positions of h(conv1 position of
// the tap)^T du. grid (S2, (C / MW) ceil(C / NB), 9): split, (input
// channel tile of MW, output channel tile of NB), tap; so du is staged 9 C
// / MW times in all (18 at C 256). A block walks its split's positions in
// steps of KP: du's KP x NB tile copied straight through a STAGES-deep
// cp.async ring and read by ldmatrix.trans; h for the step's positions and
// its MW channels from conv1_z_tc into one of two KP x MW tiles (warp w:
// positions 16 (w % 4) .., channels 64 (w / 4) ..; the patches loaded
// during the step before), read by ldmatrix.trans as the A operand. Warp w owns dw2's rows 64 (w / 4) .. and columns 64 (w
// % 4) .. of the block tile, 128 products a step. The S2 partials (S2 x 9
// C^2 float32, 16.5 MB at C 256) are added in block order.

__host__ __device__ __forceinline__ size_t dw2_tc_smem_bytes() {
  return 2 * ((size_t)STAGES * KP * WSF + 2 * (size_t)KP * HSW);
}

__global__ void __launch_bounds__(THREADS, 1)
prenet_bwd_dw2_tc(const __nv_bfloat16* __restrict__ mel,
                  const __nv_bfloat16* __restrict__ w1c,
                  const float* __restrict__ g1, const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ du,
                  float* __restrict__ part, int B, int Tm, int F, int C,
                  int T2, int F2, int act) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* hbuf = ring + STAGES * KP * WSF;     // 2 x KP x HSW
  __shared__ float gb_s[2][MW];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = 2 * (lane % 4);
  const int wm = warp >> 2, wn = warp & 3;
  const int nci = C / MW, t = blockIdx.z, dt = t / 3, df = t - dt * 3;
  const int ci0 = (blockIdx.y % nci) * MW, cb = (blockIdx.y / nci) * NB;
  const int ncols = min(NB, C - cb);
  const bool active = 64 * wn < ncols;
  const int S = gridDim.x, s = blockIdx.x, per_b = T2 * F2;
  for (int i = tid; i < MW; i += THREADS) {
    gb_s[0][i] = g1[ci0 + i];
    gb_s[1][i] = b1[ci0 + i];
  }
  const int hm = warp & 3, hn = warp >> 2;   // this warp's share of h
  uint32_t wb0[8], wb1[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    w1_frag(wb0[nt], wb1[nt], w1c, C, ci0 + 64 * hn + 8 * nt + g);
  const long long n = (long long)B * per_b;
  const int lo = (int)(n * s / S), hi = (int)(n * (s + 1) / S);
  const int nsteps = (hi - lo + KP - 1) / KP;
  // this thread's 16-byte pieces of a du tile: column c_ld of rows r_ld,
  // r_ld + r_step, ... (ncols / 8 threads a row)
  const int per_row = ncols / 8, c_ld = (tid % per_row) * 8;
  const int r_ld = tid / per_row, r_step = THREADS / per_row;
  auto load = [&](int j) {
    __nv_bfloat16* dst = ring + (j % STAGES) * KP * WSF + c_ld;
    for (int r = r_ld; r < KP; r += r_step) {
      const int p = lo + j * KP + r;
      cp_async16(dst + r * WSF, p < hi ? du + (size_t)p * C + cb + c_ld : du,
                 p < hi);
    }
  };
  // this warp's patch fragment of step j's positions (rows past hi: zero)
  auto patches = [&](int j, uint32_t (&pa)[4], bool (&ok)[2]) {
    const __nv_bfloat16* pp[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = lo + j * KP + 16 * hm + g + 8 * hr;
      const int bb = p / per_b, rem = p - bb * per_b;
      const int t2 = rem / F2, f2 = rem - t2 * F2;
      const int t1 = 2 * t2 + dt, f1 = 2 * f2 + df;
      ok[hr] = p < hi;
      pp[hr] = ok[hr] ? mel + ((size_t)bb * Tm + 2 * t1) * F + 2 * f1
                      : nullptr;
    }
    patch_frag(pa, pp[0], pp[1], F);
  };
  if (nsteps > 0) load(0);
  cp_async_commit();
  if (nsteps > 1) load(1);
  cp_async_commit();
  uint32_t pa[4];
  bool okr[2];
  if (nsteps > 0) patches(0, pa, okr);
  __syncthreads();                          // g1, b1 in place
  float acc[4][8][4] = {};
  for (int j = 0; j < nsteps; ++j) {
    __nv_bfloat16* hb = hbuf + (j & 1) * KP * HSW;
    with_act(act, [&](auto a_) {             // h for the step's positions
      constexpr int A = decltype(a_)::value;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float z[4];
        conv1_z_tc(z, pa, wb0[nt], wb1[nt]);
        const int c = 64 * hn + 8 * nt + q;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float h0 =
              okr[hr] ? activate(conv1_y(z[2 * hr], gb_s[0][c], gb_s[1][c]),
                                 A) : 0.f;
          const float h1 =
              okr[hr] ? activate(conv1_y(z[2 * hr + 1], gb_s[0][c + 1],
                                         gb_s[1][c + 1]), A) : 0.f;
          *reinterpret_cast<uint32_t*>(hb + (16 * hm + g + 8 * hr) * HSW +
                                       c) = pack_bf16(h0, h1);
        }
      }
    });
    if (j + 1 < nsteps) patches(j + 1, pa, okr);  // loads overlap step j
    cp_async_wait<1>();
    __syncthreads();                   // du's tile j and h are in place
    if (j + 2 < nsteps) load(j + 2);   // into the slot step j - 1 used
    cp_async_commit();
    if (!active) continue;
    const __nv_bfloat16* dt_s = ring + (j % STAGES) * KP * WSF;
#pragma unroll
    for (int ks = 0; ks < KP / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(a[mt], hb + (16 * ks + (lane & 7) +
                                       8 * (lane >> 4)) * HSW +
                                     64 * wm + 16 * mt +
                                     8 * ((lane >> 3) & 1));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, dt_s + (16 * ks + (lane & 7) +
                                      8 * ((lane >> 3) & 1)) * WSF +
                                  64 * wn + 16 * np + 8 * (lane >> 4));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma16816(acc[mt][2 * np], a[mt], bq[0], bq[1]);
          mma16816(acc[mt][2 * np + 1], a[mt], bq[2], bq[3]);
        }
      }
    }
  }
  if (!active) return;
  float* o = part + ((size_t)s * 9 + t) * C * C;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float* orow = o + (size_t)(ci0 + 64 * wm + 16 * mt + g + 8 * hr) * C +
                    cb + 64 * wn + q;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<float2*>(orow + 8 * nt) =
            make_float2(acc[mt][nt][2 * hr], acc[mt][nt][2 * hr + 1]);
    }
}

// the bf16 backward's grids: the dy pass (S1 blocks, NQ channels each) and
// the dw2 pass (S2 splits, channel tiles, taps)
__host__ __forceinline__ dim3 dy_tc_grid(int C, int S1) {
  return dim3(S1, C / NQ);
}
__host__ __forceinline__ dim3 dw2_tc_grid(int C, int S2) {
  return dim3(S2, (C / MW) * ((C + NB - 1) / NB), 9);
}
__host__ __forceinline__ dim3 fwd_tc_grid(int B, int C, int T2, int F2) {
  const int RT = fwd_rows_per_block(F2);
  return dim3((T2 + RT - 1) / RT, (C + NB - 1) / NB, B);
}

SmemSet fwd_tc_set, dy_tc_set, dw2_tc_set;

__global__ void prenet_sum_parts(const float* __restrict__ part,
                                 float* __restrict__ out, int n_part, int W) {
  sum_parts(part, out, n_part, W);
}

// the shapes the kernels take: T2 >= 2 (as the gate), 1 <= F2 <= 64 (a
// forward tile holds two output rows or more); C a multiple of 64 in
// float32, of 128 in bf16 (whole dy / dw2 channel tiles)
__host__ __forceinline__ bool shapes_ok(int dtype, int T2, int F2, int C) {
  return T2 >= 2 && F2 >= 1 && F2 <= TILE && C > 0 &&
         C % (dtype == 0 ? CO : NQ) == 0;
}

template <typename T>
cudaError_t forward(const void* mel, const void* w1c, const float* g1,
                    const float* b1, const void* w2c, void* out, int B,
                    int Tm, int F, int C, int act, cudaStream_t st) {
  const int U1 = (Tm - 3) / 2 + 1, F1 = (F - 3) / 2 + 1;
  const int T2 = (U1 - 3) / 2 + 1, F2 = (F1 - 3) / 2 + 1;
  constexpr bool bf = std::is_same<T, __nv_bfloat16>::value;
  if (!shapes_ok(bf, T2, F2, C)) return cudaErrorInvalidValue;
  cudaError_t e;
  if constexpr (bf) {
    const size_t smem = fwd_tc_smem_bytes(F, F2);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    if ((e = allow_smem(prenet_fwd_tc, smem, fwd_tc_set)) != cudaSuccess)
      return e;
    prenet_fwd_tc<<<fwd_tc_grid(B, C, T2, F2), THREADS, smem, st>>>(
        (const T*)mel, (const T*)w1c, g1, b1, (const T*)w2c, (T*)out, Tm, F,
        C, T2, F2, act);
  } else {
    const int RT = TILE / F2;
    const dim3 grid((T2 + RT - 1) / RT, C / CO, B);
    const size_t smem = sizeof(float) * fwd_smem_floats(F, F1, RT);
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(prenet_fwd<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    prenet_fwd<T><<<grid, THREADS, smem, st>>>(
        (const T*)mel, (const T*)w1c, g1, b1, (const T*)w2c, (T*)out, Tm, F,
        C, U1, F1, T2, F2, RT, act);
  }
  return cudaGetLastError();
}

// dy items: tiles of `tile` positions of the largest stride phase
__host__ __forceinline__ int dy_tiles(int U1, int F1, int tile) {
  return ((U1 + 1) / 2 * ((F1 + 1) / 2) + tile - 1) / tile;
}

template <typename T>
cudaError_t backward(const void* mel, const void* w1c, const float* g1,
                     const float* b1, const void* w2c, const void* du,
                     float* dw2, float* sums, float* part1, float* part2,
                     int B, int Tm, int F, int C, int act, int S1, int S2,
                     cudaStream_t st) {
  const int U1 = (Tm - 3) / 2 + 1, F1 = (F - 3) / 2 + 1;
  const int T2 = (U1 - 3) / 2 + 1, F2 = (F1 - 3) / 2 + 1;
  constexpr bool bf = std::is_same<T, __nv_bfloat16>::value;
  if (!shapes_ok(bf, T2, F2, C) || S1 < 1 || S2 < 1)
    return cudaErrorInvalidValue;
  cudaError_t e;
  if constexpr (bf) {
    const int tiles = dy_tiles(U1, F1, TQ);
    if ((e = allow_smem(prenet_bwd_dy_tc, dy_tc_smem_bytes(), dy_tc_set)) ||
        (e = allow_smem(prenet_bwd_dw2_tc, dw2_tc_smem_bytes(), dw2_tc_set)))
      return e;
    prenet_bwd_dy_tc<<<dy_tc_grid(C, S1), THREADS, dy_tc_smem_bytes(),
                       st>>>(
        (const T*)mel, (const T*)w1c, g1, b1, (const T*)w2c, (const T*)du,
        part1, Tm, F, C, U1, F1, T2, F2, tiles, B * tiles * 4, act);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    prenet_bwd_dw2_tc<<<dw2_tc_grid(C, S2), THREADS, dw2_tc_smem_bytes(),
                        st>>>(
        (const T*)mel, (const T*)w1c, g1, b1, (const T*)du, part2, B, Tm, F,
        C, T2, F2, act);
  } else {
    const int tiles = dy_tiles(U1, F1, TILE), nt = C / CO;
    prenet_bwd_dy<T><<<dim3(S1, nt), THREADS, 0, st>>>(
        (const T*)mel, (const T*)w1c, g1, b1, (const T*)w2c, (const T*)du,
        part1, Tm, F, C, U1, F1, T2, F2, tiles, B * tiles * 4, act);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    prenet_bwd_dw2<T><<<dim3(S2, nt * nt, 9), THREADS, 0, st>>>(
        (const T*)mel, (const T*)w1c, g1, b1, (const T*)du, part2, B, Tm, F,
        C, T2, F2, act);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  prenet_sum_parts<<<(NSUM * C + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part1, sums, S1, NSUM * C);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  prenet_sum_parts<<<(9 * C * C + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part2, dw2, S2, 9 * C * C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mel (B, Tm, F) in float32 (dtype 0) or bf16 (dtype 1); w1c (9, C) and
// w2c (9, C, C) in the same type; g1, b1 (C,) float32; out (B, T2, F2, C).
int prenet_core_forward(const void* mel, const void* w1c, const float* g1,
                        const float* b1, const void* w2c, void* out, int B,
                        int Tm, int F, int C, int act, int dtype,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? forward<float>(mel, w1c, g1, b1, w2c, out, B, Tm, F, C,
                                    act, st)
                   : forward<__nv_bfloat16>(mel, w1c, g1, b1, w2c, out, B,
                                            Tm, F, C, act, st));
}

// w2c (9, C, C) in the mel's type; du (B,
// T2, F2, C) in the mel's type; dw2 (9, C, C) and sums (11 C: A (9, C),
// sum dy, sum dy z) float32 out; part1 (S1, 11 C), part2 (S2, 9 C C)
// float32 scratch.
int prenet_core_backward(const void* mel, const void* w1c, const float* g1,
                         const float* b1, const void* w2c, const void* du,
                         float* dw2, float* sums, float* part1, float* part2,
                         int B, int Tm, int F, int C, int act, int dtype,
                         int S1, int S2, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? backward<float>(mel, w1c, g1, b1, w2c, du, dw2, sums,
                                     part1, part2, B, Tm, F, C, act, S1, S2,
                                     st)
                   : backward<__nv_bfloat16>(mel, w1c, g1, b1, w2c, du, dw2,
                                             sums, part1, part2, B, Tm, F, C,
                                             act, S1, S2, st));
}

// The bf16 kernels' layout for a call (B, Tm, F, C) with splits S1, S2:
// out[0..2] the shared memory, static plus dynamic, of prenet_fwd_tc,
// prenet_bwd_dy_tc and prenet_bwd_dw2_tc; out[3..11] their (x, y, z)
// blocks. ops/cuda_prenet.py tc_smem_bytes and tc_grids reckon the same
// without a card; the smoke run holds them equal. cudaErrorInvalidValue for
// a shape the bf16 kernels do not take.
int prenet_layout(int B, int Tm, int F, int C, int S1, int S2,
                  long long* out) {
  const int U1 = (Tm - 3) / 2 + 1, F1 = (F - 3) / 2 + 1;
  const int T2 = (U1 - 3) / 2 + 1, F2 = (F1 - 3) / 2 + 1;
  if (B < 1 || !shapes_ok(1, T2, F2, C) || S1 < 1 || S2 < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = smem_of(prenet_fwd_tc, fwd_tc_smem_bytes(F, F2), out)) ||
      (err = smem_of(prenet_bwd_dy_tc, dy_tc_smem_bytes(), out + 1)) ||
      (err = smem_of(prenet_bwd_dw2_tc, dw2_tc_smem_bytes(), out + 2)))
    return (int)err;
  const dim3 grids[3] = {fwd_tc_grid(B, C, T2, F2), dy_tc_grid(C, S1),
                         dw2_tc_grid(C, S2)};
  for (int i = 0; i < 3; ++i) {
    out[3 + 3 * i] = grids[i].x;
    out[4 + 3 * i] = grids[i].y;
    out[5 + 3 * i] = grids[i].z;
  }
  return 0;
}

}  // extern "C"
