// Tensor-core and asynchronous-copy helpers shared by the bf16 kernels
// (prenet.cu, flash_attention.cu, relpos_attention.cu, convmod.cu, ffn.cu):
// mma.sync m16n8k16 with bf16 operands and float32 accumulators, its
// operand loads (ldmatrix), accumulators turned into the next product's
// operands, reductions over a fragment row's 4 lanes, and cp.async copies
// from device to shared memory with a two-slot sweep.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, c = 2 * (lane % 4)):
//   A (16 x 16, row-major):  a0 = A[g][c..c+1],   a1 = A[g+8][c..c+1],
//                            a2 = A[g][c+8..c+9], a3 = A[g+8][c+8..c+9]
//   B (16 x 8, by column):   b0 = B[c..c+1][g],   b1 = B[c+8..c+9][g]
//   C (16 x 8):              c0, c1 = C[g][c..c+1], c2, c3 = C[g+8][c..c+1]
// so accumulator element i of n-tile n sits at row g + 8 (i / 2), column
// 8 n + c + i % 2, and the accumulators of n-tiles 2 j and 2 j + 1, packed
// to bf16 pairs, are the A fragment of k-step j of the next product.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace sct {

__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  mma16816(d, a[0], a[1], a[2], a[3], b0, b1);
}

// lo and hi rounded to bf16 (to nearest even) and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (16-byte aligned) and receives in r[m] the two
// elements (row l / 4, columns 2 (l % 4), +1) of matrix m
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same with each matrix transposed: r[m] holds the elements (rows
// 2 (l % 4), +1; column l / 4) of matrix m as stored
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two 8 x 8 bf16 matrices, each transposed, from shared memory; lanes 0-15
// give the addresses (lane l: row l % 8 of matrix l / 8), r[m] as in
// ldmatrix_x4_trans
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// the 16 x 32 accumulators s as the bf16 A fragments of the next product
// (rounded to nearest even: round_bf16 of each value)
__device__ __forceinline__ void to_a(uint32_t (&pf)[2][4],
                                     const float (&s)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    pf[ks][0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
    pf[ks][1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
    pf[ks][2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
    pf[ks][3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
  }
}

// the row pair's values reduced over the 4 lanes that share them
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16 bytes from device to shared memory, asynchronously; with ok false the
// destination is filled with zeros and src is not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(ok ? 16 : 0)
      : "memory");
}

// 4 bytes from device to shared memory, asynchronously; zeros if not ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(ok ? 4 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Products of operands staged as bf16 rows of DH + 8 values (an odd number
// of 16-byte units when DH is a multiple of 16: the 8 rows an ldmatrix
// reads fall in distinct bank groups), as the attention kernels stage
// them.
// s = A B^T over the head width: A 16 staged rows, B NT * 8 staged rows
// (s's columns), read by ldmatrix. Accumulator element i of n-tile n: row
// lane / 4 + 8 (i / 2), column 8 n + 2 (lane % 4) + i % 2.
template <int DH, int NT>
__device__ __forceinline__ void warp_scores(float (&s)[NT][4], const __nv_bfloat16* A,
                                            const __nv_bfloat16* Bm) {
  constexpr int LDS = DH + 8;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* pa =
      A + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + 8 * (lane >> 4);
  const __nv_bfloat16* pb =
      Bm + ((lane & 7) + 8 * (lane >> 4)) * LDS + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, pa + 16 * ks);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bq[4];
      ldmatrix_x4(bq, pb + 16 * np * LDS + 16 * ks);
      mma16816(s[2 * np], a, bq[0], bq[1]);
      mma16816(s[2 * np + 1], a, bq[2], bq[3]);
    }
  }
}

// acc += A V over KS k-steps of 16: A's fragments pf (one per k-step), V
// staged with its rows along K (row stride DH + 8), read transposed
template <int DH, int KS>
__device__ __forceinline__ void warp_acc(float (&acc)[DH / 8][4],
                                         const uint32_t (&pf)[KS][4],
                                         const __nv_bfloat16* V) {
  constexpr int LDS = DH + 8;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p =
      V + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + 8 * (lane >> 4);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t bq[4];
      ldmatrix_x4_trans(bq, p + 16 * ks * LDS + 16 * np);
      mma16816(acc[2 * np], pf[ks], bq[0], bq[1]);
      mma16816(acc[2 * np + 1], pf[ks], bq[2], bq[3]);
    }
}

// Runs body(j) for the tiles j < n with load(j + 1) in flight meanwhile:
// copies of tile j + 1 overlap the products of tile j. Copies issued
// before the call join tile 0's group. load(j) must stage into slot j & 1.
template <typename Load, typename Body>
__device__ __forceinline__ void sweep(int n, Load load, Body body) {
  if (n > 0) load(0);
  cp_async_commit();
  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) load(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    body(j);
    __syncthreads();
  }
}

}  // namespace sct
