// Split-TF32 tensor-core helpers shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu).
//
// mma.sync m16n8k8 TF32 with float32 accumulation keeps float32 accuracy
// when every operand a is split into hi = tf32(a) and lo = tf32(a - hi)
// (tf32() drops the low 13 mantissa bits) and the product is summed as
// hi.lo + lo.hi + hi.hi: three TF32 passes; the dropped lo.lo term is below
// 2^-22 of the product (tests/test_torch_kernel_design.py emulates it on the
// CPU). A value that came from bfloat16 (8 mantissa bits) is exact in TF32:
// its lo is 0, and the pass that would multiply by it may be skipped.
//
// Fragment layouts of m16n8k8 (lane = 4 g + t, g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4],
//                    a3 = A[g + 8][t + 4];
//   B (8 x 8, col):  b0 = B[t][g], b1 = B[t + 4][g];
//   C (16 x 8):      c0, c1 = C[g][2t], C[g][2t + 1]; c2, c3 the same at
//                    row g + 8.
// A C fragment feeds the next product as its A operand unchanged when the
// reduction index is permuted alike in both operands: k-row t stands for
// column 2t of the C tile and k-row t + 4 for column 2t + 1, so the A
// fragment is {c0, c2, c1, c3} and the B operand is read at rows 2t, 2t + 1.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32mma {

constexpr uint32_t TF32_MASK = 0xffffe000u;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// x = hi + lo exactly; both truncated to TF32 (the low 13 mantissa bits
// zero), so the tensor core reads them as they are.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & TF32_MASK;
  lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a.b in split TF32: the two small cross terms first, then hi.hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(d, ah[0], ah[1], ah[2], ah[3], bl0, bl1);
  mma(d, al[0], al[1], al[2], al[3], bh0, bh1);
  mma(d, ah[0], ah[1], ah[2], ah[3], bh0, bh1);
}

// d += hi.hi and dx += the cross terms (pass d twice for one accumulator).
// EXACT_A / EXACT_B: that operand came from bfloat16, its lo is 0 and its
// pass is skipped.
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma_split(float (&d)[4], float (&dx)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  if (!EXACT_B) mma(dx, ah[0], ah[1], ah[2], ah[3], bl0, bl1);
  if (!EXACT_A) mma(dx, al[0], al[1], al[2], al[3], bh0, bh1);
  mma(d, ah[0], ah[1], ah[2], ah[3], bh0, bh1);
}

// The A fragment of rows r .. r + 15 and columns c .. c + 7 of a float32
// tile in shared memory, split into hi and lo.
template <int LD>
__device__ __forceinline__ void frag_a(const float (*m)[LD], int r, int c,
                                       int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(m[r + g][c + t], hi[0], lo[0]);
  split(m[r + g + 8][c + t], hi[1], lo[1]);
  split(m[r + g][c + t + 4], hi[2], lo[2]);
  split(m[r + g + 8][c + t + 4], hi[3], lo[3]);
}

// A C fragment (4 values) as the A operand of the next product, split:
// k-row t is C column 2t and k-row t + 4 column 2t + 1.
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool ok) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

}  // namespace tf32mma
