// bf16 tensor-core helpers shared by the bf16 kernels (fused_conv_bf16.cu,
// B2/B3, and flash_window_attn_bf16.cu, B1), for sm_90a.
//
// One warp-wide mma.sync.m16n8k16 (bf16 operands, fp32 accumulators) and the
// fragment loads around it. A fragment is read from shared memory with
// 32-bit loads, two bf16 values each: A as [row][k] (k contiguous), B as
// [n][k] (each output column's k contiguous). With a row stride of 4 mod 8
// 32-bit words (a stride of 8 mod 16 bf16 values) the eight rows a warp
// reads land on distinct banks.
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// g = lane / 4, t = lane % 4:
//   A 16x16: a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..), a2 (row g,
//            k 2t+8..), a3 (row g+8, k 2t+8..)
//   B 16x8:  b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g)
//   C 16x8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, cols 2t, 2t+1)
//
// Conversions are __float2bfloat16_rn (round to nearest even) and
// __bfloat162float, never a fast-math path.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats as one bf16 pair: lo in the low half (the lower column or k).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += A . B for one 16x8 tile over 16 k.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows r0..r0+15, k k0..k0+15 of a [row][k] array with
// row stride ld (bf16 values).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* base, int ld, int r0,
                                       int k0) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* p = base + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * ld);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * ld + 8);
}

// The B fragment of columns n0..n0+7, k k0..k0+15 of an [n][k] array with
// row stride ld (bf16 values).
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const bf16* base, int ld, int n0,
                                       int k0) {
  const int lane = threadIdx.x % 32;
  const bf16* p = base + (n0 + lane / 4) * ld + k0 + 2 * (lane % 4);
  b[0] = ld_u32(p);
  b[1] = ld_u32(p + 8);
}

__device__ __forceinline__ void cp_async16_bf16(bf16* dst, const bf16* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)));
}
__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
