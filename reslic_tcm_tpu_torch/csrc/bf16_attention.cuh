// The attention core shared by B1's two bf16 kernels (flash_window_attn_bf16.cu,
// LN+MLP, and window_attn_bf16.cu, attention-only), for sm_90a: the layout
// of a window's operands in shared memory, the epilogue of a warpgroup's
// wgmma accumulators, and one head's attention for 16 query rows on
// mma.sync m16n8k16 (scores q.k^T + rel_bias (+ the SW mask's -1e9), the row
// softmax over the quad that holds a row, bf16(P).v). Numerics: the Pallas
// body's bf16 casts (reslic_tcm_tpu/ops/flash_window_attn.py:173, :183), all
// sums and the softmax in fp32, each output one accumulator over its k16
// steps in ascending order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "window_attn_common.cuh"

namespace {

// k-group stride (bf16) of a [64 x n] operand, [n/8][64][8]: 64 rows of 8
// and 16 bytes of padding, so that a warp's fragment loads and epilogue
// stores land on distinct banks (wgmma reads it without swizzle, lbo =
// 2 * kLA bytes, sbo = 128)
constexpr int kLA = kT * 8 + 8;

// Element (row, col) of a [64 x n] operand in shared memory.
__device__ __forceinline__ int al(int row, int col) { return (col / 8) * kLA + row * 8 + col % 8; }

// epi(row, col, v0, v1) over a warpgroup's m64nN accumulators: columns col
// and col + 1 (col even) of rows row.
template <int N, class Epi>
__device__ __forceinline__ void wg_epilogue(const float (&d)[N / 2], Epi epi) {
  const int lt = threadIdx.x % 128;
  const int r = 16 * (lt / 32) + (lt % 32) / 4, c = 2 * (lt % 4);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    epi(r, 8 * j + c, d[4 * j], d[4 * j + 1]);
    epi(r + 8, 8 * j + c, d[4 * j + 2], d[4 * j + 3]);
  }
}

// The bias (rel_bias[h] at rows mt*16 + g (+8), columns 8j + 2t4, +1) of
// one head for head_attention_wg, loaded ahead of its use.
__device__ __forceinline__ void head_bias(float2 (&bv)[2][8], const float* __restrict__ rb,
                                          int mt) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[hf][j] = __ldg(reinterpret_cast<const float2*>(
          rb + (mt * 16 + lane / 4 + hf * 8) * kT + j * 8 + 2 * (lane % 4)));
}

// The row softmax of 16 query rows x 64 keys (a warp's m16 scores as
// mma.sync m16n8k16 or wgmma m64 accumulators hold them: rows mt*16 + g + 8 hf,
// keys 8j + 2t4 + e in s[j][2 hf + e]): + bias(hf, j) (the head's rel_bias
// at those rows and keys 8j + 2t4, + 1) and the SW mask's -1e9, the row
// maximum over the quad that holds the row, s = exp(s - max) in place, and
// inv[hf] = 1 / the row's sum. MASKED = false: the window has no mask
// (last_row and last_col false), whose code is then left out.
template <bool MASKED = true, class Bias>
__device__ __forceinline__ void row_softmax(float (&s)[8][4], Bias bias, int mt, bool last_row,
                                            bool last_col, float (&inv)[2]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  float mx[2] = {-3.402823466e38f, -3.402823466e38f};  // -FLT_MAX
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int p = mt * 16 + g + hf * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = j * 8 + 2 * t4;
      const float2 bv = bias(hf, j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float val = s[j][2 * hf + e] + (e == 0 ? bv.x : bv.y);
        const int qq = q + e;
        if (MASKED && last_row && ((p / kWin < kHalf) != (qq / kWin < kHalf))) val += kNegInf;
        if (MASKED && last_col && ((p % kWin < kHalf) != (qq % kWin < kHalf))) val += kNegInf;
        s[j][2 * hf + e] = val;
        mx[hf] = fmaxf(mx[hf], val);
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float val = expf(s[j][2 * hf + e] - mx[hf]);
        s[j][2 * hf + e] = val;
        sum[hf] += val;
      }
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
    sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
    inv[hf] = 1.f / sum[hf];
  }
}

// The bf16 probabilities of keys 16kc..16kc+15 as the m16n8k16 A fragment of
// P.v.
__device__ __forceinline__ void p_fragment(uint32_t (&a)[4], const float (&s)[8][4],
                                           const float (&inv)[2], int kc) {
  a[0] = pack_bf16(s[2 * kc][0] * inv[0], s[2 * kc][1] * inv[0]);
  a[1] = pack_bf16(s[2 * kc][2] * inv[1], s[2 * kc][3] * inv[1]);
  a[2] = pack_bf16(s[2 * kc + 1][0] * inv[0], s[2 * kc + 1][1] * inv[0]);
  a[3] = pack_bf16(s[2 * kc + 1][2] * inv[1], s[2 * kc + 1][3] * inv[1]);
}

// The attention of NT (head, 16 query rows) tasks of one warp, run together
// so that one's latencies overlap the other's work: q and k in qk (a [64 x
// 2GW] operand, k from column GW), v in v ([64/8][GW][8]), task n's head's
// dims from column hofs[n], its 16 query rows mt*16.., bias(n, hf, j) its
// rel_bias (row_softmax's); the bf16 output into o (a [64 x n] operand) at
// columns ocol[n]..ocol[n]+HD-1. A warp reads its q rows before it writes
// o, and no other warp reads them, so o may overwrite them (o = qk, ocol =
// hofs). head_dim 24: the second k step's upper 8 dims lie past the head and
// are zeroed. Each task's arithmetic, and so its bits, does not depend on
// NT. MASKED: as row_softmax's.
template <int HD, int GW, int NT, bool MASKED, class Bias>
__device__ __forceinline__ void head_attention_tasks(const bf16* qk, const bf16* v,
                                                     const int (&hofs)[NT], Bias bias, bf16* o,
                                                     const int (&ocol)[NT], int mt,
                                                     bool last_row, bool last_col) {
  constexpr int KSTEPS = (HD + 15) / 16;
  constexpr bool HALF = HD % 16 == 8;  // the last k step's upper 8 dims lie past the head
  constexpr int DT = HD / 8;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  float s[NT][8][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[n][j][q] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const bool half = HALF && ks == KSTEPS - 1;  // k 8..15 of the step: zero products
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c0 = hofs[n] + ks * 16;
      const bf16* pa = qk + al(mt * 16 + g, c0) + 2 * t4;
      uint32_t a[4];
      a[0] = ld_u32(pa);
      a[1] = ld_u32(pa + 64);
      a[2] = half ? 0u : ld_u32(pa + kLA);
      a[3] = half ? 0u : ld_u32(pa + kLA + 64);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* pb = qk + al(j * 8 + g, GW + c0) + 2 * t4;
        const uint32_t b[2] = {ld_u32(pb), half ? 0u : ld_u32(pb + kLA)};
        mma_bf16(s[n][j], a, b);
      }
    }
  }
  float inv[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    row_softmax<MASKED>(s[n], [&](int hf, int j) { return bias(n, hf, j); }, mt, last_row,
                        last_col, inv[n]);
  float o_acc[NT][DT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int q = 0; q < 4; ++q) o_acc[n][d][q] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t a[4];
      p_fragment(a, s[n], inv[n], kc);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const bf16* pb = v + (2 * kc * GW + hofs[n] + d * 8 + g) * 8 + 2 * t4;
        const uint32_t b[2] = {ld_u32(pb), ld_u32(pb + GW * 8)};
        mma_bf16(o_acc[n][d], a, b);
      }
    }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int c = ocol[n] + d * 8 + 2 * t4;
      const int p = mt * 16 + g;
      *reinterpret_cast<uint32_t*>(o + al(p, c)) = pack_bf16(o_acc[n][d][0], o_acc[n][d][1]);
      *reinterpret_cast<uint32_t*>(o + al(p + 8, c)) = pack_bf16(o_acc[n][d][2], o_acc[n][d][3]);
    }
}

// One task of head_attention_tasks with its bias loaded ahead (head_bias).
template <int HD, int GW>
__device__ __forceinline__ void head_attention_wg(const bf16* qk, const bf16* v, int hofs,
                                                  const float2 (&bias)[2][8], bf16* o, int ocol,
                                                  int mt, bool last_row, bool last_col) {
  const int h[1] = {hofs}, oc[1] = {ocol};
  head_attention_tasks<HD, GW, 1, true>(
      qk, v, h, [&](int, int hf, int j) { return bias[hf][j]; }, o, oc, mt, last_row, last_col);
}

}  // namespace
