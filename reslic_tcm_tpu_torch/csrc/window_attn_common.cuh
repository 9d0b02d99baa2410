// Device code shared by the window-attention kernels (flash_window_attn.cu,
// B1, and qkv_attention.cu, B4), fp32 on the CUDA cores, for sm_90a.
//
// * product: a register-tiled [ROWS x KD] . [KD x NB] product. A thread owns
//   a tile of TM rows x 4 columns (TM from tile_rows), reads A as float4
//   along k and W as float4 along the columns, so each 4-deep step of k
//   costs TM + 4 shared-memory loads for 16*TM fused multiply-adds. W's rows
//   reach shared memory with cp.async in slices of kSlice rows through a
//   ring of STAGES buffers, STAGES - 1 slices in flight while one is
//   multiplied, one barrier per slice: the L2 latency of the copies overlaps
//   the FMAs. B1's attention-only flavour and B4 give each product the most
//   stages (up to 4) that their shared memory holds without losing a block
//   per SM (w_stages); B1's LN+MLP flavour keeps 2.
// * head_scores / softmax_rows / head_output: one head of attention over an
//   8x8 window (64 tokens), B1's numerics (scores q.k + bias (+ the SW
//   mask), a butterfly softmax per row).
//
// Sum order: every output element of product and head_output is one fmaf
// chain over k (or the key) ascending, run by one thread, whatever the
// tile, block or cluster geometry around it; no split-k partials and no
// atomics. So a kernel's bits do not depend on how it cuts its work.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kWin = 8;
constexpr int kT = kWin * kWin;  // tokens per 8x8 window
constexpr int kHalf = kWin / 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLS = kT + 4;      // score row stride: float4 rows
constexpr float kNegInf = -1e9f;
constexpr int kSlice = 16;            // W rows per staged slice
constexpr int kSmemPerSM = 233472;    // 228 KB per SM
constexpr int kSmemPerBlock = 232448; // 227 KB per block
constexpr int kSmemReserved = 1024;   // the runtime's share of each block

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Blocks of `bytes` of shared memory that one SM holds (at most 2: the
// kernels' __launch_bounds__ then cap their registers at 128).
__host__ __device__ constexpr int blocks_per_sm(int bytes) {
  return 2 * (bytes + kSmemReserved) <= kSmemPerSM ? 2 : 1;
}

// Bytes of a block of `fixed` floats plus `stages` W buffers of [kSlice][nb].
__host__ __device__ constexpr int smem_bytes(int fixed, int stages, int nb) {
  return 4 * (fixed + stages * kSlice * nb);
}

__host__ __device__ constexpr bool stages_fit(int fixed, int stages, int nb) {
  return smem_bytes(fixed, stages, nb) <= kSmemPerBlock &&
         blocks_per_sm(smem_bytes(fixed, stages, nb)) == blocks_per_sm(smem_bytes(fixed, 2, nb));
}

// The most W stages (2 to 4) that fit the block and keep its blocks per SM.
__host__ __device__ constexpr int w_stages(int fixed, int nb) {
  return stages_fit(fixed, 4, nb) ? 4 : stages_fit(fixed, 3, nb) ? 3 : 2;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Width of the column blocks of an N-wide product: the largest that divides N.
__host__ __device__ constexpr int block_cols(int n) {
  return n % 128 == 0 ? 128
         : n % 120 == 0 ? 120
         : n % 96 == 0 ? 96
         : n % 80 == 0 ? 80
         : n % 64 == 0 ? 64
         : n % 48 == 0 ? 48
         : n % 40 == 0 ? 40
         : n % 32 == 0 ? 32
         : n % 24 == 0 ? 24
         : n % 16 == 0 ? 16
                       : 8;
}

// Rows per thread tile of a ROWS x NB block: the fewest that fit the block's
// (ROWS / TM) * (NB / 4) tiles into the kThreads threads.
__host__ __device__ constexpr int tile_rows(int nb, int rows = kT) {
  return rows * (nb / 4) <= kThreads         ? 1
         : rows / 2 * (nb / 4) <= kThreads   ? 2
         : rows / 4 * (nb / 4) <= kThreads   ? 4
                                             : 8;
}

// The thread's tile of an NB-wide column block: rows t0..t0+TM-1, columns
// c0..c0+3; threads past the block's tiles only stage and wait.
template <int NB, int ROWS = kT>
struct Tile {
  static constexpr int TM = tile_rows(NB, ROWS);
  static_assert(NB % 4 == 0 && ROWS % TM == 0 && ROWS / TM * (NB / 4) <= kThreads,
                "the block's tiles fit the threads");
  int t0, c0;
  bool active;
  __device__ Tile()
      : t0(static_cast<int>(threadIdx.x) / (NB / 4) * TM),
        c0(static_cast<int>(threadIdx.x) % (NB / 4) * 4),
        active(threadIdx.x < ROWS / TM * (NB / 4)) {}
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc[i][j] += sum over k < KD of A[(t0 + i) * LDA + k] * W[k][c0 + j] for
// the thread's tile, k ascending: one fmaf chain per output. wrow(k, n) is
// the global address of W row k at the block's column n (a multiple of 4;
// four contiguous floats, 16-byte aligned). W comes through `stage`
// (STAGES x [kSlice][NB]) in slices of kSlice rows, the next STAGES - 1
// slices' cp.async in flight while one is multiplied. Every thread of the
// block calls it; it ends with a barrier, so the caller may then overwrite
// A and the stage.
template <int NB, int KD, int LDA, int ROWS = kT, int STAGES = 2, class WRow>
__device__ __forceinline__ void product(float (&acc)[tile_rows(NB, ROWS)][4], const float* A,
                                        WRow wrow, float* stage) {
  constexpr int TM = tile_rows(NB, ROWS);
  constexpr int CHUNKS = kSlice * NB / 4;
  constexpr int NS = KD / kSlice;
  static_assert(KD % kSlice == 0 && LDA % 4 == 0, "slices and float4 rows");
  static_assert(STAGES >= 2, "a slice in flight while one is multiplied");
  const Tile<NB, ROWS> tl;
  auto fetch = [&](int s) {  // slice s into its buffer; past the last one an empty group
    if (s < NS) {
      float* buf = stage + (s % STAGES) * kSlice * NB;
      for (int q = threadIdx.x; q < CHUNKS; q += kThreads) {
        const int kk = q / (NB / 4);
        const int n = q % (NB / 4) * 4;
        cp_async16(buf + kk * NB + n, wrow(s * kSlice + kk, n));
      }
    }
    cp_async_commit();  // one group per slice keeps wait_group's count meaning slice s
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  for (int s = 0; s < NS; ++s) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice s have landed
    __syncthreads();              // everyone's have, and everyone is done with slice s - 1
    fetch(s + STAGES - 1);        // into slice s - 1's buffer
    if (tl.active) {
      const float* ws = stage + (s % STAGES) * kSlice * NB + tl.c0;
      const float* a0 = A + tl.t0 * LDA + s * kSlice;
#pragma unroll
      for (int kk = 0; kk < kSlice; kk += 4) {
        float4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(a0 + i * LDA + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 w = *reinterpret_cast<const float4*>(ws + (kk + u) * NB);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float av = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
            acc[i][0] = fmaf(av, w.x, acc[i][0]);
            acc[i][1] = fmaf(av, w.y, acc[i][1]);
            acc[i][2] = fmaf(av, w.z, acc[i][2]);
            acc[i][3] = fmaf(av, w.w, acc[i][3]);
          }
        }
      }
    }
  }
  __syncthreads();
}

// ss[p][q] = q_p . k_q + rb[p][q] (+ the SW mask) for one head of an 8x8
// window: the thread owns key q (lane-varying) for the rows p = tid / 64 + 4i
// and reads q_p as float4 (ld and the head's offset are multiples of 4). Its
// 16 bias values are loaded up front, so their latencies overlap.
template <int HD>
__device__ void head_scores(const float* qh, const float* kh, int ld,
                            const float* __restrict__ rb, float* ss, bool last_row,
                            bool last_col) {
  static_assert(HD % 4 == 0, "float4 rows");
  constexpr int PS = kThreads / kT;  // row step
  constexpr int NP = kT / PS;        // rows per thread
  const int q = threadIdx.x % kT;
  const int p0 = threadIdx.x / kT;
  float kq[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) kq[d] = kh[q * ld + d];
  float rbv[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) rbv[i] = __ldg(rb + (p0 + i * PS) * kT + q);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = p0 + i * PS;
    const float* qp = qh + p * ld;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 v = *reinterpret_cast<const float4*>(qp + d);
      s = fmaf(v.x, kq[d], s);
      s = fmaf(v.y, kq[d + 1], s);
      s = fmaf(v.z, kq[d + 2], s);
      s = fmaf(v.w, kq[d + 3], s);
    }
    s += rbv[i];
    if (last_row && ((p / kWin < kHalf) != (q / kWin < kHalf))) s += kNegInf;
    if (last_col && ((p % kWin < kHalf) != (q % kWin < kHalf))) s += kNegInf;
    ss[p * kLS + q] = s;
  }
}

// Softmax over each of the 64 score rows, one warp per row: a warp's 8 rows
// go four at a time, each four read first and written last, so their
// shuffle chains overlap.
__device__ void softmax_rows(float* ss) {
  constexpr int NR = 4;  // rows in flight per warp
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r0 = threadIdx.x / 32; r0 < kT; r0 += NR * kWarps) {
    float v0[NR], v1[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      v0[i] = ss[(r0 + i * kWarps) * kLS + lane];
      v1[i] = ss[(r0 + i * kWarps) * kLS + lane + 32];
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float m = warp_max(fmaxf(v0[i], v1[i]));
      const float e0 = expf(v0[i] - m);
      const float e1 = expf(v1[i] - m);
      const float inv = 1.f / warp_sum(e0 + e1);
      v0[i] = e0 * inv;
      v1[i] = e1 * inv;
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      ss[(r0 + i * kWarps) * kLS + lane] = v0[i];
      ss[(r0 + i * kWarps) * kLS + lane + 32] = v1[i];
    }
  }
}

// oh[p][d] = sum_q P[p][q] vh[q][d] (q ascending) for one head: a thread
// owns TP rows x 4 dims and reads P and v as float4, so each 4 keys cost
// TP + 4 loads for 16 * TP fused multiply-adds.
template <int HD>
__device__ void head_output(const float* ss, const float* vh, int ldv, float* oh, int ldo) {
  constexpr int DG = HD / 4;                                 // float4 column groups
  constexpr int TP = kT * DG <= kThreads ? 1 : kT * DG <= 2 * kThreads ? 2 : 4;
  static_assert(HD % 4 == 0 && kT % TP == 0 && kT / TP * DG <= kThreads, "tiles fit");
  if (threadIdx.x >= kT / TP * DG) return;
  const int d = threadIdx.x % DG * 4;
  const int p0 = threadIdx.x / DG * TP;
  float o[TP][4] = {};
  for (int q = 0; q < kT; q += 4) {
    float4 pr[TP];
#pragma unroll
    for (int i = 0; i < TP; ++i) pr[i] = *reinterpret_cast<const float4*>(ss + (p0 + i) * kLS + q);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(vh + (q + u) * ldv + d);
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        const float pv = u == 0 ? pr[i].x : u == 1 ? pr[i].y : u == 2 ? pr[i].z : pr[i].w;
        o[i][0] = fmaf(pv, v.x, o[i][0]);
        o[i][1] = fmaf(pv, v.y, o[i][1]);
        o[i][2] = fmaf(pv, v.z, o[i][2]);
        o[i][3] = fmaf(pv, v.w, o[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TP; ++i)
    *reinterpret_cast<float4*>(oh + (p0 + i) * ldo + d) = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
}

}  // namespace
