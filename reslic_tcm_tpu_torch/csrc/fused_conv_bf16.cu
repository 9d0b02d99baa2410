// Implicit-GEMM 3x3 / 1x1 convolution for Hopper (sm_90a) on the bf16 tensor
// cores, fp32 sums, and the two fused TCM blocks built from it: the bf16
// instances of csrc/fused_conv.cu.
//
// Replaces the Pallas TPU kernels of reslic_tcm_tpu/ops/fused_conv.py in
// their bf16 mode (compute_dtype=jnp.bfloat16, the TPU's default):
//
//   B2  fused_residual_block (:137, _rb_kernel):
//         mid = bf16(leaky(conv3x3(bf16(x), bf16(w1)) + b1))
//         out = leaky(conv3x3(mid, bf16(w2)) + b2) + x
//   B3  fused_conv_gdn (:237, _cgdn_kernel):
//         y = conv3x3(bf16(x), bf16(w)) + b
//         out = y * rsqrt(bf16(y*y) . bf16(gamma)^T + beta) + skip (IGDN: sqrt)
//
// bf16(.) is a round to nearest even; every sum is fp32, and the bias, the
// activations, beta, the square root and the skip stay fp32 (the Pallas
// bodies' casts, fused_conv.py:64-98 and :216-234). torch padding 1, slope
// 0.01, NHWC activations.
//
// What bounds it on this card: 2*9*C FLOP for each 8 bytes of fp32
// activation read and written (C = 64..384: 144-864 FLOP/byte); the bf16
// tensor cores (989 TFLOP/s) meet the 3.35 TB/s memory at 295 FLOP/byte, so
// the products bind it at C >= 192 and the bytes below. The fp32 instance
// runs on the CUDA cores (67 TFLOP/s), where operations bind at every width.
//
// Design (one kernel, conv_mma_kernel, templated on C, the epilogue, the
// input's type and the tile), a first version: mma.sync, no TMA ring.
// - A block computes a BM x BN tile of [M, N] (M = B*H*W pixels, N = C
//   output channels) with 8 warps (large tile, 128 x BN) or 4 (small tile,
//   32 x 32); a warp owns a (BM / WARPS_M) x (BN / WARPS_N) piece as
//   m16n8k16 tiles, fp32 accumulators in registers.
// - K = taps * C runs in stages of kBK = 32 (32 input channels of one tap),
//   double-buffered in shared memory as bf16: A (im2col, implicit: the
//   tap-shifted pixels, zero outside the image) is loaded into registers for
//   stage s+1 while stage s is multiplied, then converted to bf16 (fp32
//   inputs; B3's GDN launch squares y first) and stored; W (bf16, prepared
//   once by the wrapper as [Cout][taps][Cin]) lands by cp.async.
// - B2's conv1 writes mid in bf16 (the TPU rounds it there); conv2 reads it
//   as bf16 without a cast pass. B3's y stays fp32: its epilogue needs it.
//
// The sum order is fixed: each output's accumulator starts at 0 and takes
// one m16n8k16 step per 16 k, k ascending (taps in (a, b) row-major order,
// then input channels ascending), whatever the tile; the bias is added
// after. The bits therefore do not depend on the tile, so the encoder's and
// the decoder's scales are equal whichever tile each picked.
//
// Interface: plain C, raw pointers, the launch stream; returns
// cudaGetLastError() of the launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kBK = 32;        // K per stage: 32 channels of one tap
constexpr int kLD = kBK + 8;   // shared row stride (bf16): conflict-free fragment loads
constexpr float kSlope = 0.01f;

enum Epilogue {
  kBiasLeaky = 0,     // bf16(leaky(acc + bias))            B2 conv1 (out = mid, bf16)
  kBiasLeakyRes = 1,  // leaky(acc + bias) + ep0            B2 conv2 (ep0 = x)
  kBias = 2,          // acc + bias                         B3 conv
  kGdn = 3,           // ep0 * f(acc + bias) + ep1, A = y^2 B3 GDN (ep0 = y, ep1 = skip)
};

// A BM x BN block tile over WARPS_M x WARPS_N warps.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MI = BM / WARPS_M / 16;  // m16 tiles per warp
  static constexpr int NI = BN / WARPS_N / 8;   // n8 tiles per warp
  static_assert(MI >= 1 && NI >= 1 && BM % (16 * WARPS_M) == 0 && BN % (8 * WARPS_N) == 0,
                "warp tiles");
};
// The fp32 instance's tiles (ops/fused_conv.py::tile_shape): 128 pixels x the
// widest of 128, 64, 32 channels that divides C, or 32 x 32.
template <int C>
using LargeTile = Tile<128, C % 128 == 0 ? 128 : (C % 64 == 0 ? 64 : 32), 4, 2>;
using SmallTile = Tile<32, 32, 2, 2>;

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : kSlope * v; }

// Four channels of A as four bf16 values (8 bytes).
__device__ __forceinline__ uint2 to_bf16x4(float4 v, bool square) {
  if (square) {
    v.x = v.x * v.x;
    v.y = v.y * v.y;
    v.z = v.z * v.z;
    v.w = v.w * v.w;
  }
  return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

template <class TA>
struct AChunk;  // four channels of the input, as loaded
template <>
struct AChunk<float> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ uint2 bf16x4(T v, bool square) { return to_bf16x4(v, square); }
};
template <>
struct AChunk<bf16> {
  using T = uint2;
  static __device__ __forceinline__ T load(const bf16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ T zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ uint2 bf16x4(T v, bool) { return v; }
};

// out[m][n] = epilogue(sum over k of A[m][k] * W[n][k]) for M pixels and C
// channels; A[m][tap*C + ci] is a's pixel m shifted by the tap (zero outside
// the image), or a[m][ci] itself (squared) for the 1-tap GDN epilogue.
template <int C, int EPI, class T, class TA, class TO>
__global__ void __launch_bounds__(T::THREADS)
    conv_mma_kernel(const TA* __restrict__ a, const bf16* __restrict__ wt,
                    const float* __restrict__ bias, const float* __restrict__ ep0,
                    const float* __restrict__ ep1, TO* __restrict__ out, int M, int H, int W,
                    int inverse) {
  constexpr int TAPS = EPI == kGdn ? 1 : 9;
  constexpr int KW = TAPS * C;                 // W's row length
  constexpr int BM = T::BM, BN = T::BN, THREADS = T::THREADS;
  constexpr int MI = T::MI, NI = T::NI;
  constexpr int A_CH = BM * kBK / 4;           // 4-channel chunks of A per stage
  constexpr int A_ITERS = A_CH / THREADS;
  constexpr int B_CH = BN * kBK / 8;           // 16-byte chunks of W per stage
  constexpr int B_ITERS = (B_CH + THREADS - 1) / THREADS;
  constexpr int KCH = C / kBK;                 // stages per tap
  constexpr int NIT = TAPS * KCH;
  static_assert(C % kBK == 0 && C % BN == 0 && A_CH % THREADS == 0, "tile");
  using AC = AChunk<TA>;

  __shared__ __align__(16) bf16 As[2][BM][kLD];
  __shared__ __align__(16) bf16 Bs[2][BN][kLD];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Copy duty: chunk q = tid + i * THREADS is pixel q / 8, channels
  // (q % 8) * 4 .. + 3 of the stage; a bit per tap that lands inside the
  // image (none past the last pixel).
  unsigned amask[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int gm = m0 + (tid + i * THREADS) / 8;
    amask[i] = 0u;
    if (gm < M) {
      if (TAPS == 1) {
        amask[i] = 1u;
      } else {
        const int x = gm % W;
        const int y = (gm / W) % H;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) amask[i] |= 1u << t;
        }
      }
    }
  }

  typename AC::T areg[A_ITERS];
  auto fetch_a = [&](int it) {
    const int tap = it / KCH;
    const int c0 = (it % KCH) * kBK;
    const int off = TAPS == 1 ? c0 : ((tap / 3 - 1) * W + (tap % 3 - 1)) * C + c0;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int q = tid + i * THREADS;
      areg[i] = ((amask[i] >> tap) & 1u)
                    ? AC::load(a + static_cast<size_t>(m0 + q / 8) * C + off + (q % 8) * 4)
                    : AC::zero();
    }
  };
  auto put_a = [&](int slot) {
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int q = tid + i * THREADS;
      *reinterpret_cast<uint2*>(&As[slot][q / 8][(q % 8) * 4]) =
          AC::bf16x4(areg[i], EPI == kGdn);
    }
  };
  auto fetch_b = [&](int slot, int it) {
    const int k0 = (it / KCH) * C + (it % KCH) * kBK;
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int q = tid + i * THREADS;
      if (B_CH % THREADS == 0 || q < B_CH) {
        const int n = q / (kBK / 8), kc = (q % (kBK / 8)) * 8;
        cp_async16_bf16(&Bs[slot][n][kc], wt + static_cast<size_t>(n0 + n) * KW + k0 + kc);
      }
    }
    cp_async_commit_group();
  };

  const int warp = tid / 32;
  const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
  const int rbase = wm * MI * 16, cbase = wn * NI * 8;
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  fetch_a(0);
  fetch_b(0, 0);
  put_a(0);
  cp_async_wait_group<0>();
  __syncthreads();
  for (int it = 0; it < NIT; ++it) {
    const int slot = it & 1;
    const bool more = it + 1 < NIT;
    if (more) {  // the next stage's loads fly while this one is multiplied
      fetch_a(it + 1);
      fetch_b(slot ^ 1, it + 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) frag_a(af[i], &As[slot][0][0], kLD, rbase + i * 16, kk);
#pragma unroll
      for (int j = 0; j < NI; ++j) frag_b(bfr[j], &Bs[slot][0][0], kLD, cbase + j * 8, kk);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    if (more) {
      put_a(slot ^ 1);  // slot ^ 1 was last read before the previous barrier
      cp_async_wait_group<0>();
    }
    __syncthreads();
  }

  const int lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gm = m0 + rbase + i * 16 + g + half * 8;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + cbase + j * 8 + 2 * t4;
        const size_t o = static_cast<size_t>(gm) * C + n;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + n));
        float v0 = acc[i][j][2 * half] + bb.x;
        float v1 = acc[i][j][2 * half + 1] + bb.y;
        if constexpr (EPI == kBiasLeaky) {
          *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(leaky(v0), leaky(v1));
        } else {
          if constexpr (EPI == kBiasLeakyRes) {
            const float2 r = __ldg(reinterpret_cast<const float2*>(ep0 + o));
            v0 = leaky(v0) + r.x;
            v1 = leaky(v1) + r.y;
          } else if constexpr (EPI == kGdn) {
            const float2 y = __ldg(reinterpret_cast<const float2*>(ep0 + o));
            const float2 sk = __ldg(reinterpret_cast<const float2*>(ep1 + o));
            v0 = y.x * (inverse ? sqrtf(v0) : rsqrtf(v0)) + sk.x;
            v1 = y.y * (inverse ? sqrtf(v1) : rsqrtf(v1)) + sk.y;
          }
          *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
        }
      }
    }
  }
}

template <int C, int EPI, class T, class TA, class TO>
cudaError_t launch_gemm(const TA* a, const bf16* wt, const float* bias, const float* ep0,
                        const float* ep1, TO* out, int M, int H, int W, int inverse,
                        cudaStream_t stream) {
  const dim3 grid((M + T::BM - 1) / T::BM, C / T::BN);
  conv_mma_kernel<C, EPI, T, TA, TO><<<grid, T::THREADS, 0, stream>>>(a, wt, bias, ep0, ep1,
                                                                      out, M, H, W, inverse);
  return cudaGetLastError();
}

template <int C, class T>
cudaError_t residual_block(const float* x, const bf16* w1, const float* b1, const bf16* w2,
                           const float* b2, bf16* mid, float* out, int M, int H, int W,
                           cudaStream_t s) {
  const cudaError_t e = launch_gemm<C, kBiasLeaky, T, float, bf16>(x, w1, b1, nullptr, nullptr,
                                                                  mid, M, H, W, 0, s);
  if (e != cudaSuccess) return e;
  return launch_gemm<C, kBiasLeakyRes, T, bf16, float>(mid, w2, b2, x, nullptr, out, M, H, W,
                                                       0, s);
}

template <int C, class T>
cudaError_t conv_gdn(const float* x, const bf16* w, const float* b, const bf16* gamma,
                     const float* beta, const float* skip, float* y, float* out, int M, int H,
                     int W, int inverse, cudaStream_t s) {
  const cudaError_t e =
      launch_gemm<C, kBias, T, float, float>(x, w, b, nullptr, nullptr, y, M, H, W, 0, s);
  if (e != cudaSuccess) return e;
  return launch_gemm<C, kGdn, T, float, float>(y, gamma, beta, y, skip, out, M, H, W, inverse,
                                               s);
}

template <int C>
int residual_block_tiled(const float* x, const bf16* w1, const float* b1, const bf16* w2,
                         const float* b2, bf16* mid, float* out, int M, int H, int W, int tile,
                         cudaStream_t s) {
  if (tile == 0) return residual_block<C, LargeTile<C>>(x, w1, b1, w2, b2, mid, out, M, H, W, s);
  if (tile == 1) return residual_block<C, SmallTile>(x, w1, b1, w2, b2, mid, out, M, H, W, s);
  return cudaErrorInvalidValue;
}

template <int C>
int conv_gdn_tiled(const float* x, const bf16* w, const float* b, const bf16* gamma,
                   const float* beta, const float* skip, float* y, float* out, int M, int H,
                   int W, int inverse, int tile, cudaStream_t s) {
  if (tile == 0)
    return conv_gdn<C, LargeTile<C>>(x, w, b, gamma, beta, skip, y, out, M, H, W, inverse, s);
  if (tile == 1)
    return conv_gdn<C, SmallTile>(x, w, b, gamma, beta, skip, y, out, M, H, W, inverse, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, out: [B][H][W][C] float32; mid: [B][H][W][C] bf16 scratch; w1, w2:
// [C][3][3][C] bf16 ([out][tap][in]); b1, b2: [C] float32. C is 64, 96, 128
// or 192; tile 0 = large, 1 = small (same bits).
int fused_residual_block_bf16(const float* x, const bf16* w1, const float* b1, const bf16* w2,
                              const float* b2, bf16* mid, float* out, int B, int H, int W,
                              int C, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  if (C == 64) return residual_block_tiled<64>(x, w1, b1, w2, b2, mid, out, M, H, W, tile, s);
  if (C == 96) return residual_block_tiled<96>(x, w1, b1, w2, b2, mid, out, M, H, W, tile, s);
  if (C == 128) return residual_block_tiled<128>(x, w1, b1, w2, b2, mid, out, M, H, W, tile, s);
  if (C == 192) return residual_block_tiled<192>(x, w1, b1, w2, b2, mid, out, M, H, W, tile, s);
  return cudaErrorInvalidValue;
}

// x, skip, y, out: [B][H][W][C] float32 (y scratch); w: [C][3][3][C] bf16;
// gamma: [C][C] bf16, derived, gamma[k][j] weighs input channel j into
// output k; b, beta: [C] float32. C is 64, 128, 192, 256 or 384; tile 0 =
// large, 1 = small (same bits).
int fused_conv_gdn_bf16(const float* x, const bf16* w, const float* b, const bf16* gamma,
                        const float* beta, const float* skip, float* y, float* out, int B,
                        int H, int W, int C, int inverse, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  if (C == 64)
    return conv_gdn_tiled<64>(x, w, b, gamma, beta, skip, y, out, M, H, W, inverse, tile, s);
  if (C == 128)
    return conv_gdn_tiled<128>(x, w, b, gamma, beta, skip, y, out, M, H, W, inverse, tile, s);
  if (C == 192)
    return conv_gdn_tiled<192>(x, w, b, gamma, beta, skip, y, out, M, H, W, inverse, tile, s);
  if (C == 256)
    return conv_gdn_tiled<256>(x, w, b, gamma, beta, skip, y, out, M, H, W, inverse, tile, s);
  if (C == 384)
    return conv_gdn_tiled<384>(x, w, b, gamma, beta, skip, y, out, M, H, W, inverse, tile, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
