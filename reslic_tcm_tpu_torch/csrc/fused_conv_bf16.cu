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
// the products bind it at C >= 192 and the bytes below. Inside the chip the
// first version (mma.sync m16n8k16, 8 warps over a 128-pixel tile, K in
// stages of 32 behind a block barrier, A read as fp32 into registers once
// for each of the 9 taps and converted there) spent a third of its time on
// those loads of A and ran at 10-16% of the bound. This design:
// - A cast kernel writes bf16(x) once (the TPU's cast point). Each block's
//   input tile plus its one-pixel border (the halo) then lands in shared
//   memory by tensor copies (cp.async.bulk.tensor, one box of 8 channels x
//   the halo's pixels a k-group, zero outside the image), laid out
//   [C/8][pixel][8]: the 9 taps read it in place (a tap is a shift of the
//   descriptor's start by whole pixels), so each input value crosses the
//   memory bus about once per block instead of once per tap. The halo's
//   k-groups are published on one mbarrier per stage's channels, so the
//   first tap's products start after the first chunk.
// - wgmma: each of two consumer warpgroups owns MT 8x8 blocks of output
//   pixels (M = 64 a block) over NB output channels, fp32 accumulators in
//   registers. The tile is TH x TW pixels x NB channels (ConvTile: 16x16 or
//   8x16 pixels, NB up to 192), so one staged W tile feeds 2 * MT products.
// - W (bf16, prepared once by the wrapper as [9C/8][C][8]: each k-group of
//   8 input channels of a tap holds every output channel's 8 values) streams
//   by the copy engine (cp.async.bulk, one per k-group) through a ring of
//   STAGES stages of KC k each (64, or 32 at C=96), full and empty
//   mbarriers. One producer warp (one thread) issues every copy: no block
//   barrier in the loop.
// - B2's conv1 writes mid in bf16 (the TPU rounds it there); conv2 reads it
//   by the same tensor copies. B3's conv writes y in fp32 (its epilogue needs
//   it) and bf16(y*y); the 1x1 GDN launch (K = C) reads the latter as its A
//   through a halo of no border.
//
// The sum order is fixed: each output's accumulator starts at 0 and takes
// one k16 step at a time, k ascending (taps in (a, b) row-major order, then
// input channels ascending), whatever the tile; the bias is added after.
// The bits therefore do not depend on the tile, so the encoder's and the
// decoder's scales are equal whichever tile each picked. On an H100 they are
// also the first version's bits (its m16n8k16 steps sum the same products in
// the same order): equal digests at every main-path shape
// (tools/bf16_redesign/compare.py).
//
// Interface: plain C, raw pointers, the launch stream; returns
// cudaGetLastError() of the launches (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper_wgmma.cuh"

namespace {

constexpr float kSlope = 0.01f;
constexpr int kConsumers = 2;                    // consumer warpgroups: warps 0-7
constexpr int kConvThreads = 128 * kConsumers + 32;  // + the producer warp (warp 8)
constexpr int kSmemLimit = 232448 - 1024;        // a block's dynamic shared memory, with a margin
constexpr int kSmemPerSM = 233472;               // 228 KB an SM
constexpr int kSmemReserved = 1024;              // the runtime's share of each block

enum Epilogue {
  kBiasLeaky = 0,     // bf16(leaky(acc + bias))            B2 conv1 (out = mid, bf16)
  kBiasLeakyRes = 1,  // leaky(acc + bias) + ep0            B2 conv2 (ep0 = x)
  kBias = 2,          // y = acc + bias, and bf16(y * y)    B3 conv (out = y, out2 = bf16(y^2))
  kGdn = 3,           // ep0 * f(acc + bias) + ep1          B3 GDN (A = bf16(y^2), ep0 = y, ep1 = skip)
};

// The tiles (ops/fused_conv.py::tile_shape_bf16): TH x TW output pixels x
// NB output channels. Large: 16x16 pixels over 64 channels at C = 64 and
// over 96 at C = 96 and 192; 8x16 over 128 at C = 128 and 256 and over 192
// at C = 384 (each the faster on the main path's maps, PERF.md); small:
// 8x16 pixels over half the large tile's channels.
template <int C, int TILE>
struct ConvTile {
  static constexpr int NBL = C == 384 ? 192 : C % 96 == 0 ? 96 : C == 64 ? 64 : 128;
  static constexpr int TH = TILE == 0 && (C == 64 || C % 96 == 0) && C != 384 ? 16 : 8;
  static constexpr int TW = 16;
  static constexpr int NB = TILE == 0 ? NBL : NBL / 2;
};

// Geometry of one block: the halo [C/8][NPIX8][8] (its pixels row-major,
// each k-group's slab 128-byte aligned for the tensor copies) and the W ring.
template <int C, int TAPS, int TH, int TW, int NB>
struct ConvGeom {
  static constexpr int PAD = TAPS == 9 ? 1 : 0;
  static constexpr int HH = TH + 2 * PAD, HW = TW + 2 * PAD;  // halo rows, columns
  static constexpr int NPIX = HH * HW;
  static constexpr int NPIX8 = (NPIX + 7) / 8 * 8;
  static constexpr int KC = C % 64 == 0 ? 64 : 32;            // k per stage
  static constexpr int KCH = C / KC;                          // stages per tap
  static constexpr int NQ = TAPS * KCH;                       // stages
  static constexpr int MB = (TH / 8) * (TW / 8);              // 8x8 blocks
  static constexpr int MT = MB / kConsumers;                  // per consumer warpgroup
  static constexpr int STAGE_BYTES = KC * NB * 2;
  static constexpr int HALO_BYTES = C / 8 * NPIX8 * 16;
  // two blocks an SM where the halo and two stages fit half its shared
  // memory and the accumulators 64 registers (of 112 a thread)
  static constexpr bool TWO =
      HALO_BYTES + 2 * STAGE_BYTES <= kSmemPerSM / 2 - kSmemReserved && MT * NB / 2 <= 64;
  static constexpr int MIN_BLOCKS = TWO ? 2 : 1;
  static constexpr int FREE = (TWO ? kSmemPerSM / 2 - kSmemReserved : kSmemLimit) - HALO_BYTES;
  static constexpr int STAGES = FREE / STAGE_BYTES >= 6 ? 6 : FREE / STAGE_BYTES;
  static constexpr int BYTES = HALO_BYTES + STAGES * STAGE_BYTES;
  static_assert(C % KC == 0 && KC % 16 == 0 && C % NB == 0 && NB % 8 == 0 && NB <= 192, "k and n");
  static_assert(TH % 8 == 0 && TW % 8 == 0 && MB % kConsumers == 0, "8x8 blocks");
  static_assert(STAGES >= 2, "a W stage in flight while one is multiplied");
  static_assert(HH <= 256 && HW <= 256 && NPIX8 < 16384, "tensor box and descriptor fields");
};

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : kSlope * v; }

// xb = bf16(x), eight values a thread (n8 groups of 8).
__global__ void cast_bf16_kernel(const float* __restrict__ x, bf16* __restrict__ xb, size_t n8) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n8;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(x) + 2 * i);
    const float4 v = __ldg(reinterpret_cast<const float4*>(x) + 2 * i + 1);
    reinterpret_cast<uint4*>(xb)[i] = make_uint4(pack_bf16(u.x, u.y), pack_bf16(u.z, u.w),
                                                 pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// out = epilogue(conv(a, W)) over one TH x TW x NB tile. A is the bf16
// input behind `amap` (a tensor map of [B][H][W][C], boxes of 8 channels x
// HW x HH pixels): its pixels shifted by each tap, zero outside the image,
// or the tile's pixels themselves for the 1-tap GDN launch. Grid:
// (tiles_x * tiles_y * B, C / NB).
template <int C, int EPI, int TH, int TW, int NB, class TO>
__global__ void __launch_bounds__(kConvThreads,
                                  (ConvGeom<C, EPI == kGdn ? 1 : 9, TH, TW, NB>::MIN_BLOCKS))
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap amap, const bf16* __restrict__ wt,
                      const float* __restrict__ bias, const float* __restrict__ ep0,
                      const float* __restrict__ ep1, TO* __restrict__ out,
                      bf16* __restrict__ out2, int H, int W, int tiles_x, int tiles_y,
                      int inverse) {
  constexpr int TAPS = EPI == kGdn ? 1 : 9;
  using G = ConvGeom<C, TAPS, TH, TW, NB>;
  constexpr int S = G::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[S], empty[S], halo_ready[G::KCH];
  bf16* halo = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + G::HALO_BYTES;

  const int tid = threadIdx.x;
  int bid = blockIdx.x;
  const int tx = bid % tiles_x;
  bid /= tiles_x;
  const int ty = bid % tiles_y;
  const int img = bid / tiles_y;
  const int y0 = ty * TH, x0 = tx * TW;
  const int n0 = blockIdx.y * NB;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    for (int j = 0; j < G::KCH; ++j) mbar_init(&halo_ready[j], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * kConsumers) {  // the producer warp: one thread issues every copy
    if (tid == 128 * kConsumers) {
      for (int q = 0; q < G::NQ; ++q) {
        if (q < G::KCH) {  // the halo's k-groups of stage q's channels (tap 0's chunk q)
          mbar_expect_tx(&halo_ready[q], G::KC / 8 * G::NPIX * 16);
#pragma unroll
          for (int i = 0; i < G::KC / 8; ++i) {
            const int kg = q * G::KC / 8 + i;
            tma_load_4d(halo + static_cast<size_t>(kg) * G::NPIX8 * 8, &amap, kg * 8, x0 - G::PAD,
                        y0 - G::PAD, img, &halo_ready[q]);
          }
        }
        // W: stage q = (tap, chunk j) is rows n0..n0+NB-1 of the KC/8 k-groups
        // from (tap * C + j * KC) / 8 on
        const int s = q % S;
        if (q >= S) mbar_wait(&empty[s], (q / S - 1) & 1);
        mbar_expect_tx(&full[s], G::STAGE_BYTES);
        const int kg0 = (q / G::KCH * C + q % G::KCH * G::KC) / 8;
        const bf16* src = wt + (static_cast<size_t>(kg0) * C + n0) * 8;
#pragma unroll
        for (int i = 0; i < G::KC / 8; ++i)
          bulk_copy(ring + s * G::STAGE_BYTES + i * NB * 16, src + static_cast<size_t>(i) * C * 8,
                    NB * 16, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup cw: the 8x8 blocks cw * MT .. cw * MT + MT - 1
  const int cw = tid / 128;
  const int lt = tid % 128;
  float acc[G::MT][NB / 2];
#pragma unroll
  for (int m = 0; m < G::MT; ++m)
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) acc[m][i] = 0.f;
#pragma unroll
  for (int m = 0; m < G::MT; ++m) wg_hold(acc[m]);

  for (int q = 0; q < G::NQ; ++q) {
    const int s = q % S;
    const int tap = q / G::KCH, j = q % G::KCH;
    mbar_wait(&full[s], (q / S) & 1);
    if (tap == 0) mbar_wait(&halo_ready[j], 0);
    const int dy = TAPS == 9 ? tap / 3 : 0, dx = TAPS == 9 ? tap % 3 : 0;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < G::KC / 16; ++kk) {
      const uint64_t db = wg_desc(ring + s * G::STAGE_BYTES + kk * 2 * NB * 16, NB * 16, 128);
      const int kg = j * (G::KC / 8) + 2 * kk;
#pragma unroll
      for (int m = 0; m < G::MT; ++m) {
        const int b = cw * G::MT + m;
        const int by = b / (TW / 8), bx = b % (TW / 8);
        const bf16* pa =
            halo + (static_cast<size_t>(kg) * G::NPIX8 + (by * 8 + dy) * G::HW + bx * 8 + dx) * 8;
        wgmma_bf16<NB>(acc[m], wg_desc(pa, G::NPIX8 * 16, G::HW * 16), db);
      }
    }
    wg_commit();
    wg_wait<1>();  // stage q - 1's products are done: its slot may refill
    if (q > 0 && lt == 0) mbar_arrive(&empty[(q - 1) % S]);
  }
  wg_wait<0>();
#pragma unroll
  for (int m = 0; m < G::MT; ++m) wg_hold(acc[m]);

  // epilogue: thread lt holds rows r, r + 8 of each block, columns 8i + c, +1
  const int r = 16 * (lt / 32) + (lt % 32) / 4;
  const int c = 2 * (lt % 4);
#pragma unroll
  for (int m = 0; m < G::MT; ++m) {
    const int b = cw * G::MT + m;
    const int by = b / (TW / 8), bx = b % (TW / 8);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r + 8 * half;
      const int yy = y0 + by * 8 + row / 8, xx = x0 + bx * 8 + row % 8;
      if (yy >= H || xx >= W) continue;
      const size_t pix = static_cast<size_t>(img * H + yy) * W + xx;
#pragma unroll
      for (int i = 0; i < NB / 8; ++i) {
        const int n = n0 + 8 * i + c;
        const size_t o = pix * C + n;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + n));
        float v0 = acc[m][4 * i + 2 * half] + bb.x;
        float v1 = acc[m][4 * i + 2 * half + 1] + bb.y;
        if constexpr (EPI == kBiasLeaky) {
          *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(leaky(v0), leaky(v1));
        } else {
          if constexpr (EPI == kBiasLeakyRes) {
            const float2 rr = __ldg(reinterpret_cast<const float2*>(ep0 + o));
            v0 = leaky(v0) + rr.x;
            v1 = leaky(v1) + rr.y;
          } else if constexpr (EPI == kBias) {
            *reinterpret_cast<uint32_t*>(out2 + o) = pack_bf16(v0 * v0, v1 * v1);
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

// cuTensorMapEncodeTiled, reached through the runtime (nothing more to link).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a bf16 [B][H][W][C] map read in boxes of 8 channels x
// bw x bh pixels; out-of-range elements read as zero.
cudaError_t act_map(CUtensorMap* m, const bf16* a, int B, int H, int W, int C, int bh, int bw) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {8, static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(bh), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(a), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t cast_bf16(const float* x, bf16* xb, size_t n, cudaStream_t s) {
  const size_t n8 = n / 8;
  const size_t blocks = (n8 + 255) / 256;
  cast_bf16_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(x, xb, n8);
  return cudaGetLastError();
}

template <int C, int EPI, int TILE, class TO>
cudaError_t launch_conv(const bf16* a, const bf16* wt, const float* bias, const float* ep0,
                        const float* ep1, TO* out, bf16* out2, int B, int H, int W, int inverse,
                        cudaStream_t stream) {
  using T = ConvTile<C, TILE>;
  using G = ConvGeom<C, EPI == kGdn ? 1 : 9, T::TH, T::TW, T::NB>;
  CUtensorMap amap;
  cudaError_t e = act_map(&amap, a, B, H, W, C, G::HH, G::HW);
  if (e != cudaSuccess) return e;
  auto kern = conv_wgmma_kernel<C, EPI, T::TH, T::TW, T::NB, TO>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (e != cudaSuccess) return e;
  const int tiles_x = (W + T::TW - 1) / T::TW, tiles_y = (H + T::TH - 1) / T::TH;
  const dim3 grid(tiles_x * tiles_y * B, C / T::NB);
  kern<<<grid, kConvThreads, G::BYTES, stream>>>(amap, wt, bias, ep0, ep1, out, out2, H, W,
                                                 tiles_x, tiles_y, inverse);
  return cudaGetLastError();
}

template <int C, int TILE>
cudaError_t residual_block(const float* x, const bf16* w1, const float* b1, const bf16* w2,
                           const float* b2, bf16* xb, bf16* mid, float* out, int B, int H, int W,
                           cudaStream_t s) {
  cudaError_t e = cast_bf16(x, xb, static_cast<size_t>(B) * H * W * C, s);
  if (e != cudaSuccess) return e;
  e = launch_conv<C, kBiasLeaky, TILE, bf16>(xb, w1, b1, nullptr, nullptr, mid, nullptr, B, H, W,
                                             0, s);
  if (e != cudaSuccess) return e;
  return launch_conv<C, kBiasLeakyRes, TILE, float>(mid, w2, b2, x, nullptr, out, nullptr, B, H,
                                                    W, 0, s);
}

template <int C, int TILE>
cudaError_t conv_gdn(const float* x, const bf16* w, const float* b, const bf16* gamma,
                     const float* beta, const float* skip, bf16* xb, float* y, bf16* y2,
                     float* out, int B, int H, int W, int inverse, cudaStream_t s) {
  cudaError_t e = cast_bf16(x, xb, static_cast<size_t>(B) * H * W * C, s);
  if (e != cudaSuccess) return e;
  e = launch_conv<C, kBias, TILE, float>(xb, w, b, nullptr, nullptr, y, y2, B, H, W, 0, s);
  if (e != cudaSuccess) return e;
  return launch_conv<C, kGdn, TILE, float>(y2, gamma, beta, y, skip, out, nullptr, B, H, W,
                                           inverse, s);
}

template <int C>
int residual_block_tiled(const float* x, const bf16* w1, const float* b1, const bf16* w2,
                         const float* b2, bf16* xb, bf16* mid, float* out, int B, int H, int W,
                         int tile, cudaStream_t s) {
  if (tile == 0) return residual_block<C, 0>(x, w1, b1, w2, b2, xb, mid, out, B, H, W, s);
  if (tile == 1) return residual_block<C, 1>(x, w1, b1, w2, b2, xb, mid, out, B, H, W, s);
  return cudaErrorInvalidValue;
}

template <int C>
int conv_gdn_tiled(const float* x, const bf16* w, const float* b, const bf16* gamma,
                   const float* beta, const float* skip, bf16* xb, float* y, bf16* y2, float* out,
                   int B, int H, int W, int inverse, int tile, cudaStream_t s) {
  if (tile == 0)
    return conv_gdn<C, 0>(x, w, b, gamma, beta, skip, xb, y, y2, out, B, H, W, inverse, s);
  if (tile == 1)
    return conv_gdn<C, 1>(x, w, b, gamma, beta, skip, xb, y, y2, out, B, H, W, inverse, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, out: [B][H][W][C] float32; xb, mid: [B][H][W][C] bf16 scratch (bf16(x),
// conv1's output); w1, w2: [9C/8][C][8] bf16 (k-group, output channel, 8
// input channels; k = tap * C + input channel); b1, b2: [C] float32. C is
// 64, 96, 128 or 192; tile 0 = large, 1 = small (same bits). All 16-byte
// aligned.
int fused_residual_block_bf16(const float* x, const bf16* w1, const float* b1, const bf16* w2,
                              const float* b2, bf16* xb, bf16* mid, float* out, int B, int H,
                              int W, int C, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
#define B2_CASE(c) \
  if (C == c) return residual_block_tiled<c>(x, w1, b1, w2, b2, xb, mid, out, B, H, W, tile, s);
  B2_CASE(64) B2_CASE(96) B2_CASE(128) B2_CASE(192)
#undef B2_CASE
  return cudaErrorInvalidValue;
}

// x, skip, y, out: [B][H][W][C] float32 (y scratch); xb, y2: [B][H][W][C]
// bf16 scratch (bf16(x), bf16(y*y)); w: [9C/8][C][8] bf16; gamma: [C/8][C][8]
// bf16, derived, gamma[k][j] (output k, input j) at [j / 8][k][j % 8]; b,
// beta: [C] float32. C is 64, 128, 192, 256 or 384; tile 0 = large, 1 =
// small (same bits). All 16-byte aligned.
int fused_conv_gdn_bf16(const float* x, const bf16* w, const float* b, const bf16* gamma,
                        const float* beta, const float* skip, bf16* xb, float* y, bf16* y2,
                        float* out, int B, int H, int W, int C, int inverse, int tile,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
#define B3_CASE(c)                                                                          \
  if (C == c)                                                                               \
    return conv_gdn_tiled<c>(x, w, b, gamma, beta, skip, xb, y, y2, out, B, H, W, inverse, \
                             tile, s);
  B3_CASE(64) B3_CASE(128) B3_CASE(192) B3_CASE(256) B3_CASE(384)
#undef B3_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
