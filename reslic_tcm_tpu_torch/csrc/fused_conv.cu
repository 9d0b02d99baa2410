// Fused residual-conv kernels for Hopper (sm_90a), fp32.
//
// Replaces the two Pallas TPU kernels of reslic_tcm_tpu/ops/fused_conv.py:
//
//   B2  fused_residual_block (_rb_kernel):
//         out = leaky(conv3x3(mid) + b2) + x,  mid = leaky(conv3x3(x) + b1)
//   B3  fused_conv_gdn (_cgdn_kernel):
//         y = conv3x3(x) + b;  out = y * rsqrt(y^2 . gamma^T + beta) + skip
//         (IGDN: y * sqrt(...)), gamma and beta already derived.
//
// Both convolutions use torch padding 1, slope 0.01, NHWC activations and
// HWIO weights ([3][3][Cin][Cout], so neighbouring threads read neighbouring
// output channels).
//
// What bounds it on this card: at TCM's shapes (C = 64..256, 9*C*C MACs
// per output pixel) a 3x3 conv does 2*9*C = 1152..4608 FLOP for each 8 bytes
// of activation it must read and write, far above the 20 FLOP/byte where the
// H100's fp32 CUDA cores (67 TFLOP/s) meet its 3.35 TB/s memory: operations
// bound it. B2's other cost, the intermediate activation, never leaves
// shared memory.
//
// Design: one block per 8x8 output tile, so the grid covers any H and W and
// the ragged last row and column of tiles are masked here (no 8-divisible
// tiles required, unlike the TPU's BlockSpecs). A block has PG * C threads,
// PG = max(1, 256 / C) pixel groups (256 threads at C = 64, 128 and 256,
// 192 at C = 96 and 192), so that every thread owns exactly one (output
// channel, pixel group) pair. The block copies its input tile with the halo
// (12x12xC for B2, 10x10xC for B3) to shared memory, zero outside the image.
// Thread t owns output channel t % C for the pixels p = t / C + r * PG,
// keeping their sums in registers; each
// weight is read once per block from L2 and applied to all of the thread's
// pixels, while every lane of a warp reads the same activation word
// (a shared-memory broadcast). B2 keeps conv1's 10x10 result in shared memory
// and sets the ring positions outside the image to zero before conv2, which
// is conv2's zero padding. B3 keeps y in shared memory for the 1x1 GDN
// contraction over channels. Every sum runs in a fixed order (taps, then
// input channels ascending) with no atomics, so results are deterministic,
// which the codec needs: encoder and decoder must compute identical scales.
// The TPU kernel's 128-lane channel padding and 8-aligned halo over-fetch
// have no counterpart here.
//
// Interface: plain C, raw pointers, the launch stream; returns
// cudaGetLastError() of the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;
constexpr float kSlope = 0.01f;

// Pixel groups of a block for C channels; the block has PG * C threads.
template <int C>
__host__ __device__ constexpr int pixel_groups() {
  return C >= 256 ? 1 : 256 / C;
}
template <int C>
__host__ __device__ constexpr int block_threads() {
  return pixel_groups<C>() * C;
}

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : kSlope * v; }

// Copy the (kTile + 2*halo)^2 x C input window whose top-left image pixel is
// (y0, x0) into smem, with zeros outside the image.
template <int C, int IN>
__device__ __forceinline__ void load_halo(const float* __restrict__ xb, float* xs, int y0,
                                          int x0, int H, int W) {
  for (int i = threadIdx.x; i < IN * IN * C; i += block_threads<C>()) {
    const int c = i % C;
    const int p = i / C;
    const int gy = y0 + p / IN;
    const int gx = x0 + p % IN;
    xs[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                ? xb[(static_cast<size_t>(gy) * W + gx) * C + c]
                : 0.f;
  }
}

// acc[r] = sum over taps (a, b) and input channels ci of
//   src[((py_r + a) * SW + px_r + b) * C + ci] * w[((a*3 + b) * C + ci) * C + co]
// for the thread's NP pixels p_r = pg + r * PG of an OW-wide output grid.
template <int C, int NP, int PG, int OW, int SW>
__device__ __forceinline__ void conv3x3_tile(const float* src, const float* __restrict__ w,
                                             int co, int pg, float (&acc)[NP]) {
  int base[NP];
#pragma unroll
  for (int r = 0; r < NP; ++r) {
    const int p = pg + r * PG;
    base[r] = ((p / OW) * SW + p % OW) * C;
    acc[r] = 0.f;
  }
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) {
      const float* wt = w + (a * 3 + b) * C * C + co;
      const int tap = (a * SW + b) * C;
      for (int ci = 0; ci < C; ++ci) {
        const float wv = __ldg(wt + ci * C);
#pragma unroll
        for (int r = 0; r < NP; ++r) acc[r] = fmaf(src[base[r] + tap + ci], wv, acc[r]);
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(block_threads<C>())
    residual_block_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                          const float* __restrict__ b1, const float* __restrict__ w2,
                          const float* __restrict__ b2, float* __restrict__ out, int H, int W,
                          int tiles_w) {
  constexpr int IN = kTile + 4;   // input tile with a 2-pixel halo
  constexpr int MID = kTile + 2;  // conv1 output: the tile plus conv2's 1-pixel ring
  constexpr int PG = pixel_groups<C>();
  static_assert((MID * MID) % PG == 0 && (kTile * kTile) % PG == 0, "pixel split");
  constexpr int NP1 = MID * MID / PG;
  constexpr int NP2 = kTile * kTile / PG;
  extern __shared__ float smem[];
  float* xs = smem;                // [IN*IN][C]
  float* ms = smem + IN * IN * C;  // [MID*MID][C]

  const int oy = (blockIdx.x / tiles_w) * kTile;
  const int ox = (blockIdx.x % tiles_w) * kTile;
  const size_t img = static_cast<size_t>(blockIdx.y) * H * W * C;
  const int co = threadIdx.x % C;
  const int pg = PG == 1 ? 0 : threadIdx.x / C;  // PG == 1: the pixel offsets are constants

  load_halo<C, IN>(x + img, xs, oy - 2, ox - 2, H, W);
  __syncthreads();

  {
    float acc[NP1];
    conv3x3_tile<C, NP1, PG, MID, IN>(xs, w1, co, pg, acc);
    const float bias = __ldg(b1 + co);
#pragma unroll
    for (int r = 0; r < NP1; ++r) {
      const int p = pg + r * PG;
      const int gy = oy - 1 + p / MID;
      const int gx = ox - 1 + p % MID;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      ms[p * C + co] = inside ? leaky(acc[r] + bias) : 0.f;
    }
  }
  __syncthreads();

  float acc[NP2];
  conv3x3_tile<C, NP2, PG, kTile, MID>(ms, w2, co, pg, acc);
  const float bias = __ldg(b2 + co);
#pragma unroll
  for (int r = 0; r < NP2; ++r) {
    const int p = pg + r * PG;
    const int py = p / kTile, px = p % kTile;
    const int gy = oy + py, gx = ox + px;
    if (gy < H && gx < W) {
      const float res = xs[((py + 2) * IN + px + 2) * C + co];
      out[img + (static_cast<size_t>(gy) * W + gx) * C + co] = leaky(acc[r] + bias) + res;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(block_threads<C>())
    conv_gdn_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, const float* __restrict__ gt,
                    const float* __restrict__ beta, const float* __restrict__ skip,
                    float* __restrict__ out, int H, int W, int tiles_w, int inverse) {
  constexpr int IN = kTile + 2;  // input tile with a 1-pixel halo
  constexpr int PG = pixel_groups<C>();
  static_assert((kTile * kTile) % PG == 0, "pixel split");
  constexpr int NP = kTile * kTile / PG;
  extern __shared__ float smem[];
  float* xs = smem;                // [IN*IN][C]
  float* ys = smem + IN * IN * C;  // [kTile*kTile][C]

  const int oy = (blockIdx.x / tiles_w) * kTile;
  const int ox = (blockIdx.x % tiles_w) * kTile;
  const size_t img = static_cast<size_t>(blockIdx.y) * H * W * C;
  const int co = threadIdx.x % C;
  const int pg = PG == 1 ? 0 : threadIdx.x / C;  // PG == 1: the pixel offsets are constants

  load_halo<C, IN>(x + img, xs, oy - 1, ox - 1, H, W);
  __syncthreads();

  float acc[NP];
  conv3x3_tile<C, NP, PG, kTile, IN>(xs, w, co, pg, acc);
  const float bias = __ldg(b + co);
#pragma unroll
  for (int r = 0; r < NP; ++r) {
    acc[r] += bias;
    ys[(pg + r * PG) * C + co] = acc[r];
  }
  __syncthreads();

  const float bk = __ldg(beta + co);
#pragma unroll
  for (int r = 0; r < NP; ++r) {
    const int p = pg + r * PG;
    const float* yp = ys + p * C;
    float norm = 0.f;
    for (int j = 0; j < C; ++j) norm = fmaf(yp[j] * yp[j], __ldg(gt + j * C + co), norm);
    norm += bk;
    const float scale = inverse ? sqrtf(norm) : rsqrtf(norm);
    const int gy = oy + p / kTile, gx = ox + p % kTile;
    if (gy < H && gx < W) {
      const size_t o = img + (static_cast<size_t>(gy) * W + gx) * C + co;
      out[o] = acc[r] * scale + skip[o];
    }
  }
}

template <int C>
cudaError_t launch_residual_block(const float* x, const float* w1, const float* b1,
                                  const float* w2, const float* b2, float* out, int B, int H,
                                  int W, cudaStream_t stream) {
  const size_t smem = sizeof(float) * C * ((kTile + 4) * (kTile + 4) + (kTile + 2) * (kTile + 2));
  cudaError_t e = cudaFuncSetAttribute(residual_block_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles_w = (W + kTile - 1) / kTile;
  const int tiles_h = (H + kTile - 1) / kTile;
  residual_block_kernel<C><<<dim3(tiles_h * tiles_w, B), block_threads<C>(), smem, stream>>>(
      x, w1, b1, w2, b2, out, H, W, tiles_w);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_conv_gdn(const float* x, const float* w, const float* b, const float* gt,
                            const float* beta, const float* skip, float* out, int B, int H,
                            int W, int inverse, cudaStream_t stream) {
  const size_t smem = sizeof(float) * C * ((kTile + 2) * (kTile + 2) + kTile * kTile);
  cudaError_t e = cudaFuncSetAttribute(conv_gdn_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles_w = (W + kTile - 1) / kTile;
  const int tiles_h = (H + kTile - 1) / kTile;
  conv_gdn_kernel<C><<<dim3(tiles_h * tiles_w, B), block_threads<C>(), smem, stream>>>(
      x, w, b, gt, beta, skip, out, H, W, tiles_w, inverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: [B][H][W][C]; w1, w2: [3][3][C][C] (HWIO); b1, b2: [C]. C is 64, 96 or 128.
int fused_residual_block_f32(const float* x, const float* w1, const float* b1, const float* w2,
                             const float* b2, float* out, int B, int H, int W, int C,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 64) return launch_residual_block<64>(x, w1, b1, w2, b2, out, B, H, W, s);
  if (C == 96) return launch_residual_block<96>(x, w1, b1, w2, b2, out, B, H, W, s);
  if (C == 128) return launch_residual_block<128>(x, w1, b1, w2, b2, out, B, H, W, s);
  return cudaErrorInvalidValue;
}

// x, skip, out: [B][H][W][C]; w: [3][3][C][C] (HWIO); b, beta: [C];
// gt: [C][C] = gamma^T (gt[j][k] weighs input channel j into output k).
// C is 64, 128, 192 or 256.
int fused_conv_gdn_f32(const float* x, const float* w, const float* b, const float* gt,
                       const float* beta, const float* skip, float* out, int B, int H, int W,
                       int C, int inverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 64) return launch_conv_gdn<64>(x, w, b, gt, beta, skip, out, B, H, W, inverse, s);
  if (C == 128) return launch_conv_gdn<128>(x, w, b, gt, beta, skip, out, B, H, W, inverse, s);
  if (C == 192) return launch_conv_gdn<192>(x, w, b, gt, beta, skip, out, B, H, W, inverse, s);
  if (C == 256) return launch_conv_gdn<256>(x, w, b, gt, beta, skip, out, B, H, W, inverse, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
