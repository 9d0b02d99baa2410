// Implicit-GEMM 3x3 / 1x1 convolution for Hopper (sm_90a), fp32 on the CUDA
// cores, and the two fused TCM blocks built from it.
//
// Replaces the two Pallas TPU kernels of reslic_tcm_tpu/ops/fused_conv.py:
//
//   B2  fused_residual_block (:137, _rb_kernel):
//         out = leaky(conv3x3(mid) + b2) + x,  mid = leaky(conv3x3(x) + b1)
//   B3  fused_conv_gdn (:237, _cgdn_kernel):
//         y = conv3x3(x) + b;  out = y * rsqrt(y^2 . gamma^T + beta) + skip
//         (IGDN: y * sqrt(...)), gamma and beta already derived.
//
// Both convolutions use torch padding 1, slope 0.01, NHWC activations and
// HWIO weights ([3][3][Cin][Cout] = a [9C][C] matrix).
//
// What bounds it on this card: at TCM's widths (C = 64..384) a 3x3 conv does
// 2*9*C = 1152..6912 FLOP for each 8 bytes of activation it reads and writes,
// far above the 20 FLOP/byte where the H100's fp32 CUDA cores (67 TFLOP/s)
// meet its 3.35 TB/s memory: operations bind it. So the kernel is a GEMM
// tuned for the FMA pipe: per image, M = H*W output pixels, N = C output
// channels, K = taps*C (9 taps for the 3x3 conv, 1 for GDN's contraction).
//
// Design (one kernel, conv_gemm_kernel, templated on C, the epilogue and
// the tile):
// - A block computes a BM x BN tile of [M, N]; each thread a TMR x TNR
//   register micro-tile (8 x 8 in the large tile), so one 128-bit
//   shared-memory load of A and one of B feed 16..32 FMAs, not 1.
// - K runs in stages of kBK = 8 (one tap, eight input channels), kStages
//   deep: A (im2col, implicit: the tap-shifted pixels, 4-byte cp.async with
//   the zero-fill form outside the image, which is torch's zero padding) and
//   B (a slice of the weight matrix, 16-byte cp.async) land in shared memory
//   while earlier stages are multiplied. A is stored k-major ([kBK][BM+4]),
//   so a thread reads its pixels as float4 and the copy's writes do not
//   conflict. Nothing is gathered to HBM: the tap-shifted tile is read again
//   from L2 for each tap (about 9 C-wide reads of the input per N tile).
// - Ragged H, W and batch are masked per pixel; no dimension has to divide
//   anything but C, which must be a multiple of the tile's BN.
// - The tile comes from the wrapper (ops/fused_conv.py::tile_config): the
//   large tile (128 pixels x up to 128 channels, 8 x 8 per thread) where it
//   gives a block per SM, else the small one (32 x 32, 4 x 4 per thread),
//   so that 24x16 and 96x64 images still fill the 132 SMs.
//
// B2 is two launches: conv1 with the epilogue leaky(acc + b1) into a scratch
// `mid`, then conv2 with leaky(acc + b2) + x. It is not fused on this card:
// fusing recomputes conv1 on the ring around each output tile (1.56x conv1's
// FLOPs at 8x8, 1.27x at 16x16, whose 20x20x128 input tile alone is 205 KB),
// while `mid` at [1,384,256,128] is 50 MB, written once and read back
// mostly from the 50 MB L2: about 30 us against the pair's 0.865 ms bound.
// B3 is the conv launch (epilogue acc + b, into a scratch y) plus a 1-tap
// launch over y with A squared as it is read and the GDN epilogue.
//
// The sum order is fixed: each output is one fmaf chain that starts at 0
// and runs over k ascending (taps in (a, b) row-major order, then input
// channels ascending); the bias is added after the chain. GDN: the chain
// over j of fp32(y_j * y_j) * gamma^T[j][k], then + beta, then rsqrtf
// (sqrtf for IGDN), then y * s + skip. No split-K and no atomics: the bits
// do not depend on the tile, so the encoder's and the decoder's scales are
// equal whichever tile each picked.
//
// Interface: plain C, raw pointers, the launch stream; returns
// cudaGetLastError() of the launches (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kBK = 8;      // K per stage: eight channels of one tap
constexpr int kStages = 4;  // cp.async stages in flight
constexpr float kSlope = 0.01f;

// ---- PTX helpers ----
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)), "r"(bytes));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// ---- end PTX helpers ----

enum Epilogue {
  kBiasLeaky = 0,     // leaky(acc + bias)                  B2 conv1
  kBiasLeakyRes = 1,  // leaky(acc + bias) + ep0            B2 conv2 (ep0 = x)
  kBias = 2,          // acc + bias                         B3 conv
  kGdn = 3,           // ep0 * f(acc + bias) + ep1, A^2     B3 GDN (ep0 = y, ep1 = skip)
};

// A BM x BN block tile with a TMR x TNR micro-tile per thread.
template <int BM_, int BN_, int TMR_, int TNR_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TMR = TMR_, TNR = TNR_;
  static constexpr int TM_T = BM / TMR, TN_T = BN / TNR;  // threads along m and n
  static constexpr int THREADS = TM_T * TN_T;
  static constexpr int MIN_BLOCKS = 65536 / (THREADS * 128);  // at most 128 registers
};
// The large tile: 128 pixels x the widest of 128, 64, 32 channels that divides C.
template <int C>
using LargeTile = Tile<128, C % 128 == 0 ? 128 : (C % 64 == 0 ? 64 : 32), 8,
                       C % 64 == 0 ? 8 : 4>;
using SmallTile = Tile<32, 32, 4, 4>;

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : kSlope * v; }

__device__ __forceinline__ void set4(float (&v)[4], float4 f) {
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

// out[m][n] = epilogue(sum over k of A[m][k] * wt[k][n]) for M pixels and
// C channels; A[m][tap*C + ci] is a's pixel m shifted by the tap (zero
// outside the image), or a[m][ci] itself for the 1-tap (GDN) epilogue.
template <int C, int EPI, class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
    conv_gemm_kernel(const float* __restrict__ a, const float* __restrict__ wt,
                     const float* __restrict__ bias, const float* __restrict__ ep0,
                     const float* __restrict__ ep1, float* __restrict__ out, int M, int H,
                     int W, int inverse) {
  constexpr int TAPS = EPI == kGdn ? 1 : 9;
  constexpr int BM = T::BM, BN = T::BN, TMR = T::TMR, TNR = T::TNR;
  constexpr int TM_T = T::TM_T, TN_T = T::TN_T, THREADS = T::THREADS;
  constexpr int LDA = BM + 4;                  // padded: conflict-free cp.async writes
  constexpr int A_ROWS = THREADS / kBK;        // pixels one pass of the block copies
  constexpr int A_ITERS = BM / A_ROWS;         // A elements per thread per stage
  constexpr int B_F4 = kBK * BN / 4;           // 16-byte chunks of B per stage
  constexpr int B_ITERS = (B_F4 + THREADS - 1) / THREADS;
  constexpr int KCH = C / kBK;                 // stages per tap
  constexpr int NIT = TAPS * KCH;
  static_assert(THREADS % kBK == 0 && BM % A_ROWS == 0, "A copy split");
  static_assert(C % BN == 0 && C % kBK == 0 && TMR % 4 == 0 && TNR % 4 == 0, "tile");
  static_assert(NIT >= kStages - 1, "pipeline depth");

  __shared__ __align__(16) float As[kStages][kBK][LDA];
  __shared__ __align__(16) float Bs[kStages][kBK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Copy duty: channel ak of the pixels am + i * A_ROWS of the tile, whose
  // elements in `a` start at abase + i * A_ROWS * C. Per pixel, a bit per
  // tap that lands inside the image (none past the last pixel).
  const int ak = tid % kBK;
  const int am = tid / kBK;
  const int abase = (m0 + am) * C + ak;
  unsigned amask[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int gm = m0 + am + i * A_ROWS;
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

  auto load_stage = [&](int slot, int it) {
    const int tap = it / KCH;
    const int c0 = (it % KCH) * kBK;
    const int off = TAPS == 1 ? c0 : ((tap / 3 - 1) * W + (tap % 3 - 1)) * C + c0;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const bool valid = (amask[i] >> tap) & 1u;
      cp_async4_zfill(&As[slot][ak][am + i * A_ROWS],
                      a + (valid ? abase + i * A_ROWS * C + off : 0), valid ? 4 : 0);
    }
    const float* wrow = wt + static_cast<size_t>(tap * C + c0) * C + n0;
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const int idx = tid + i * THREADS;
      if (B_F4 % THREADS == 0 || idx < B_F4) {
        const int kr = idx / (BN / 4), c4 = (idx % (BN / 4)) * 4;
        cp_async16(&Bs[slot][kr][c4], wrow + kr * C + c4);
      }
    }
  };

  // The thread's outputs: pixels tm*4 + (i%4) + (i/4)*TM_T*4 and channels
  // tn*4 + (j%4) + (j/4)*TN_T*4 of the tile.
  const int tm = tid / TN_T, tn = tid % TN_T;
  float acc[TMR][TNR];
#pragma unroll
  for (int i = 0; i < TMR; ++i)
#pragma unroll
    for (int j = 0; j < TNR; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_stage(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < NIT; ++it) {
    cp_async_wait<kStages - 2>();  // stage `it` has landed (for this thread's copies)
    __syncthreads();               // ... for everyone's, and slot it-1 is free
    if (it + kStages - 1 < NIT) load_stage((it + kStages - 1) % kStages, it + kStages - 1);
    cp_async_commit();             // possibly empty: keeps the group count per stage
    const int slot = it % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TMR], bv[TNR];
#pragma unroll
      for (int g = 0; g < TMR / 4; ++g) {
        float v[4];
        set4(v, *reinterpret_cast<const float4*>(&As[slot][kk][tm * 4 + g * TM_T * 4]));
#pragma unroll
        for (int q = 0; q < 4; ++q) av[g * 4 + q] = EPI == kGdn ? v[q] * v[q] : v[q];
      }
#pragma unroll
      for (int h = 0; h < TNR / 4; ++h) {
        float v[4];
        set4(v, *reinterpret_cast<const float4*>(&Bs[slot][kk][tn * 4 + h * TN_T * 4]));
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[h * 4 + q] = v[q];
      }
#pragma unroll
      for (int i = 0; i < TMR; ++i)
#pragma unroll
        for (int j = 0; j < TNR; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TMR; ++i) {
    const int gm = m0 + tm * 4 + (i % 4) + (i / 4) * TM_T * 4;
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < TNR / 4; ++h) {
      const int n = n0 + tn * 4 + h * TN_T * 4;
      const size_t o = static_cast<size_t>(gm) * C + n;
      float bb[4], v[4];
      set4(bb, __ldg(reinterpret_cast<const float4*>(bias + n)));
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = acc[i][h * 4 + q] + bb[q];
      if (EPI == kBiasLeaky) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = leaky(v[q]);
      } else if (EPI == kBiasLeakyRes) {
        float r[4];
        set4(r, __ldg(reinterpret_cast<const float4*>(ep0 + o)));
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = leaky(v[q]) + r[q];
      } else if (EPI == kGdn) {
        float y[4], sk[4];
        set4(y, __ldg(reinterpret_cast<const float4*>(ep0 + o)));
        set4(sk, __ldg(reinterpret_cast<const float4*>(ep1 + o)));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float scale = inverse ? sqrtf(v[q]) : rsqrtf(v[q]);
          v[q] = y[q] * scale + sk[q];
        }
      }
      *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int C, int EPI, class T>
cudaError_t launch_gemm(const float* a, const float* wt, const float* bias, const float* ep0,
                        const float* ep1, float* out, int M, int H, int W, int inverse,
                        cudaStream_t stream) {
  const dim3 grid((M + T::BM - 1) / T::BM, C / T::BN);
  conv_gemm_kernel<C, EPI, T><<<grid, T::THREADS, 0, stream>>>(a, wt, bias, ep0, ep1, out, M,
                                                               H, W, inverse);
  return cudaGetLastError();
}

template <int C, class T>
cudaError_t residual_block(const float* x, const float* w1, const float* b1, const float* w2,
                           const float* b2, float* mid, float* out, int M, int H, int W,
                           cudaStream_t s) {
  const cudaError_t e =
      launch_gemm<C, kBiasLeaky, T>(x, w1, b1, nullptr, nullptr, mid, M, H, W, 0, s);
  if (e != cudaSuccess) return e;
  return launch_gemm<C, kBiasLeakyRes, T>(mid, w2, b2, x, nullptr, out, M, H, W, 0, s);
}

template <int C, class T>
cudaError_t conv_gdn(const float* x, const float* w, const float* b, const float* gt,
                     const float* beta, const float* skip, float* y, float* out, int M, int H,
                     int W, int inverse, cudaStream_t s) {
  const cudaError_t e = launch_gemm<C, kBias, T>(x, w, b, nullptr, nullptr, y, M, H, W, 0, s);
  if (e != cudaSuccess) return e;
  return launch_gemm<C, kGdn, T>(y, gt, beta, y, skip, out, M, H, W, inverse, s);
}

template <int C>
int residual_block_tiled(const float* x, const float* w1, const float* b1, const float* w2,
                         const float* b2, float* mid, float* out, int M, int H, int W, int tile,
                         cudaStream_t s) {
  if (tile == 0) return residual_block<C, LargeTile<C>>(x, w1, b1, w2, b2, mid, out, M, H, W, s);
  if (tile == 1) return residual_block<C, SmallTile>(x, w1, b1, w2, b2, mid, out, M, H, W, s);
  return cudaErrorInvalidValue;
}

template <int C>
int conv_gdn_tiled(const float* x, const float* w, const float* b, const float* gt,
                   const float* beta, const float* skip, float* y, float* out, int M, int H,
                   int W, int inverse, int tile, cudaStream_t s) {
  if (tile == 0)
    return conv_gdn<C, LargeTile<C>>(x, w, b, gt, beta, skip, y, out, M, H, W, inverse, s);
  if (tile == 1)
    return conv_gdn<C, SmallTile>(x, w, b, gt, beta, skip, y, out, M, H, W, inverse, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, mid, out: [B][H][W][C]; w1, w2: [3][3][C][C] (HWIO); b1, b2: [C].
// C is 64, 96, 128 or 192; tile 0 = large, 1 = small. mid is scratch.
int fused_residual_block_f32(const float* x, const float* w1, const float* b1, const float* w2,
                             const float* b2, float* mid, float* out, int B, int H, int W, int C,
                             int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  if (C == 64) return residual_block_tiled<64>(x, w1, b1, w2, b2, mid, out, M, H, W, tile, s);
  if (C == 96) return residual_block_tiled<96>(x, w1, b1, w2, b2, mid, out, M, H, W, tile, s);
  if (C == 128) return residual_block_tiled<128>(x, w1, b1, w2, b2, mid, out, M, H, W, tile, s);
  if (C == 192) return residual_block_tiled<192>(x, w1, b1, w2, b2, mid, out, M, H, W, tile, s);
  return cudaErrorInvalidValue;
}

// x, skip, y, out: [B][H][W][C]; w: [3][3][C][C] (HWIO); b, beta: [C];
// gt: [C][C] = gamma^T (gt[j][k] weighs input channel j into output k).
// C is 64, 128, 192, 256 or 384; tile 0 = large, 1 = small. y is scratch.
int fused_conv_gdn_f32(const float* x, const float* w, const float* b, const float* gt,
                       const float* beta, const float* skip, float* y, float* out, int B, int H,
                       int W, int C, int inverse, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  if (C == 64) return conv_gdn_tiled<64>(x, w, b, gt, beta, skip, y, out, M, H, W, inverse, tile, s);
  if (C == 128)
    return conv_gdn_tiled<128>(x, w, b, gt, beta, skip, y, out, M, H, W, inverse, tile, s);
  if (C == 192)
    return conv_gdn_tiled<192>(x, w, b, gt, beta, skip, y, out, M, H, W, inverse, tile, s);
  if (C == 256)
    return conv_gdn_tiled<256>(x, w, b, gt, beta, skip, y, out, M, H, W, inverse, tile, s);
  if (C == 384)
    return conv_gdn_tiled<384>(x, w, b, gt, beta, skip, y, out, M, H, W, inverse, tile, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
