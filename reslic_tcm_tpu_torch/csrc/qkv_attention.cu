// Per-window qkv attention for Hopper (sm_90a), fp32.
//
// Replaces the repository's per-head Pallas TPU kernel
// artifacts/pallas_attn_perhead.py:80 (fused_qkv_attention / _kernel), which
// sits beside the JAX package and is not imported by it. For each window w
// of Nw windows of T tokens with C channels and NH = C / HD heads:
//
//   qkv = x_w . Wqkv + bqkv
//   per head h: P = softmax((q_h k_h^T) * HD^-0.5 + rel_bias[h] (+ mask[w % nW]))
//               o_h = P v_h
//   out_w = o . Wproj + bproj                   (no LayerNorm, MLP or residual)
//
// The scale multiplies the scores after q.k, as the TPU kernel does (the
// composed WindowAttention scales q first: an ulp apart). The additive mask
// is [nW][T][T], indexed by the window's number modulo nW, so one image's
// mask serves a batch of images laid out window-major per image.
//
// What bounds it on this card: per window 2*T*(4*C^2 + 2*T*C) FLOP (13.4
// MFLOP at T = 16, C = 320) for 2*T*C*4 = 40 KB of activations in and out
// plus the weights (1.6 MB, once from device memory): 1.29 GFLOP for 5.6 MB
// at WACNN's 96 windows, about 230 FLOP per byte, so fp32 operations bound
// it (19 us on an H100). The composed PyTorch version is bound instead by
// the round trips of qkv, the per-head scores and the probabilities through
// device memory, which this kernel keeps in shared memory.
//
// Design (the product is window_attn_common.cuh's, as in B1):
//
// 1. Rows from several windows. A CTA takes G windows (G*T rows), so the G
//    windows share one staged read of W: at 96 windows and G = 2, 48
//    groups read 79 MB of weights from L2 instead of 157 MB (G = 4 reads
//    39 MB but, with half the CTAs, measured no faster on an H100 at the
//    window counts up to 96 tried). A ragged last group (Nw not a multiple
//    of G) reads zero rows for the missing windows and stores nothing for
//    them.
// 2. Heads over a cluster of K CTAs (K = 4 or 8). Rank r computes its
//    NH/K heads' q, k and v columns ([R x C] . [C x 3C/K], register-tiled,
//    W through cp.async), their attention with no exchange (heads are
//    independent), and, after gathering every head's output through
//    distributed shared memory, proj's C/K output columns. The wrapper
//    (ops/qkv_attention.py::group_config) chooses (G, K) from the shape.
//    Shared memory (floats): x [R][C+4], its space reused for this rank's
//    scores and then for the gathered heads' output; qkv [R][3C/K+4]; 2 to
//    4 x [16][NB] staged W rows, the most that keep the CTA's blocks per SM.
//    At T = 16, C = 320: 101 KB at (2, 4) with 2 stages of its 240-column
//    qkv block, 86 KB at (2, 8) with 4; two CTAs per SM.
// 3. Attention per window: a [T][T] score block per window and head (not
//    [R][R]): each score one fmaf chain over d, then s * scale +
//    rel_bias, then + mask; the softmax takes one thread per row with a
//    sequential max and sum over the T keys and divides by the sum; P.v
//    one fmaf chain over the keys.
// 4. Fixed order, no atomics: every output element is one fmaf chain over
//    k ascending with the bias added after it, so the result does not
//    depend on (G, K), and equals the one-window-per-block design's bits.
//
// Interface: plain C, raw pointers, the launch stream; returns the launch's
// error (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "window_attn_common.cuh"

namespace cg = cooperative_groups;

namespace {

// Shared-memory geometry of one CTA: G windows of T tokens, heads over K CTAs.
template <int T, int C, int HD, int G, int K>
struct Qkv {
  static constexpr int R = G * T;     // rows
  static constexpr int NH = C / HD;
  static constexpr int HK = NH / K;   // heads per rank
  static constexpr int CK = C / K;    // proj output columns per rank
  static constexpr int QW = 3 * CK;   // qkv columns per rank
  static constexpr int LX = C + 4;    // row strides: float4 rows
  static constexpr int LQ = QW + 4;
  static constexpr int LS = T + 1;    // score rows: the softmax's threads on distinct banks
  // qkv in one column block where its tiles fit the threads (8 x 4 tiles at
  // 32 rows and 240 columns), else in block_cols blocks
  static constexpr int NBQ = R / 8 * (QW / 4) <= kThreads ? QW : block_cols(QW);
  static constexpr int NBP = block_cols(CK);
  static constexpr int FIXED = R * LX + R * LQ;
  static constexpr int STAGES = w_stages(FIXED, cmax(NBQ, NBP));  // W stages of the products
  static constexpr int BYTES = smem_bytes(FIXED, STAGES, cmax(NBQ, NBP));
  static constexpr int MIN_BLOCKS = blocks_per_sm(BYTES);
  static_assert(NH * HD == C && NH % K == 0 && HD % 4 == 0 && CK % 4 == 0, "heads split evenly");
  static_assert(C % kSlice == 0 && QW % NBQ == 0 && CK % NBP == 0, "whole slices and blocks");
  static_assert(HK * G * T * LS <= R * LX, "the scores fit in x's space");
  static_assert(BYTES <= kSmemPerBlock, "shared memory of a block");
};

struct QkvArgs {
  const float *x;
  float* out;
  const float *wqkv, *bqkv, *relb, *wproj, *bproj, *mask;
  int n_windows, n_mask;
  float scale;
};

template <int T, int C, int HD, int G, int K>
__global__ void __launch_bounds__(kThreads, (Qkv<T, C, HD, G, K>::MIN_BLOCKS))
    qkv_attention_kernel(const QkvArgs p) {
  using Q = Qkv<T, C, HD, G, K>;
  constexpr int R = Q::R;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [R][LX] the windows, then all heads' output
  float* ss = smem;               // [HK][G][T][LS] scores over x's space (x read by then)
  float* qs = xs + R * Q::LX;     // [R][LQ] this rank's q | k | v; each head's output over its q
  float* stage = qs + R * Q::LQ;  // STAGES x [kSlice][NB] staged W rows

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int win0 = blockIdx.x / K * G;  // the group's first window
  const int cbase = rank * Q::CK;       // this rank's first proj column
  const size_t row0 = static_cast<size_t>(win0) * T;

  for (int i = threadIdx.x; i < R * C / 4; i += kThreads) {
    const int r = i / (C / 4);
    const int c = i % (C / 4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (win0 + r / T < p.n_windows)
      v = __ldg(reinterpret_cast<const float4*>(p.x + (row0 + r) * C + c));
    *reinterpret_cast<float4*>(xs + r * Q::LX + c) = v;
  }
  __syncthreads();

  // qkv of this rank's heads: local column m lies in segment m / CK (q, k or
  // v) and is global column (m / CK) * C + cbase + m % CK.
  for (int nb0 = 0; nb0 < Q::QW; nb0 += Q::NBQ) {
    auto col = [&](int n) { return (nb0 + n) / Q::CK * C + cbase + (nb0 + n) % Q::CK; };
    const Tile<Q::NBQ, R> tl;
    float acc[Tile<Q::NBQ, R>::TM][4] = {};
    product<Q::NBQ, C, Q::LX, R, Q::STAGES>(
        acc, xs, [&](int k, int n) { return p.wqkv + static_cast<size_t>(k) * 3 * C + col(n); },
        stage);
    if (tl.active) {
#pragma unroll
      for (int i = 0; i < Tile<Q::NBQ, R>::TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          qs[(tl.t0 + i) * Q::LQ + nb0 + tl.c0 + j] = acc[i][j] + __ldg(p.bqkv + col(tl.c0 + j));
    }
  }
  __syncthreads();

  // scores of this rank's heads, per window: ss[hl][w][p][q]
  for (int it = threadIdx.x; it < Q::HK * G * T * T; it += kThreads) {
    const int q = it % T;
    const int pr = it / T % T;
    const int w = it / (T * T) % G;
    const int hl = it / (T * T * G);
    const int h = rank * Q::HK + hl;
    const float* qp = qs + (w * T + pr) * Q::LQ + hl * HD;
    const float* kq = qs + (w * T + q) * Q::LQ + Q::CK + hl * HD;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qp + d);
      const float4 b = *reinterpret_cast<const float4*>(kq + d);
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
      s = fmaf(a.z, b.z, s);
      s = fmaf(a.w, b.w, s);
    }
    s = s * p.scale + __ldg(p.relb + (h * T + pr) * T + q);
    if (p.mask != nullptr) s += __ldg(p.mask + (static_cast<size_t>((win0 + w) % p.n_mask) * T + pr) * T + q);
    ss[((hl * G + w) * T + pr) * Q::LS + q] = s;
  }
  __syncthreads();

  for (int row = threadIdx.x; row < Q::HK * G * T; row += kThreads) {
    float* sr = ss + row * Q::LS;
    float m = sr[0];
    for (int q = 1; q < T; ++q) m = fmaxf(m, sr[q]);
    float sum = 0.f;
    for (int q = 0; q < T; ++q) {
      const float e = expf(sr[q] - m);
      sr[q] = e;
      sum += e;
    }
    for (int q = 0; q < T; ++q) sr[q] = sr[q] / sum;
  }
  __syncthreads();

  // o[r][m] = sum_q P[hl][w][p][q] v[w*T + q][m] over this rank's head columns m
  for (int it = threadIdx.x; it < R * Q::HK * HD; it += kThreads) {
    const int m = it % (Q::HK * HD);
    const int r = it / (Q::HK * HD);
    const int w = r / T;
    const float* pp = ss + ((m / HD * G + w) * T + r % T) * Q::LS;
    const float* vv = qs + w * T * Q::LQ + 2 * Q::CK + m;
    float o = 0.f;
    for (int q = 0; q < T; ++q) o = fmaf(pp[q], vv[q * Q::LQ], o);
    qs[r * Q::LQ + m] = o;
  }

  // every head's output, [R][C], gathered from each rank's q columns over x
  cluster.sync();
  constexpr int PER = R * Q::CK / 4;
  for (int i = threadIdx.x; i < K * PER; i += kThreads) {
    const int rk = i / PER;
    const int r = i % PER / (Q::CK / 4);
    const int c = i % (Q::CK / 4) * 4;
    const float* src = cluster.map_shared_rank(qs, rk);
    *reinterpret_cast<float4*>(xs + r * Q::LX + rk * Q::CK + c) =
        *reinterpret_cast<const float4*>(src + r * Q::LQ + c);
  }
  cluster.sync();  // every rank is done reading qs: nothing of the cluster's reads it again

  // out[:, own columns] = o . Wproj + bproj
  for (int nb0 = 0; nb0 < Q::CK; nb0 += Q::NBP) {
    const Tile<Q::NBP, R> tl;
    float acc[Tile<Q::NBP, R>::TM][4] = {};
    product<Q::NBP, C, Q::LX, R, Q::STAGES>(
        acc, xs,
        [&](int k, int n) { return p.wproj + static_cast<size_t>(k) * C + cbase + nb0 + n; },
        stage);
    if (tl.active) {
      const int c = cbase + nb0 + tl.c0;
#pragma unroll
      for (int i = 0; i < Tile<Q::NBP, R>::TM; ++i) {
        const int r = tl.t0 + i;
        if (win0 + r / T >= p.n_windows) continue;
        float4 v;
        v.x = acc[i][0] + __ldg(p.bproj + c);
        v.y = acc[i][1] + __ldg(p.bproj + c + 1);
        v.z = acc[i][2] + __ldg(p.bproj + c + 2);
        v.w = acc[i][3] + __ldg(p.bproj + c + 3);
        *reinterpret_cast<float4*>(p.out + (row0 + r) * C + c) = v;
      }
    }
  }
}

template <int T, int C, int HD, int G, int K>
cudaError_t launch(const QkvArgs& a, cudaStream_t stream) {
  using Q = Qkv<T, C, HD, G, K>;
  cudaError_t e = cudaFuncSetAttribute(qkv_attention_kernel<T, C, HD, G, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, Q::BYTES);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n_windows + G - 1) / G * K, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Q::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, qkv_attention_kernel<T, C, HD, G, K>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Instances (T, C, head_dim, G, K): every (windows per CTA, CTAs per
// cluster) that ops/qkv_attention.py::GROUPS lists.
#define QKV_INSTANCES(X) X(16, 320, 40, 2, 4) X(16, 320, 40, 2, 8)

}  // namespace

extern "C" {

// x, out: [Nw][T][C] windows (T 16 with C 320 and head_dim 40), 16-byte
// aligned. wqkv: [C][3C]; wproj: [C][C] (both [in][out]); bqkv: [3C];
// bproj: [C]; relb: [C/head_dim][T][T]; mask: [n_mask][T][T] additive, or
// null (n_mask is then ignored); scale: head_dim^-0.5. group, cluster:
// windows per CTA and CTAs per cluster, one of QKV_INSTANCES' (G, K); the
// result does not depend on them.
int qkv_attention_f32(const float* x, float* out, const float* wqkv, const float* bqkv,
                      const float* relb, const float* wproj, const float* bproj,
                      const float* mask, int n_windows, int T, int C, int head_dim, int n_mask,
                      float scale, int group, int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_windows <= 0 || (mask != nullptr && n_mask <= 0)) return cudaErrorInvalidValue;
  const QkvArgs a{x, out, wqkv, bqkv, relb, wproj, bproj, mask, n_windows, n_mask, scale};
#define QKV_CASE(t, c, hd, g, k)                                                    \
  if (T == t && C == c && head_dim == hd && group == g && cluster == k) \
    return launch<t, c, hd, g, k>(a, s);
  QKV_INSTANCES(QKV_CASE)
#undef QKV_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
