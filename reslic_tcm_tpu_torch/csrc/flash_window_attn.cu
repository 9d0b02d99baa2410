// Flash window attention for Hopper (sm_90a), fp32: one whole Swin sub-block
// per 8x8 window.
//
// Replaces the Pallas TPU kernel reslic_tcm_tpu/ops/flash_window_attn.py:239
// (flash_window_block / _kernel) in both its flavours. For each 8x8 window
// (T = 64 tokens) of an NHWC map with C channels:
//
//   a   = LN1(x)                                     (eps 1e-5)
//   qkv = a . Wqkv + bqkv        (the wrapper folds head_dim^-0.5 into q)
//   per head h: P = softmax(q_h k_h^T + rel_bias[h] + mask), o_h = P v_h
//   x   = x + o . Wproj + bproj
//   x   = x + GELU(LN2(x) . W1 + b1) . W2 + b2       (exact erf GELU)
//
// The attention-only flavour (the TPU function's with_ln=False, mlp=None;
// WACNN's WinBasedAttention) drops LN1 and the MLP branch: qkv = x . Wqkv +
// bqkv and the output is x + o . Wproj + bproj. Both flavours are one
// kernel, swin_block_kernel<C, HD, K, MLP>, the flag MLP choosing at compile
// time.
//
// The shifted (SW) flavour takes the already rolled map (torch.roll stays
// outside) and adds -1e9 to the scores of token pairs that the roll brought
// together from opposite image edges: in the last window row when the two
// tokens lie on different sides of row 4, and in the last window column when
// they lie on different sides of column 4, as the TPU kernel does.
//
// What bounds it on this card: per window the LN+MLP block does about
// 2*T*(12*C^2 + 2*T*C) FLOP (7.3 MFLOP at C = 64, 27 MFLOP at C = 128) and
// the attention-only block 2*T*(4*C^2 + 2*T*C) (22 MFLOP at C = 192, 10.5
// at C = 128), and each must move only the window in and out, 2*T*C*4 bytes
// (32-96 KB): 110-420 FLOP per byte, so fp32 operations bound it, not
// memory. The composed PyTorch block is instead bound by the bytes of its
// intermediates (qkv, the per-head score tensors, the 4C MLP hidden layer),
// which this kernel keeps in shared memory. Products are 86-92% of the
// FLOPs.
//
// Design (the products and the attention helpers are in
// window_attn_common.cuh):
//
// 1. Register-tiled products: every dense layer is a [64 x KD] . [KD x N]
//    product cut into column blocks of NB <= 128, with TM x 4 tiles per
//    thread and W staged through shared memory by cp.async.
// 2. One window over a thread-block cluster of K CTAs (K in {1, 2, 4, 8},
//    chosen by the wrapper from the shape alone: ops/flash_window_attn.py
//    cluster_size for LN+MLP, attn_cluster_size for attention-only). Rank r
//    computes the heads [r*NH/K, (r+1)*NH/K) (their q, k and v columns) and
//    the output columns [r*C/K, (r+1)*C/K) of proj (and of the MLP's second
//    layer, with its share of each step's 64 hidden units). The pieces a
//    rank needs from the others travel through distributed shared memory
//    (cluster.map_shared_rank, cluster.sync): the attention output before
//    proj, and with the MLP the residual columns before LN2 and each step's
//    hidden units before the second layer. Every rank computes LN1 and LN2
//    of the whole window itself (a few hundred operations per token). With
//    K > 1 a CTA's buffers shrink, and two CTAs fit on an SM where the
//    shared memory allows.
//    Shared memory per CTA (floats): the window x [T][C+4]; with the MLP a
//    second [T][C+4] for LN1's output, the gathered heads and LN2's output;
//    qkv [T][3C/K+4] and one head's scores [T][T+4], later (MLP) the hidden
//    units; and 2 to 4 x [16][NB] staged W rows (LN+MLP: 2; attention-only:
//    the most that keep the CTA's blocks per SM). The attention-only flavour
//    gathers the heads' output over x (qkv no longer needs it) and reads x's
//    residual from global memory again in proj's epilogue: 223 KB at C =
//    192, K = 1 (2 stages), 112 KB at K = 4 (3 stages, two CTAs per SM).
//    With the MLP at C = 192 one CTA would need 266 KB (the two window
//    buffers 98 KB, qkv and the scores 166 KB), more than a block may have,
//    so that width always runs on a cluster of at least 2: 200 KB per CTA
//    at K = 2.
// 3. Results independent of K, bit for bit. Every output element is summed
//    by one thread in one fmaf chain over k ascending (the second MLP layer
//    runs its chain across the hidden steps, whose units are gathered in
//    ascending order), with the bias added after the chain; no split-k
//    partials and no atomics; LN and the softmax reduce with butterfly
//    shuffles in a fixed order; each rank runs the same code for the same
//    element whatever K is. So a stream encoded with one split decodes
//    exactly with another, and every result is deterministic, which the
//    codec's encoder/decoder symmetry needs.
//
// Attention itself (scores, softmax, P.v) goes one head at a time through a
// [64][68] score buffer, one warp per softmax row, P.v in TP x 4 tiles.
//
// Interface: plain C, raw pointers, the launch stream; returns the launch's
// error (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "window_attn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-5f;
constexpr int kStep = 64;  // hidden units per MLP step, all ranks together

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// dst[t][c] = LN(src[t][c]) * g[c] + b[c], one warp per token.
template <int C>
__device__ void layer_norm(const float* src, int lds, float* dst, int ldd,
                           const float* __restrict__ g, const float* __restrict__ b) {
  constexpr int PER = C / 32;
  const int lane = threadIdx.x % 32;
  for (int t = threadIdx.x / 32; t < kT; t += kWarps) {
    float v[PER];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = src[t * lds + lane + 32 * i];
      s += v[i];
    }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] -= mu;
      q += v[i] * v[i];
    }
    const float rstd = rsqrtf(warp_sum(q) / C + kEps);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      dst[t * ldd + c] = v[i] * rstd * __ldg(g + c) + __ldg(b + c);
    }
  }
}

struct SwinArgs {
  const float* x;
  float* out;
  const float *wqkv, *bqkv, *wproj, *bproj, *ln1s, *ln1b, *relb, *ln2s, *ln2b, *w1, *b1, *w2,
      *b2;
  int H, W, shifted;
};

// Shared-memory geometry of one CTA of a K-CTA cluster (floats).
template <int C, int HD, int K, bool MLP>
struct Swin {
  static constexpr int NH = C / HD;
  static constexpr int HK = NH / K;    // heads per rank
  static constexpr int CK = C / K;     // output columns per rank
  static constexpr int QW = 3 * CK;    // qkv columns per rank
  static constexpr int HC = kStep / K; // hidden units per rank and step
  static constexpr int LX = C + 4;     // row strides: float4 rows on distinct banks
  static constexpr int LQ = QW + 4;
  static constexpr int LH = kStep + 4;
  static constexpr int LHO = HC + 4;
  static constexpr int NBQ = block_cols(QW);
  static constexpr int NBP = MLP ? CK : block_cols(CK);  // proj's column blocks
  static constexpr int NBMAX = cmax(cmax(NBQ, NBP), MLP ? HC : 0);
  static constexpr int ATT = kT * LQ + kT * kLS;                             // qkv + scores
  static constexpr int HID = MLP ? kT * LH + (K > 1 ? 2 * kT * LHO : 0) : 0;  // gathered + own hidden
  static constexpr int FIXED = (MLP ? 2 : 1) * kT * LX + cmax(ATT, HID);
  static constexpr int STAGES = MLP ? 2 : w_stages(FIXED, NBMAX);  // W stages of the products
  static constexpr int BYTES = smem_bytes(FIXED, STAGES, NBMAX);
  static constexpr int MIN_BLOCKS = blocks_per_sm(BYTES);
  static_assert(C % 32 == 0 && NH * HD == C && NH % K == 0, "heads split evenly over the cluster");
  static_assert(CK % 4 == 0 && HC % 4 == 0 && (4 * C) % kStep == 0 && kStep % K == 0,
                "float4 column tiles");
  static_assert(!MLP || (block_cols(CK) == CK && block_cols(HC) == HC),
                "with the MLP, proj and the MLP layers are one column block each");
  static_assert(C % kSlice == 0 && kStep % kSlice == 0, "whole W slices");
  static_assert(BYTES <= kSmemPerBlock, "shared memory of a block");
};

template <int C, int HD, int K, bool MLP>
__global__ void __launch_bounds__(kThreads, (Swin<C, HD, K, MLP>::MIN_BLOCKS))
    swin_block_kernel(const SwinArgs p) {
  using G = Swin<C, HD, K, MLP>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [T][LX] the window; with the MLP the residual stream;
                                    // attention-only at K > 1: then all heads' output
  float* as = xs + kT * G::LX;      // (MLP) [T][LX] LN1 out, then (K > 1) all heads' output, then LN2 out
  float* qs = xs + (MLP ? 2 : 1) * kT * G::LX;  // [T][LQ] this rank's q | k | v; each head's output over its q
  float* ss = qs + kT * G::LQ;      // [T][kLS] one head's scores
  float* hs = qs;                   // MLP: [T][LH] one step's hidden units, all ranks'
  float* ho = hs + kT * G::LH;      // (K > 1) 2 x [T][LHO] this rank's units, double-buffered
  float* stage = qs + cmax(G::ATT, G::HID);  // STAGES x [kSlice][NB] staged W rows

  const int rank = K == 1 ? 0 : static_cast<int>(cg::this_cluster().block_rank());
  const int win = blockIdx.x / K;
  const int nww = p.W / kWin;
  const int nwh = p.H / kWin;
  const int wy = win / nww;
  const int wx = win % nww;
  const size_t img = static_cast<size_t>(blockIdx.y) * p.H * p.W * C;
  auto gofs = [&](int t, int c) {
    return img + (static_cast<size_t>(wy * kWin + t / kWin) * p.W + wx * kWin + t % kWin) * C + c;
  };
  const int cbase = rank * G::CK;  // this rank's first output column

  for (int i = threadIdx.x; i < kT * C / 4; i += kThreads) {
    const int t = i / (C / 4);
    const int c = i % (C / 4) * 4;
    *reinterpret_cast<float4*>(xs + t * G::LX + c) =
        __ldg(reinterpret_cast<const float4*>(p.x + gofs(t, c)));
  }
  __syncthreads();
  if constexpr (MLP) {
    layer_norm<C>(xs, G::LX, as, G::LX, p.ln1s, p.ln1b);
    __syncthreads();
  }
  const float* qin = MLP ? as : xs;  // qkv's input

  // qkv of this rank's heads: local column m lies in segment m / CK (q, k or
  // v) and is global column (m / CK) * C + cbase + m % CK.
  for (int nb0 = 0; nb0 < G::QW; nb0 += G::NBQ) {
    auto col = [&](int n) { return (nb0 + n) / G::CK * C + cbase + (nb0 + n) % G::CK; };
    const Tile<G::NBQ> tl;
    float acc[Tile<G::NBQ>::TM][4] = {};
    product<G::NBQ, C, G::LX, kT, G::STAGES>(
        acc, qin, [&](int k, int n) { return p.wqkv + static_cast<size_t>(k) * 3 * C + col(n); },
        stage);
    if (tl.active) {
#pragma unroll
      for (int i = 0; i < Tile<G::NBQ>::TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          qs[(tl.t0 + i) * G::LQ + nb0 + tl.c0 + j] = acc[i][j] + __ldg(p.bqkv + col(tl.c0 + j));
    }
  }
  __syncthreads();

  const bool last_row = p.shifted && wy == nwh - 1;
  const bool last_col = p.shifted && wx == nww - 1;
  for (int hl = 0; hl < G::HK; ++hl) {
    const int h = rank * G::HK + hl;
    head_scores<HD>(qs + hl * HD, qs + G::CK + hl * HD, G::LQ,
                    p.relb + static_cast<size_t>(h) * kT * kT, ss, last_row, last_col);
    __syncthreads();
    softmax_rows(ss);
    __syncthreads();
    head_output<HD>(ss, qs + 2 * G::CK + hl * HD, G::LQ, qs + hl * HD, G::LQ);
    __syncthreads();
  }

  // All heads' output, [T][C]: qkv's first columns at K = 1; gathered from
  // every rank's q columns otherwise (into `as` with the MLP, over x without).
  constexpr int LO = K == 1 ? G::LQ : G::LX;
  float* og = MLP ? as : xs;
  const float* os = K == 1 ? qs : og;
  if constexpr (K > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    constexpr int PER = kT * G::CK / 4;
    for (int i = threadIdx.x; i < K * PER; i += kThreads) {
      const int r = i / PER;
      const int t = i % PER / (G::CK / 4);
      const int c = i % (G::CK / 4) * 4;
      const float* src = cluster.map_shared_rank(qs, r);
      *reinterpret_cast<float4*>(og + t * G::LX + r * G::CK + c) =
          *reinterpret_cast<const float4*>(src + t * G::LQ + c);
    }
    if constexpr (MLP)
      __syncthreads();
    else
      cluster.sync();  // every rank is done reading qs: nothing of the cluster's reads it again
  }

  if constexpr (!MLP) {
    // out[:, own columns] = x + (o . Wproj + bproj), x read again from memory
    for (int nb0 = 0; nb0 < G::CK; nb0 += G::NBP) {
      const Tile<G::NBP> tl;
      float acc[Tile<G::NBP>::TM][4] = {};
      product<G::NBP, C, LO, kT, G::STAGES>(
          acc, os,
          [&](int k, int n) { return p.wproj + static_cast<size_t>(k) * C + cbase + nb0 + n; },
          stage);
      if (tl.active) {
        const int c = cbase + nb0 + tl.c0;
#pragma unroll
        for (int i = 0; i < Tile<G::NBP>::TM; ++i) {
          const size_t o = gofs(tl.t0 + i, c);
          const float4 xv = __ldg(reinterpret_cast<const float4*>(p.x + o));
          float4 v;
          v.x = xv.x + (acc[i][0] + __ldg(p.bproj + c));
          v.y = xv.y + (acc[i][1] + __ldg(p.bproj + c + 1));
          v.z = xv.z + (acc[i][2] + __ldg(p.bproj + c + 2));
          v.w = xv.w + (acc[i][3] + __ldg(p.bproj + c + 3));
          *reinterpret_cast<float4*>(p.out + o) = v;
        }
      }
    }
    return;
  } else {
    {  // x[:, own columns] += o . Wproj + bproj
      const Tile<G::CK> tl;
      float acc[Tile<G::CK>::TM][4] = {};
      product<G::CK, C, LO>(
          acc, os, [&](int k, int n) { return p.wproj + static_cast<size_t>(k) * C + cbase + n; },
          stage);
      if (tl.active) {
#pragma unroll
        for (int i = 0; i < Tile<G::CK>::TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = cbase + tl.c0 + j;
            xs[(tl.t0 + i) * G::LX + c] += acc[i][j] + __ldg(p.bproj + c);
          }
      }
    }
    if constexpr (K > 1) {
      // every rank's new columns are in, and every rank is done reading qs
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      constexpr int PER = kT * G::CK / 4;
      for (int i = threadIdx.x; i < K * PER; i += kThreads) {
        const int r = i / PER;
        if (r == rank) continue;
        const int t = i % PER / (G::CK / 4);
        const int c = r * G::CK + i % (G::CK / 4) * 4;
        const float* src = cluster.map_shared_rank(xs, r);
        *reinterpret_cast<float4*>(xs + t * G::LX + c) =
            *reinterpret_cast<const float4*>(src + t * G::LX + c);
      }
    }
    __syncthreads();
    layer_norm<C>(xs, G::LX, as, G::LX, p.ln2s, p.ln2b);
    __syncthreads();

    // MLP in steps of kStep hidden units: each rank computes HC of them, the
    // step's units are gathered in ascending order, and the second layer's
    // fmaf chains (acc2) run on over all 4C units.
    const Tile<G::CK> t2;
    float acc2[Tile<G::CK>::TM][4] = {};
    for (int s = 0; s < 4 * C / kStep; ++s) {
      const int u0 = s * kStep + rank * G::HC;  // this rank's first hidden unit of the step
      constexpr int LHD = K == 1 ? G::LH : G::LHO;
      float* hd = K == 1 ? hs : ho + (s & 1) * kT * G::LHO;
      {
        const Tile<G::HC> tl;
        float acc[Tile<G::HC>::TM][4] = {};
        product<G::HC, C, G::LX>(
            acc, as, [&](int k, int n) { return p.w1 + static_cast<size_t>(k) * 4 * C + u0 + n; },
            stage);
        if (tl.active) {
#pragma unroll
          for (int i = 0; i < Tile<G::HC>::TM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              hd[(tl.t0 + i) * LHD + tl.c0 + j] = gelu(acc[i][j] + __ldg(p.b1 + u0 + tl.c0 + j));
        }
      }
      if constexpr (K > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();
        constexpr int PER = kT * G::HC / 4;
        for (int i = threadIdx.x; i < K * PER; i += kThreads) {
          const int r = i / PER;
          const int t = i % PER / (G::HC / 4);
          const int c = i % (G::HC / 4) * 4;
          const float* src = cluster.map_shared_rank(hd, r);
          *reinterpret_cast<float4*>(hs + t * G::LH + r * G::HC + c) =
              *reinterpret_cast<const float4*>(src + t * G::LHO + c);
        }
      }
      __syncthreads();
      product<G::CK, kStep, G::LH>(
          acc2, hs,
          [&](int k, int n) {
            return p.w2 + static_cast<size_t>(s * kStep + k) * C + cbase + n;
          },
          stage);
    }
    if (t2.active) {
#pragma unroll
      for (int i = 0; i < Tile<G::CK>::TM; ++i) {
        const int t = t2.t0 + i;
        const int c = cbase + t2.c0;
        float4 v;
        v.x = xs[t * G::LX + c] + (acc2[i][0] + __ldg(p.b2 + c));
        v.y = xs[t * G::LX + c + 1] + (acc2[i][1] + __ldg(p.b2 + c + 1));
        v.z = xs[t * G::LX + c + 2] + (acc2[i][2] + __ldg(p.b2 + c + 2));
        v.w = xs[t * G::LX + c + 3] + (acc2[i][3] + __ldg(p.b2 + c + 3));
        *reinterpret_cast<float4*>(p.out + gofs(t, c)) = v;
      }
    }
    if constexpr (K > 1) cg::this_cluster().sync();  // peers may still read this rank's hidden units
  }
}

template <int C, int HD, int K, bool MLP>
cudaError_t launch_swin(const SwinArgs& a, int B, cudaStream_t stream) {
  using G = Swin<C, HD, K, MLP>;
  cudaError_t e = cudaFuncSetAttribute(swin_block_kernel<C, HD, K, MLP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, G::BYTES);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.H / kWin) * (a.W / kWin) * K, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = G::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, swin_block_kernel<C, HD, K, MLP>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Instances (C, head_dim, K) of the LN+MLP flavour: the smallest cluster
// (ops/flash_window_attn.py::min_cluster: one CTA per window, or two at
// C = 192, whose CTA does not fit one SM's shared memory alone) and the
// largest (max_cluster) for each (C, head_dim).
#define SWIN_INSTANCES(X)                                                                  \
  X(64, 8, 1) X(64, 8, 8) X(64, 16, 1) X(64, 16, 4) X(64, 32, 1) X(64, 32, 2) X(96, 8, 1)  \
  X(96, 8, 4) X(96, 16, 1) X(96, 16, 2) X(96, 32, 1) X(128, 8, 1) X(128, 8, 8)             \
  X(128, 16, 1) X(128, 16, 8) X(128, 32, 1) X(128, 32, 4) X(192, 8, 2) X(192, 8, 8)        \
  X(192, 16, 2) X(192, 16, 4) X(192, 32, 2)

// Instances (C, head_dim, K) of the attention-only flavour: every cluster
// that ops/flash_window_attn.py::ATTN_CLUSTERS lists for (C, head_dim).
#define ATTN_INSTANCES(X) \
  X(128, 16, 1) X(128, 16, 2) X(128, 16, 4) X(192, 24, 1) X(192, 24, 2) X(192, 24, 4)

}  // namespace

extern "C" {

// x, out: [B][H][W][C] (H, W multiples of 8; C 64, 96, 128 or 192;
// head_dim 8, 16 or 32). wqkv: [C][3C] with the q columns pre-scaled;
// bqkv: [3C]; wproj: [C][C]; w1: [C][4C]; w2: [4C][C] (all [in][out],
// 16-byte aligned); relb: [C/head_dim][64][64]; ln*, bproj, b2: [C]; b1:
// [4C]. cluster: CTAs per window, one of SWIN_INSTANCES' K for (C,
// head_dim); the result does not depend on it.
int flash_window_block_f32(const float* x, float* out, const float* wqkv, const float* bqkv,
                           const float* wproj, const float* bproj, const float* ln1s,
                           const float* ln1b, const float* relb, const float* ln2s,
                           const float* ln2b, const float* w1, const float* b1,
                           const float* w2, const float* b2, int B, int H, int W, int C,
                           int head_dim, int cluster, int shifted, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % kWin != 0 || W % kWin != 0 || B <= 0) return cudaErrorInvalidValue;
  const SwinArgs a{x,    out,  wqkv, bqkv, wproj, bproj, ln1s, ln1b, relb,
                   ln2s, ln2b, w1,   b1,   w2,    b2,    H,    W,    shifted};
#define SWIN_CASE(c, hd, k) \
  if (C == c && head_dim == hd && cluster == k) return launch_swin<c, hd, k, true>(a, B, s);
  SWIN_INSTANCES(SWIN_CASE)
#undef SWIN_CASE
  return cudaErrorInvalidValue;
}

// The attention-only flavour (no LN1, no MLP): out = x + attn(x) . Wproj +
// bproj. x, out: [B][H][W][C] (H, W multiples of 8; C 128 with head_dim 16
// or C 192 with head_dim 24), 16-byte aligned. wqkv: [C][3C] with the q
// columns pre-scaled; bqkv: [3C]; wproj: [C][C] ([in][out]); bproj: [C];
// relb: [C/head_dim][64][64]. cluster: CTAs per window, one of
// ATTN_INSTANCES' K for (C, head_dim); the result does not depend on it.
int window_attention_block_f32(const float* x, float* out, const float* wqkv,
                               const float* bqkv, const float* wproj, const float* bproj,
                               const float* relb, int B, int H, int W, int C, int head_dim,
                               int cluster, int shifted, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % kWin != 0 || W % kWin != 0 || B <= 0) return cudaErrorInvalidValue;
  const SwinArgs a{x,       out,     wqkv, bqkv,    wproj,   bproj,   nullptr, nullptr, relb,
                   nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, H,       W,       shifted};
#define ATTN_CASE(c, hd, k) \
  if (C == c && head_dim == hd && cluster == k) return launch_swin<c, hd, k, false>(a, B, s);
  ATTN_INSTANCES(ATTN_CASE)
#undef ATTN_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
