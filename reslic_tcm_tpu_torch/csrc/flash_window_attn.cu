// Flash window attention for Hopper (sm_90a), fp32: one whole Swin sub-block
// per 8x8 window.
//
// Replaces the Pallas TPU kernel reslic_tcm_tpu/ops/flash_window_attn.py
// (flash_window_block / _kernel). For each 8x8 window (T = 64 tokens) of an
// NHWC map with C channels:
//
//   a   = LN1(x)                                     (eps 1e-5)
//   qkv = a . Wqkv + bqkv        (the wrapper folds head_dim^-0.5 into q)
//   per head h: P = softmax(q_h k_h^T + rel_bias[h] + mask), o_h = P v_h
//   x   = x + o . Wproj + bproj
//   x   = x + GELU(LN2(x) . W1 + b1) . W2 + b2       (exact erf GELU)
//
// A second flavour drops LN1 and the MLP branch: it computes
// x + o . Wproj + bproj from qkv = x . Wqkv + bqkv, the TPU kernel's
// with_ln=False, mlp=None (WACNN's WinBasedAttention).
//
// The shifted (SW) flavour takes the already rolled map (torch.roll stays
// outside) and adds -1e9 to the scores of token pairs that the roll brought
// together from opposite image edges: in the last window row when the two
// tokens lie on different sides of row 4, and in the last window column when
// they lie on different sides of column 4, as the TPU kernel does.
//
// What bounds it on this card: per window the LN+MLP block does about
// 2*T*(12*C^2 + 2*T*C) FLOP (7.3 MFLOP at C = 64, 27 MFLOP at C = 128) and
// must move only the window in and out, 2*T*C*4 bytes (32 or 64 KB): about
// 225..420 FLOP per byte, so fp32 operations bound it, not memory. The
// composed PyTorch block is instead bound by the bytes of its intermediates
// (qkv, the per-head score tensors, the 4C MLP hidden layer), which this
// kernel keeps in shared memory. Products are 90% of the FLOPs.
//
// LN+MLP flavour (swin_block_kernel), three design points:
//
// 1. Register-tiled products. Every dense layer is a [64 x KD] . [KD x N]
//    product cut into column blocks of NB <= 128. A thread owns a tile of
//    TM tokens x 4 columns (TM = 8 at NB = 128, 4 at 64, fewer on narrow
//    blocks), reads A as float4 along k and W as float4 along the columns,
//    so each 4-deep step of k costs TM + 4 shared-memory loads for 16*TM
//    fused multiply-adds (10.7 per load at TM = 8, 8 at TM = 4). W's rows
//    reach shared memory with cp.async in slices of 16 rows, two slices in
//    flight, so the L2 latency of the next slice overlaps the current one's
//    FMAs.
// 2. One window over a thread-block cluster of K CTAs (K in {1, 2, 4, 8},
//    chosen by the wrapper from the window count alone). Rank r computes
//    the heads [r*NH/K, (r+1)*NH/K) (their q, k and v columns), the output
//    columns [r*C/K, (r+1)*C/K) of proj and of the MLP's second layer, and
//    its share of each step's 64 hidden units. The pieces a rank needs from
//    the others travel through distributed shared memory
//    (cluster.map_shared_rank, cluster.sync): the attention output before
//    proj, the residual columns before LN2, and each step's hidden units
//    before the second MLP layer. Every rank computes LN1 and LN2 of the
//    whole window itself (a few hundred operations per token). With K > 1
//    a CTA's buffers shrink, and two CTAs fit on an SM where its shared
//    memory allows (C = 64 at K <= 8 and C = 128 at K = 8).
// 3. Results independent of K, bit for bit. Every output element is summed
//    by one thread in one fmaf chain over k ascending (the second MLP layer
//    runs its chain across the hidden steps, whose units are gathered in
//    ascending order), with no split-k partials and no atomics; LN and the
//    softmax reduce with butterfly shuffles in a fixed order; each rank
//    runs the same code for the same element whatever K is. So a stream
//    encoded with one split decodes exactly with another, and every result
//    is deterministic, which the codec's encoder/decoder symmetry needs.
//
// Attention itself (scores, softmax, P.v) is about 8% of the FLOPs: one
// head at a time through a [64][65] score buffer (the odd row stride keeps
// the 32 key rows of a warp on 32 banks), one warp per softmax row.
//
// Attention-only flavour (window_attention_kernel, C = 128 or 192): one
// block of 256 threads per window, x [T][C], qkv [T][3C+1] and one head's
// scores in shared memory (212 KB at C = 192), each head's output written
// over that head's q columns (nothing reads them again), so proj reads its
// input from qkv's first C columns; its dense layers give each thread one
// output column of 8 tokens, reading the weights from L2. It does
// 2*T*(4*C^2 + 2*T*C) FLOP per window (22 MFLOP at C = 192): operations
// bound it too.
//
// Interface: plain C, raw pointers, the launch stream; returns the launch's
// error (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWin = 8;
constexpr int kT = kWin * kWin;  // tokens per window
constexpr int kHalf = kWin / 2;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLS = kT + 1;      // score row stride
constexpr float kNegInf = -1e9f;
constexpr float kEps = 1e-5f;

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

// ss[p][q] = q_p . k_q + rb[p][q] (+ the SW mask) for one head: the thread
// owns key q (lane-varying) for the rows p = tid / 64 + 4i.
template <int HD>
__device__ void head_scores(const float* qh, const float* kh, int ld,
                            const float* __restrict__ rb, float* ss, bool last_row,
                            bool last_col) {
  const int q = threadIdx.x % kT;
  float kq[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) kq[d] = kh[q * ld + d];
  for (int p = threadIdx.x / kT; p < kT; p += kThreads / kT) {
    const float* qp = qh + p * ld;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) s = fmaf(qp[d], kq[d], s);
    s += __ldg(rb + p * kT + q);
    if (last_row && ((p / kWin < kHalf) != (q / kWin < kHalf))) s += kNegInf;
    if (last_col && ((p % kWin < kHalf) != (q % kWin < kHalf))) s += kNegInf;
    ss[p * kLS + q] = s;
  }
}

// Softmax over each of the 64 score rows, one warp per row.
__device__ void softmax_rows(float* ss) {
  const int lane = threadIdx.x % 32;
  for (int p = threadIdx.x / 32; p < kT; p += kWarps) {
    const float v0 = ss[p * kLS + lane];
    const float v1 = ss[p * kLS + lane + 32];
    const float m = warp_max(fmaxf(v0, v1));
    const float e0 = expf(v0 - m);
    const float e1 = expf(v1 - m);
    const float inv = 1.f / warp_sum(e0 + e1);
    ss[p * kLS + lane] = e0 * inv;
    ss[p * kLS + lane + 32] = e1 * inv;
  }
}

// oh[p][d] = sum_q P[p][q] vh[q][d] (q ascending) for one head.
template <int HD>
__device__ void head_output(const float* ss, const float* vh, int ldv, float* oh, int ldo) {
  for (int it = threadIdx.x; it < kT * HD; it += kThreads) {
    const int d = it % HD;
    const int p = it / HD;
    const float* pp = ss + p * kLS;
    float o = 0.f;
    for (int q = 0; q < kT; ++q) o = fmaf(pp[q], vh[q * ldv + d], o);
    oh[p * ldo + d] = o;
  }
}

// ------------------------- LN + MLP flavour -------------------------

constexpr int kSlice = 16;            // W rows per staged slice
constexpr int kStep = 64;             // hidden units per MLP step, all ranks together
constexpr int kSmemPerSM = 233472;    // 228 KB per SM
constexpr int kSmemPerBlock = 232448; // 227 KB per block
constexpr int kSmemReserved = 1024;   // the runtime's share of each block

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Width of the column blocks of an N-wide product: the largest that divides N.
__host__ __device__ constexpr int block_cols(int n) {
  return n % 128 == 0 ? 128
         : n % 96 == 0 ? 96
         : n % 64 == 0 ? 64
         : n % 48 == 0 ? 48
         : n % 32 == 0 ? 32
         : n % 24 == 0 ? 24
         : n % 16 == 0 ? 16
                       : 8;
}

// Tokens per thread tile of an NB-wide block: (64 / TM) * (NB / 4) <= 256 tiles.
__host__ __device__ constexpr int tile_rows(int nb) {
  return nb > 64 ? 8 : nb > 32 ? 4 : nb > 16 ? 2 : 1;
}

// The thread's tile of an NB-wide column block: tokens t0..t0+TM-1,
// columns c0..c0+3; threads past the block's tiles only stage and wait.
template <int NB>
struct Tile {
  static constexpr int TM = tile_rows(NB);
  int t0, c0;
  bool active;
  __device__ Tile()
      : t0(static_cast<int>(threadIdx.x) / (NB / 4) * TM),
        c0(static_cast<int>(threadIdx.x) % (NB / 4) * 4),
        active(threadIdx.x < (kT / TM) * (NB / 4)) {}
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// acc[i][j] += sum over k < KD of A[(t0 + i) * LDA + k] * W[k][c0 + j] for
// the thread's tile, k ascending: one fmaf chain per output. wrow(k, n) is
// the global address of W row k at the block's column n (a multiple of 4;
// four contiguous floats, 16-byte aligned). W comes through `stage` (2 x
// [kSlice][NB]) in slices of kSlice rows, the next slice's cp.async in
// flight while the current one is multiplied. Every thread of the block
// calls it.
template <int NB, int KD, int LDA, class WRow>
__device__ __forceinline__ void product(float (&acc)[tile_rows(NB)][4], const float* A,
                                        WRow wrow, float* stage) {
  constexpr int TM = tile_rows(NB);
  constexpr int CHUNKS = kSlice * NB / 4;
  constexpr int NS = KD / kSlice;
  static_assert(KD % kSlice == 0 && LDA % 4 == 0, "slices and float4 rows");
  const Tile<NB> tl;
  auto fetch = [&](int s) {
    float* buf = stage + (s & 1) * kSlice * NB;
    for (int q = threadIdx.x; q < CHUNKS; q += kThreads) {
      const int kk = q / (NB / 4);
      const int n = q % (NB / 4) * 4;
      cp_async16(buf + kk * NB + n, wrow(s * kSlice + kk, n));
    }
    cp_async_commit();
  };
  fetch(0);
  for (int s = 0; s < NS; ++s) {
    if (s + 1 < NS)
      fetch(s + 1);
    else
      cp_async_commit();  // an empty group keeps "all but the newest" meaning slice s
    cp_async_wait1();
    __syncthreads();
    if (tl.active) {
      const float* ws = stage + (s & 1) * kSlice * NB + tl.c0;
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
    __syncthreads();
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
template <int C, int HD, int K>
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
  static constexpr int NBMAX = cmax(NBQ, cmax(CK, HC));
  static constexpr int ATT = kT * LQ + kT * kLS;                    // qkv + scores
  static constexpr int MLP = kT * LH + (K > 1 ? 2 * kT * LHO : 0);  // gathered + own hidden
  static constexpr int FLOATS = 2 * kT * LX + cmax(ATT, MLP) + 2 * kSlice * NBMAX;
  static constexpr int BYTES = 4 * FLOATS;
  static constexpr int MIN_BLOCKS = 2 * (BYTES + kSmemReserved) <= kSmemPerSM ? 2 : 1;
  static_assert(C % 32 == 0 && NH * HD == C && NH % K == 0, "heads split evenly over the cluster");
  static_assert(CK % 4 == 0 && HC % 4 == 0 && (4 * C) % kStep == 0 && kStep % K == 0,
                "float4 column tiles");
  static_assert(block_cols(CK) == CK && block_cols(HC) == HC,
                "proj and the MLP layers are one column block each");
  static_assert(C % kSlice == 0 && kStep % kSlice == 0, "whole W slices");
  static_assert(BYTES <= kSmemPerBlock, "shared memory of a block");
};

template <int C, int HD, int K>
__global__ void __launch_bounds__(kThreads, (Swin<C, HD, K>::MIN_BLOCKS))
    swin_block_kernel(const SwinArgs p) {
  using G = Swin<C, HD, K>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                 // [T][LX] residual stream, all C columns
  float* as = xs + kT * G::LX;      // [T][LX] LN1 out, then (K > 1) all heads' output, then LN2 out
  float* qs = as + kT * G::LX;      // [T][LQ] this rank's q | k | v; each head's output over its q
  float* ss = qs + kT * G::LQ;      // [T][kLS] one head's scores
  float* hs = qs;                   // MLP: [T][LH] one step's hidden units, all ranks'
  float* ho = hs + kT * G::LH;      // (K > 1) 2 x [T][LHO] this rank's units, double-buffered
  float* stage = qs + cmax(G::ATT, G::MLP);  // 2 x [kSlice][NB] staged W rows

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
  layer_norm<C>(xs, G::LX, as, G::LX, p.ln1s, p.ln1b);
  __syncthreads();

  // qkv of this rank's heads: local column m lies in segment m / CK (q, k or
  // v) and is global column (m / CK) * C + cbase + m % CK.
  for (int nb0 = 0; nb0 < G::QW; nb0 += G::NBQ) {
    auto col = [&](int n) { return (nb0 + n) / G::CK * C + cbase + (nb0 + n) % G::CK; };
    const Tile<G::NBQ> tl;
    float acc[Tile<G::NBQ>::TM][4] = {};
    product<G::NBQ, C, G::LX>(
        acc, as, [&](int k, int n) { return p.wqkv + static_cast<size_t>(k) * 3 * C + col(n); },
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
  // every rank's q columns into `as` otherwise.
  constexpr int LO = K == 1 ? G::LQ : G::LX;
  const float* os = K == 1 ? qs : as;
  if constexpr (K > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    constexpr int PER = kT * G::CK / 4;
    for (int i = threadIdx.x; i < K * PER; i += kThreads) {
      const int r = i / PER;
      const int t = i % PER / (G::CK / 4);
      const int c = i % (G::CK / 4) * 4;
      const float* src = cluster.map_shared_rank(qs, r);
      *reinterpret_cast<float4*>(as + t * G::LX + r * G::CK + c) =
          *reinterpret_cast<const float4*>(src + t * G::LQ + c);
    }
    __syncthreads();
  }

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

template <int C, int HD, int K>
cudaError_t launch_swin(const SwinArgs& a, int B, cudaStream_t stream) {
  using G = Swin<C, HD, K>;
  cudaError_t e = cudaFuncSetAttribute(swin_block_kernel<C, HD, K>,
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
  e = cudaLaunchKernelEx(&cfg, swin_block_kernel<C, HD, K>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Instances (C, head_dim, K): one CTA per window, and the cluster that the
// wrapper (ops/flash_window_attn.py::max_cluster) gives each (C, head_dim).
#define SWIN_INSTANCES(X)                                                                  \
  X(64, 8, 1) X(64, 8, 8) X(64, 16, 1) X(64, 16, 4) X(64, 32, 1) X(64, 32, 2) X(96, 8, 1)  \
  X(96, 8, 4) X(96, 16, 1) X(96, 16, 2) X(96, 32, 1) X(128, 8, 1) X(128, 8, 8)             \
  X(128, 16, 1) X(128, 16, 8) X(128, 32, 1) X(128, 32, 4)

// ---------------------- attention-only flavour ----------------------

enum Epilogue { kStore = 0, kAccumulate = 1 };

// For every token t < 64 and column j < N:
//   v = sum_k A[t*lda + k] * W[k*ldw + j] + bias[j]   (k ascending)
// kStore: D = v; kAccumulate: D += v.
template <int E>
__device__ void dense(const float* A, int lda, int K, const float* __restrict__ W, int ldw,
                      int N, const float* __restrict__ bias, float* D, int ldd) {
  for (int it = threadIdx.x; it < N * (kT / 8); it += kThreads) {
    const int j = it % N;
    const int t0 = (it / N) * 8;
    float acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = 0.f;
    const float* a = A + t0 * lda;
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(W + static_cast<size_t>(k) * ldw + j);
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[r] = fmaf(a[r * lda + k], w, acc[r]);
    }
    const float bj = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float v = acc[r] + bj;
      float* d = D + (t0 + r) * ldd + j;
      if (E == kStore) *d = v;
      if (E == kAccumulate) *d += v;
    }
  }
}

template <int C, int HD>
__global__ void __launch_bounds__(kThreads)
    window_attention_kernel(const float* __restrict__ x, float* __restrict__ out,
                            const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                            const float* __restrict__ wproj, const float* __restrict__ bproj,
                            const float* __restrict__ relb, int H, int W, int shifted) {
  constexpr int NH = C / HD;
  constexpr int LQ = 3 * C + 1;  // qkv row stride
  static_assert(C % HD == 0, "shape");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;           // [T][C] residual stream
  float* qs = xs + kT * C;    // [T][LQ] qkv; each head's output over its q columns
  float* ss = qs + kT * LQ;   // [T][kLS] one head's scores

  const int nww = W / kWin;
  const int nwh = H / kWin;
  const int wy = blockIdx.x / nww;
  const int wx = blockIdx.x % nww;
  const size_t img = static_cast<size_t>(blockIdx.y) * H * W * C;
  auto gofs = [&](int t, int c) {
    return img + (static_cast<size_t>(wy * kWin + t / kWin) * W + wx * kWin + t % kWin) * C + c;
  };

  for (int i = threadIdx.x; i < kT * C; i += kThreads) xs[i] = x[gofs(i / C, i % C)];
  __syncthreads();
  dense<kStore>(xs, C, C, wqkv, 3 * C, 3 * C, bqkv, qs, LQ);
  __syncthreads();

  const bool last_row = shifted && wy == nwh - 1;
  const bool last_col = shifted && wx == nww - 1;
  for (int h = 0; h < NH; ++h) {
    head_scores<HD>(qs + h * HD, qs + C + h * HD, LQ, relb + static_cast<size_t>(h) * kT * kT,
                    ss, last_row, last_col);
    __syncthreads();
    softmax_rows(ss);
    __syncthreads();
    head_output<HD>(ss, qs + 2 * C + h * HD, LQ, qs + h * HD, LQ);
    __syncthreads();
  }

  dense<kAccumulate>(qs, LQ, C, wproj, C, C, bproj, xs, C);
  __syncthreads();
  for (int i = threadIdx.x; i < kT * C; i += kThreads) out[gofs(i / C, i % C)] = xs[i];
}

template <int C, int HD>
cudaError_t launch_attention(const float* x, float* out, const float* wqkv, const float* bqkv,
                             const float* wproj, const float* bproj, const float* relb, int B,
                             int H, int W, int shifted, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kT * C + kT * (3 * C + 1) + kT * kLS);
  cudaError_t e = cudaFuncSetAttribute(window_attention_kernel<C, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((H / kWin) * (W / kWin), B);
  window_attention_kernel<C, HD><<<grid, kThreads, smem, stream>>>(x, out, wqkv, bqkv, wproj,
                                                                   bproj, relb, H, W, shifted);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: [B][H][W][C] (H, W multiples of 8; C 64, 96 or 128; head_dim 8,
// 16 or 32). wqkv: [C][3C] with the q columns pre-scaled; bqkv: [3C];
// wproj: [C][C]; w1: [C][4C]; w2: [4C][C] (all [in][out], 16-byte aligned);
// relb: [C/head_dim][64][64]; ln*, bproj, b2: [C]; b1: [4C]. cluster: CTAs
// per window, one of SWIN_INSTANCES' K for (C, head_dim); the result does
// not depend on it.
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
  if (C == c && head_dim == hd && cluster == k) return launch_swin<c, hd, k>(a, B, s);
  SWIN_INSTANCES(SWIN_CASE)
#undef SWIN_CASE
  return cudaErrorInvalidValue;
}

// The attention-only flavour (no LN1, no MLP): out = x + attn(x) . Wproj +
// bproj. x, out: [B][H][W][C] (H, W multiples of 8; C 128 with head_dim 16
// or C 192 with head_dim 24). wqkv: [C][3C] with the q columns pre-scaled;
// bqkv: [3C]; wproj: [C][C] ([in][out]); bproj: [C]; relb:
// [C/head_dim][64][64].
int window_attention_block_f32(const float* x, float* out, const float* wqkv,
                               const float* bqkv, const float* wproj, const float* bproj,
                               const float* relb, int B, int H, int W, int C, int head_dim,
                               int shifted, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % kWin != 0 || W % kWin != 0) return cudaErrorInvalidValue;
  if (C == 128 && head_dim == 16)
    return launch_attention<128, 16>(x, out, wqkv, bqkv, wproj, bproj, relb, B, H, W, shifted,
                                     s);
  if (C == 192 && head_dim == 24)
    return launch_attention<192, 24>(x, out, wqkv, bqkv, wproj, bproj, relb, B, H, W, shifted,
                                     s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
