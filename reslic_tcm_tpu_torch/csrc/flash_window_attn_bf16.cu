// Flash window attention for Hopper (sm_90a) on the bf16 tensor cores: the
// bf16 instances of csrc/flash_window_attn.cu's two flavours, one whole
// Swin sub-block (LN+MLP) or one attention block (attention-only) per 8x8
// window.
//
// Replaces the Pallas TPU kernel reslic_tcm_tpu/ops/flash_window_attn.py:239
// (flash_window_block / _kernel) in its bf16 mode (compute_dtype=bfloat16,
// the TPU's default) with LN1 and the MLP. For each 8x8 window (T = 64
// tokens), bf16(.) a round to nearest even at the Pallas body's cast points
// (flash_window_attn.py:93, :173, :183, :195, :213, :225), all sums fp32:
//
//   a   = LN1(x)                                          (eps 1e-5, fp32)
//   qkv = bf16(a) . bf16(Wqkv) + bqkv    (head_dim^-0.5 folded into q in fp32)
//   per head h: P = softmax(bf16(q_h) bf16(k_h)^T + rel_bias[h] + mask)
//               o_h = bf16(P) . bf16(v_h)
//   x   = x + bf16(o) . bf16(Wproj) + bproj
//   x   = x + bf16(GELU(bf16(LN2(x)) . bf16(W1) + b1)) . bf16(W2) + b2
//
// LN, the softmax, the exact erf GELU, the biases and the residuals stay
// fp32. The shifted (SW) flavour takes the rolled map and adds -1e9 to the
// scores of token pairs the roll brought together, as the fp32 instance.
//
// The attention-only flavour (with_ln=False, mlp=None: WACNN's
// WinBasedAttention at (C, head_dim) = (128, 16) and (192, 24)) is
// attn_block_bf16_kernel<C, HD, K>: x + bf16(o) . bf16(Wproj) + bproj with
// qkv = bf16(x) . bf16(Wqkv) + bqkv, the same cast points (the Pallas body's
// flash_window_attn.py:93, :173, :183, :195) and the same attention code.
// Its residual x is read again from global memory in proj's epilogue, so
// shared memory holds only bf16(x) (later the heads' output), q | k, v^T and
// the staged W: 119 KB at C = 192, K = 1. head_dim 24 is not a multiple of
// m16n8k16's k: q.k^T takes a second step over dims 16..31 whose upper half
// (24..31, past the head) is zeroed in registers, as head_dim 8 zeroes 8..15;
// P.v takes three n8 tiles.
//
// What bounds it on this card: per window about 2*T*(12*C^2 + 2*T*C) FLOP
// (7.3 MFLOP at C = 64, 27 at C = 128, 60 at C = 192) against 2*T*C*4 bytes
// in and out (32-96 KB): 225-610 FLOP per byte, at and above the 295 where
// the bf16 tensor cores (989 TFLOP/s) meet the 3.35 TB/s memory, so the
// products bind it; they are 86-92% of the FLOPs.
//
// Design, a first version (mma.sync, no TMA ring), on the fp32 instance's
// cluster plan:
// 1. Every product is a [64 x KD] . [KD x NB] product on m16n8k16 tiles:
//    the 4 row tiles of 16 tokens over the warps, the NB/8 column tiles
//    over 2 warp columns (1 where NB/8 is odd), fp32 accumulators in
//    registers. A (LN output, heads' output, hidden units) is bf16 in shared
//    memory; W (bf16, [out][in], prepared once by the wrapper) comes by
//    cp.async in slices of 32 k, double-buffered.
// 2. Attention runs in registers, one warp per (head, 16 query rows): the
//    scores of 16 rows x 64 keys (q.k^T on the tensor cores; head_dim 8
//    pads k to 16 with zeros), bias, mask and the row softmax over the
//    quad that holds a row (shuffles), the probabilities rounded to bf16 as
//    the A operand of P.v (the accumulator layout of m16n8 is the operand
//    layout of m16k16), v transposed in shared memory as the B operand. No
//    score buffer.
// 3. One window over a thread-block cluster of K CTAs (K from the wrapper:
//    ops/flash_window_attn.py::cluster_size, the fp32 rules), as the fp32
//    instance: rank r computes the heads [r*NH/K, (r+1)*NH/K) and the output
//    columns [r*C/K, (r+1)*C/K) of proj and of the MLP's second layer (with
//    its share of each step's 64 hidden units); the heads' output, the
//    residual columns and each step's hidden units travel between ranks
//    through distributed shared memory. bf16 halves the operand buffers: the
//    largest CTAs (C = 128 at K = 1, C = 192 at K = 2) take 121-128 KB.
// 4. Results independent of K, bit for bit: each output element is one
//    accumulator that takes the m16n8k16 steps of its k range in ascending
//    order (the MLP's second layer across the hidden steps), the bias added
//    after; the softmax reduces over a fixed quad; every rank runs the same
//    code for the same element whatever K is.
//
// Interface: plain C, raw pointers, the launch stream; returns the launch's
// error (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "window_attn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-5f;
constexpr int kStep = 64;       // hidden units per MLP step, all ranks together
constexpr int kKS = 32;         // W's k per staged slice
constexpr int kLW = kKS + 8;    // staged W row stride (bf16)

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// dst[t][c] = bf16(LN(src[t][c]) * g[c] + b[c]), one warp per token.
template <int C>
__device__ void layer_norm_bf16(const float* src, int lds, bf16* dst, int ldd,
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
      dst[t * ldd + c] = __float2bfloat16_rn(v[i] * rstd * __ldg(g + c) + __ldg(b + c));
    }
  }
}

// The warps' split of a 64 x NB product: warp w takes row tile w % 4 and
// the column tiles j * WN + w / 4 (j < NTW); with WN = 1 warps 4-7 idle.
template <int NB>
struct Split {
  static constexpr int NT = NB / 8;
  static constexpr int WN = NT % 2 == 0 ? 2 : 1;
  static constexpr int NTW = NT / WN;
  static_assert(NB % 8 == 0, "n8 tiles");
};

// acc[j] += sum over k < KD of A[row][k] * W[n][k] for the warp's tiles,
// one m16n8k16 step per 16 k, k ascending. wrow(n, k): the global address of
// W's eight bf16 at local column n and k (16-byte aligned). W comes through
// `stage` (2 x [NB][kLW]) in slices of kKS, the next slice's cp.async in
// flight while one is multiplied. Every thread calls it; it ends with a
// barrier, so the caller may then overwrite A and the stage.
template <int NB, int KD, int LDA, class WRow>
__device__ __forceinline__ void mma_product(float (&acc)[Split<NB>::NTW][4], const bf16* A,
                                            WRow wrow, bf16* stage) {
  using S = Split<NB>;
  constexpr int CHUNKS = NB * kKS / 8;
  constexpr int NS = KD / kKS;
  static_assert(KD % kKS == 0 && LDA % 8 == 0, "slices and aligned rows");
  const int warp = threadIdx.x / 32;
  const int mt = warp % 4, wn = warp / 4;
  auto fetch = [&](int s) {
    if (s < NS) {
      bf16* buf = stage + (s % 2) * NB * kLW;
      for (int q = threadIdx.x; q < CHUNKS; q += kThreads) {
        const int n = q / (kKS / 8), kc = q % (kKS / 8) * 8;
        cp_async16_bf16(buf + n * kLW + kc, wrow(n, s * kKS + kc));
      }
    }
    cp_async_commit_group();
  };
  fetch(0);
  for (int s = 0; s < NS; ++s) {
    cp_async_wait_group<0>();  // slice s has landed (this thread's copies)
    __syncthreads();           // ... everyone's, and everyone is done with slice s - 1
    fetch(s + 1);              // into slice s - 1's buffer
    if (wn < S::WN) {
      const bf16* ws = stage + (s % 2) * NB * kLW;
#pragma unroll
      for (int kk = 0; kk < kKS; kk += 16) {
        uint32_t a[4];
        frag_a(a, A, LDA, mt * 16, s * kKS + kk);
#pragma unroll
        for (int j = 0; j < S::NTW; ++j) {
          uint32_t b[2];
          frag_b(b, ws, kLW, (j * S::WN + wn) * 8, kk);
          mma_bf16(acc[j], a, b);
        }
      }
    }
  }
  __syncthreads();
}

// epi(row, col, v0, v1) for the warp's outputs of mma_product: columns col
// and col + 1 (col even) of the block.
template <int NB, class Epi>
__device__ __forceinline__ void mma_epilogue(const float (&acc)[Split<NB>::NTW][4], Epi epi) {
  using S = Split<NB>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp / 4;
  if (wn >= S::WN) return;
  const int r = (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < S::NTW; ++j) {
    const int n = (j * S::WN + wn) * 8 + 2 * (lane % 4);
    epi(r, n, acc[j][0], acc[j][1]);
    epi(r + 8, n, acc[j][2], acc[j][3]);
  }
}

// One head's attention for 16 query rows (row tile mt), one warp: q and k
// in qk ([token][q | k], stride ldqk, k at column kofs), v in vt
// ([dim][token], stride kT + 8), the bf16 output into o (stride ldo) at the
// head's columns.
template <int HD>
__device__ __forceinline__ void head_attention(const bf16* qk, int ldqk, int kofs, int hofs,
                                               const bf16* vt, const float* __restrict__ rb,
                                               bf16* o, int ldo, int mt, bool last_row,
                                               bool last_col) {
  constexpr int KSTEPS = (HD + 15) / 16;
  constexpr bool HALF = HD % 16 == 8;  // the last k step's upper 8 dims lie past the head
  constexpr int DT = HD / 8;  // n8 tiles of the output
  constexpr int LV = kT + 8;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[j][q] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    uint32_t a[4];
    frag_a(a, qk, ldqk, mt * 16, hofs + ks * 16);
    const bool half = HALF && ks == KSTEPS - 1;
    if (half) a[2] = a[3] = 0u;  // k 8..15 of the step lie past the head: zero products
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t b[2];
      frag_b(b, qk + kofs, ldqk, j * 8, hofs + ks * 16);
      if (half) b[1] = 0u;
      mma_bf16(s[j], a, b);
    }
  }
  // + bias (+ the SW mask), then the softmax of rows p0 and p0 + 8 over the
  // quad that holds each
  float mx[2] = {-3.402823466e38f, -3.402823466e38f};  // -FLT_MAX
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = mt * 16 + g + half * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = j * 8 + 2 * t4;
      const float2 bv = __ldg(reinterpret_cast<const float2*>(rb + p * kT + q));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = s[j][2 * half + e] + (e == 0 ? bv.x : bv.y);
        const int qq = q + e;
        if (last_row && ((p / kWin < kHalf) != (qq / kWin < kHalf))) v += kNegInf;
        if (last_col && ((p % kWin < kHalf) != (qq % kWin < kHalf))) v += kNegInf;
        s[j][2 * half + e] = v;
        mx[half] = fmaxf(mx[half], v);
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = expf(s[j][2 * half + e] - mx[half]);
        s[j][2 * half + e] = v;
        sum[half] += v;
      }
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
    sum[half] = 1.f / sum[half];
  }
  // P . v: the probabilities' accumulator tiles 2kc, 2kc+1 are the A operand
  // of keys 16kc..16kc+15
  float o_acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int q = 0; q < 4; ++q) o_acc[d][q] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t a[4] = {
        pack_bf16(s[2 * kc][0] * sum[0], s[2 * kc][1] * sum[0]),
        pack_bf16(s[2 * kc][2] * sum[1], s[2 * kc][3] * sum[1]),
        pack_bf16(s[2 * kc + 1][0] * sum[0], s[2 * kc + 1][1] * sum[0]),
        pack_bf16(s[2 * kc + 1][2] * sum[1], s[2 * kc + 1][3] * sum[1])};
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      uint32_t b[2];
      frag_b(b, vt, LV, hofs + d * 8, kc * 16);
      mma_bf16(o_acc[d], a, b);
    }
  }
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = hofs + d * 8 + 2 * t4;
    const int p = mt * 16 + g;
    *reinterpret_cast<uint32_t*>(o + p * ldo + c) = pack_bf16(o_acc[d][0], o_acc[d][1]);
    *reinterpret_cast<uint32_t*>(o + (p + 8) * ldo + c) = pack_bf16(o_acc[d][2], o_acc[d][3]);
  }
}

struct SwinArgs {
  const float* x;
  float* out;
  const bf16* wqkv;  // [3C][C], q rows pre-scaled
  const float* bqkv;
  const bf16* wproj;  // [C][C]
  const float *bproj, *ln1s, *ln1b, *relb, *ln2s, *ln2b;
  const bf16* w1;  // [4C][C]
  const float* b1;
  const bf16* w2;  // [C][4C]
  const float* b2;
  int H, W, shifted;
};

// Shared-memory geometry of one CTA of a K-CTA cluster (strides in
// elements, offsets in bytes).
template <int C, int HD, int K>
struct Swin {
  static constexpr int NH = C / HD;
  static constexpr int HK = NH / K;     // heads per rank
  static constexpr int CK = C / K;      // output columns per rank
  static constexpr int QW = 3 * CK;     // qkv columns per rank
  static constexpr int HC = kStep / K;  // hidden units per rank and step
  static constexpr int NBQ = block_cols(QW);
  static constexpr int LX = C + 4;      // xs (fp32)
  static constexpr int LA = C + 8;      // as (bf16)
  static constexpr int LQK = 2 * CK + 8;
  static constexpr int LV = kT + 8;
  static constexpr int LH = kStep + 8;
  static constexpr int LHO = HC + 8;
  static constexpr int NBMAX = cmax(cmax(NBQ, CK), HC);
  static constexpr int XS = 0;
  static constexpr int AS = XS + align16(4 * kT * LX);
  static constexpr int QK = AS + align16(2 * kT * LA);
  static constexpr int VT = QK + align16(2 * kT * LQK);
  static constexpr int ATT_END = VT + align16(2 * CK * LV);
  static constexpr int HS = QK;  // the MLP's buffers over qk and vt
  static constexpr int HO = HS + align16(2 * kT * LH);
  static constexpr int MLP_END = HO + (K > 1 ? 2 * align16(2 * kT * LHO) : 0);
  static constexpr int STAGE = cmax(ATT_END, MLP_END);
  static constexpr int BYTES = STAGE + 2 * 2 * NBMAX * kLW;
  static constexpr int MIN_BLOCKS = blocks_per_sm(BYTES);
  static_assert(C % 32 == 0 && NH * HD == C && NH % K == 0, "heads split evenly over the cluster");
  static_assert(HD % 8 == 0 && CK % 8 == 0 && HC % 8 == 0 && (4 * C) % kStep == 0, "n8 tiles");
  static_assert(CK <= 128 && Split<CK>::NTW <= 8, "proj's and W2's accumulators");
  static_assert(BYTES <= kSmemPerBlock, "shared memory of a block");
};

template <int C, int HD, int K>
__global__ void __launch_bounds__(kThreads, (Swin<C, HD, K>::MIN_BLOCKS))
    swin_block_bf16_kernel(const SwinArgs p) {
  using G = Swin<C, HD, K>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + G::XS);  // [T][LX] the residual stream
  bf16* as = reinterpret_cast<bf16*>(smem + G::AS);    // [T][LA] LN1 out, heads' out, LN2 out
  bf16* qk = reinterpret_cast<bf16*>(smem + G::QK);    // [T][LQK] this rank's q | k
  bf16* vt = reinterpret_cast<bf16*>(smem + G::VT);    // [CK][LV] this rank's v, transposed
  bf16* hs = reinterpret_cast<bf16*>(smem + G::HS);    // [T][LH] one step's hidden units
  bf16* ho = reinterpret_cast<bf16*>(smem + G::HO);    // (K > 1) 2 x [T][LHO] this rank's units
  bf16* stage = reinterpret_cast<bf16*>(smem + G::STAGE);

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
  layer_norm_bf16<C>(xs, G::LX, as, G::LA, p.ln1s, p.ln1b);
  __syncthreads();

  // qkv of this rank's heads: local column m lies in segment m / CK (q, k or
  // v) and is global column (m / CK) * C + cbase + m % CK.
  for (int nb0 = 0; nb0 < G::QW; nb0 += G::NBQ) {
    auto col = [&](int n) { return (nb0 + n) / G::CK * C + cbase + (nb0 + n) % G::CK; };
    float acc[Split<G::NBQ>::NTW][4] = {};
    mma_product<G::NBQ, C, G::LA>(
        acc, as, [&](int n, int k) { return p.wqkv + static_cast<size_t>(col(n)) * C + k; },
        stage);
    mma_epilogue<G::NBQ>(acc, [&](int t, int n, float v0, float v1) {
      const int m = nb0 + n;  // m and m + 1 lie in one segment (CK is even)
      const int gc = col(n);
      v0 += __ldg(p.bqkv + gc);
      v1 += __ldg(p.bqkv + gc + 1);
      if (m < 2 * G::CK) {
        *reinterpret_cast<uint32_t*>(qk + t * G::LQK + m) = pack_bf16(v0, v1);
      } else {
        vt[(m - 2 * G::CK) * G::LV + t] = __float2bfloat16_rn(v0);
        vt[(m - 2 * G::CK + 1) * G::LV + t] = __float2bfloat16_rn(v1);
      }
    });
  }
  __syncthreads();

  // attention, one warp per (head, 16 query rows); each head's output lands
  // in `as` at its global columns
  const bool last_row = p.shifted && wy == nwh - 1;
  const bool last_col = p.shifted && wx == nww - 1;
  for (int task = threadIdx.x / 32; task < 4 * G::HK; task += kWarps) {
    const int hl = task / 4;
    const int h = rank * G::HK + hl;
    head_attention<HD>(qk, G::LQK, G::CK, hl * HD, vt, p.relb + static_cast<size_t>(h) * kT * kT,
                       as + cbase, G::LA, task % 4, last_row, last_col);
  }
  if constexpr (K > 1) {
    // every rank's heads are in: gather the other ranks' column blocks
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    constexpr int PER = kT * G::CK / 8;  // 16-byte chunks per rank
    for (int i = threadIdx.x; i < K * PER; i += kThreads) {
      const int r = i / PER;
      if (r == rank) continue;
      const int t = i % PER / (G::CK / 8);
      const int c = r * G::CK + i % (G::CK / 8) * 8;
      const bf16* src = cluster.map_shared_rank(as, r);
      *reinterpret_cast<uint4*>(as + t * G::LA + c) =
          *reinterpret_cast<const uint4*>(src + t * G::LA + c);
    }
  }
  __syncthreads();

  {  // x[:, own columns] += o . Wproj + bproj
    float acc[Split<G::CK>::NTW][4] = {};
    mma_product<G::CK, C, G::LA>(
        acc, as, [&](int n, int k) { return p.wproj + static_cast<size_t>(cbase + n) * C + k; },
        stage);
    mma_epilogue<G::CK>(acc, [&](int t, int n, float v0, float v1) {
      const int c = cbase + n;
      xs[t * G::LX + c] += v0 + __ldg(p.bproj + c);
      xs[t * G::LX + c + 1] += v1 + __ldg(p.bproj + c + 1);
    });
  }
  if constexpr (K > 1) {
    // every rank's new columns are in, and every rank is done reading `as`
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
  layer_norm_bf16<C>(xs, G::LX, as, G::LA, p.ln2s, p.ln2b);
  __syncthreads();

  // MLP in steps of kStep hidden units: each rank computes HC of them, the
  // step's units are gathered in ascending order, and the second layer's
  // accumulators (acc2) run on over all 4C units.
  float acc2[Split<G::CK>::NTW][4] = {};
  for (int s = 0; s < 4 * C / kStep; ++s) {
    const int u0 = s * kStep + rank * G::HC;  // this rank's first hidden unit of the step
    constexpr int LHD = K == 1 ? G::LH : G::LHO;
    bf16* hd = K == 1 ? hs : ho + (s & 1) * kT * G::LHO;
    {
      float acc[Split<G::HC>::NTW][4] = {};
      mma_product<G::HC, C, G::LA>(
          acc, as, [&](int n, int k) { return p.w1 + static_cast<size_t>(u0 + n) * C + k; },
          stage);
      mma_epilogue<G::HC>(acc, [&](int t, int n, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(hd + t * LHD + n) =
            pack_bf16(gelu(v0 + __ldg(p.b1 + u0 + n)), gelu(v1 + __ldg(p.b1 + u0 + n + 1)));
      });
    }
    if constexpr (K > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      constexpr int PER = kT * G::HC / 8;
      for (int i = threadIdx.x; i < K * PER; i += kThreads) {
        const int r = i / PER;
        const int t = i % PER / (G::HC / 8);
        const int c = i % (G::HC / 8) * 8;
        const bf16* src = cluster.map_shared_rank(hd, r);
        *reinterpret_cast<uint4*>(hs + t * G::LH + r * G::HC + c) =
            *reinterpret_cast<const uint4*>(src + t * G::LHO + c);
      }
    }
    __syncthreads();
    mma_product<G::CK, kStep, G::LH>(
        acc2, hs,
        [&](int n, int k) {
          return p.w2 + static_cast<size_t>(cbase + n) * 4 * C + s * kStep + k;
        },
        stage);
  }
  mma_epilogue<G::CK>(acc2, [&](int t, int n, float v0, float v1) {
    const int c = cbase + n;
    float2 v;
    v.x = xs[t * G::LX + c] + (v0 + __ldg(p.b2 + c));
    v.y = xs[t * G::LX + c + 1] + (v1 + __ldg(p.b2 + c + 1));
    *reinterpret_cast<float2*>(p.out + gofs(t, c)) = v;
  });
  if constexpr (K > 1) cg::this_cluster().sync();  // peers may still read this rank's units
}

template <int C, int HD, int K>
cudaError_t launch_swin(const SwinArgs& a, int B, cudaStream_t stream) {
  using G = Swin<C, HD, K>;
  cudaError_t e = cudaFuncSetAttribute(swin_block_bf16_kernel<C, HD, K>,
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
  e = cudaLaunchKernelEx(&cfg, swin_block_bf16_kernel<C, HD, K>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Shared-memory geometry of one CTA of the attention-only flavour (strides
// in elements, offsets in bytes).
template <int C, int HD, int K>
struct Attn {
  static constexpr int NH = C / HD;
  static constexpr int HK = NH / K;  // heads per rank
  static constexpr int CK = C / K;   // output columns per rank
  static constexpr int QW = 3 * CK;  // qkv columns per rank
  static constexpr int NBQ = block_cols(QW);
  static constexpr int NBP = block_cols(CK);  // proj's column blocks
  static constexpr int LA = C + 8;   // as (bf16)
  static constexpr int LQK = 2 * CK + 8;
  static constexpr int LV = kT + 8;
  static constexpr int NBMAX = cmax(NBQ, NBP);
  static constexpr int AS = 0;
  static constexpr int QK = AS + align16(2 * kT * LA);
  static constexpr int VT = QK + align16(2 * kT * LQK);
  static constexpr int STAGE = VT + align16(2 * CK * LV);
  static constexpr int BYTES = STAGE + 2 * 2 * NBMAX * kLW;
  static constexpr int MIN_BLOCKS = blocks_per_sm(BYTES);
  static_assert(C % 32 == 0 && NH * HD == C && NH % K == 0, "heads split evenly over the cluster");
  static_assert(HD % 8 == 0 && CK % 8 == 0, "n8 tiles");
  static_assert(Split<NBQ>::NTW <= 8 && Split<NBP>::NTW <= 8, "accumulators");
  static_assert(BYTES <= kSmemPerBlock, "shared memory of a block");
};

// out = x + bf16(attn(x)) . bf16(Wproj) + bproj over one 8x8 window per
// cluster of K CTAs: rank r computes the heads [r*NH/K, (r+1)*NH/K) and the
// output columns [r*C/K, (r+1)*C/K), the heads' output gathered through
// distributed shared memory, as swin_block_bf16_kernel without LN and MLP.
template <int C, int HD, int K>
__global__ void __launch_bounds__(kThreads, (Attn<C, HD, K>::MIN_BLOCKS))
    attn_block_bf16_kernel(const SwinArgs p) {
  using G = Attn<C, HD, K>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem + G::AS);  // [T][LA] bf16(x), then the heads' out
  bf16* qk = reinterpret_cast<bf16*>(smem + G::QK);  // [T][LQK] this rank's q | k
  bf16* vt = reinterpret_cast<bf16*>(smem + G::VT);  // [CK][LV] this rank's v, transposed
  bf16* stage = reinterpret_cast<bf16*>(smem + G::STAGE);

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
    const float4 v = __ldg(reinterpret_cast<const float4*>(p.x + gofs(t, c)));
    uint2 packed;
    packed.x = pack_bf16(v.x, v.y);
    packed.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(as + t * G::LA + c) = packed;
  }
  __syncthreads();

  // qkv of this rank's heads: local column m lies in segment m / CK (q, k or
  // v) and is global column (m / CK) * C + cbase + m % CK.
  for (int nb0 = 0; nb0 < G::QW; nb0 += G::NBQ) {
    auto col = [&](int n) { return (nb0 + n) / G::CK * C + cbase + (nb0 + n) % G::CK; };
    float acc[Split<G::NBQ>::NTW][4] = {};
    mma_product<G::NBQ, C, G::LA>(
        acc, as, [&](int n, int k) { return p.wqkv + static_cast<size_t>(col(n)) * C + k; },
        stage);
    mma_epilogue<G::NBQ>(acc, [&](int t, int n, float v0, float v1) {
      const int m = nb0 + n;  // m and m + 1 lie in one segment (CK is even)
      const int gc = col(n);
      v0 += __ldg(p.bqkv + gc);
      v1 += __ldg(p.bqkv + gc + 1);
      if (m < 2 * G::CK) {
        *reinterpret_cast<uint32_t*>(qk + t * G::LQK + m) = pack_bf16(v0, v1);
      } else {
        vt[(m - 2 * G::CK) * G::LV + t] = __float2bfloat16_rn(v0);
        vt[(m - 2 * G::CK + 1) * G::LV + t] = __float2bfloat16_rn(v1);
      }
    });
  }
  __syncthreads();

  // attention, one warp per (head, 16 query rows); each head's output lands
  // in `as` (bf16(x) is no longer read) at its global columns
  const bool last_row = p.shifted && wy == nwh - 1;
  const bool last_col = p.shifted && wx == nww - 1;
  for (int task = threadIdx.x / 32; task < 4 * G::HK; task += kWarps) {
    const int hl = task / 4;
    const int h = rank * G::HK + hl;
    head_attention<HD>(qk, G::LQK, G::CK, hl * HD, vt, p.relb + static_cast<size_t>(h) * kT * kT,
                       as + cbase, G::LA, task % 4, last_row, last_col);
  }
  if constexpr (K > 1) {
    // every rank's heads are in: gather the other ranks' column blocks, then
    // wait until every rank has read this one's
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    constexpr int PER = kT * G::CK / 8;  // 16-byte chunks per rank
    for (int i = threadIdx.x; i < K * PER; i += kThreads) {
      const int r = i / PER;
      if (r == rank) continue;
      const int t = i % PER / (G::CK / 8);
      const int c = r * G::CK + i % (G::CK / 8) * 8;
      const bf16* src = cluster.map_shared_rank(as, r);
      *reinterpret_cast<uint4*>(as + t * G::LA + c) =
          *reinterpret_cast<const uint4*>(src + t * G::LA + c);
    }
    cluster.sync();
  } else {
    __syncthreads();
  }

  // out[:, own columns] = x + (o . Wproj + bproj), x read again from memory
  for (int nb0 = 0; nb0 < G::CK; nb0 += G::NBP) {
    float acc[Split<G::NBP>::NTW][4] = {};
    mma_product<G::NBP, C, G::LA>(
        acc, as,
        [&](int n, int k) { return p.wproj + static_cast<size_t>(cbase + nb0 + n) * C + k; },
        stage);
    mma_epilogue<G::NBP>(acc, [&](int t, int n, float v0, float v1) {
      const int c = cbase + nb0 + n;
      const size_t o = gofs(t, c);
      const float2 xv = __ldg(reinterpret_cast<const float2*>(p.x + o));
      float2 v;
      v.x = xv.x + (v0 + __ldg(p.bproj + c));
      v.y = xv.y + (v1 + __ldg(p.bproj + c + 1));
      *reinterpret_cast<float2*>(p.out + o) = v;
    });
  }
}

template <int C, int HD, int K>
cudaError_t launch_attn(const SwinArgs& a, int B, cudaStream_t stream) {
  using G = Attn<C, HD, K>;
  cudaError_t e = cudaFuncSetAttribute(attn_block_bf16_kernel<C, HD, K>,
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
  e = cudaLaunchKernelEx(&cfg, attn_block_bf16_kernel<C, HD, K>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Instances (C, head_dim, K) of the attention-only flavour: every cluster of
// ops/flash_window_attn.py::ATTN_CLUSTERS for each (C, head_dim) of
// KERNEL_SHAPES_ATTN, as the fp32 instance's ATTN_INSTANCES.
#define ATTN_BF16_INSTANCES(X) \
  X(128, 16, 1) X(128, 16, 2) X(128, 16, 4) X(192, 24, 1) X(192, 24, 2) X(192, 24, 4)

// Instances (C, head_dim, K): the fp32 instance's (flash_window_attn.cu
// SWIN_INSTANCES), the smallest cluster (ops/flash_window_attn.py::
// min_cluster) and the largest (max_cluster) for each (C, head_dim).
#define SWIN_BF16_INSTANCES(X)                                                             \
  X(64, 8, 1) X(64, 8, 8) X(64, 16, 1) X(64, 16, 4) X(64, 32, 1) X(64, 32, 2) X(96, 8, 1)  \
  X(96, 8, 4) X(96, 16, 1) X(96, 16, 2) X(96, 32, 1) X(128, 8, 1) X(128, 8, 8)             \
  X(128, 16, 1) X(128, 16, 8) X(128, 32, 1) X(128, 32, 4) X(192, 8, 2) X(192, 8, 8)        \
  X(192, 16, 2) X(192, 16, 4) X(192, 32, 2)

}  // namespace

extern "C" {

// x, out: [B][H][W][C] float32 (H, W multiples of 8; C 64, 96, 128 or 192;
// head_dim 8, 16 or 32), 16-byte aligned. wqkv: [3C][C] bf16 with the q rows
// pre-scaled; wproj: [C][C]; w1: [4C][C]; w2: [C][4C] (all bf16 [out][in]);
// bqkv: [3C] with the q entries pre-scaled; relb: [C/head_dim][64][64];
// ln*, bproj, b2: [C]; b1: [4C] (float32). cluster: CTAs per window, one of
// SWIN_BF16_INSTANCES' K for (C, head_dim); the result does not depend on it.
int flash_window_block_bf16(const float* x, float* out, const bf16* wqkv, const float* bqkv,
                            const bf16* wproj, const float* bproj, const float* ln1s,
                            const float* ln1b, const float* relb, const float* ln2s,
                            const float* ln2b, const bf16* w1, const float* b1, const bf16* w2,
                            const float* b2, int B, int H, int W, int C, int head_dim,
                            int cluster, int shifted, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % kWin != 0 || W % kWin != 0 || B <= 0) return cudaErrorInvalidValue;
  const SwinArgs a{x,    out,  wqkv, bqkv, wproj, bproj, ln1s, ln1b, relb,
                   ln2s, ln2b, w1,   b1,   w2,    b2,    H,    W,    shifted};
#define SWIN_CASE(c, hd, k) \
  if (C == c && head_dim == hd && cluster == k) return launch_swin<c, hd, k>(a, B, s);
  SWIN_BF16_INSTANCES(SWIN_CASE)
#undef SWIN_CASE
  return cudaErrorInvalidValue;
}

// The attention-only flavour (no LN1, no MLP): out = x + bf16(attn(x)) .
// bf16(Wproj) + bproj. x, out: [B][H][W][C] float32 (H, W multiples of 8;
// C 128 with head_dim 16 or C 192 with head_dim 24), 16-byte aligned.
// wqkv: [3C][C] bf16 with the q rows pre-scaled; wproj: [C][C] bf16 (both
// [out][in]); bqkv: [3C] with the q entries pre-scaled; bproj: [C]; relb:
// [C/head_dim][64][64] (float32). cluster: CTAs per window, one of
// ATTN_BF16_INSTANCES' K for (C, head_dim); the result does not depend on it.
int window_attention_block_bf16(const float* x, float* out, const bf16* wqkv,
                                const float* bqkv, const bf16* wproj, const float* bproj,
                                const float* relb, int B, int H, int W, int C, int head_dim,
                                int cluster, int shifted, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % kWin != 0 || W % kWin != 0 || B <= 0) return cudaErrorInvalidValue;
  const SwinArgs a{x,       out,     wqkv,    bqkv,    wproj,   bproj,   nullptr, nullptr, relb,
                   nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, H,       W,       shifted};
#define ATTN_CASE(c, hd, k) \
  if (C == c && head_dim == hd && cluster == k) return launch_attn<c, hd, k>(a, B, s);
  ATTN_BF16_INSTANCES(ATTN_CASE)
#undef ATTN_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
