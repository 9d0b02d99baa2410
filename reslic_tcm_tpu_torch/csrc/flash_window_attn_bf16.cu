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
// What bounds it on this card: per window about 2*T*(12*C^2 + 2*T*C) FLOP
// (7.3 MFLOP at C = 64, 27 at C = 128, 60 at C = 192) against 2*T*C*4 bytes
// in and out (32-96 KB): 225-610 FLOP per byte, at and above the 295 where
// the bf16 tensor cores (989 TFLOP/s) meet the 3.35 TB/s memory, so the
// products bind it; the four linear products are 86-92% of the FLOPs.
// Inside the chip the weights bind next: a window streams all of them
// (864 KB at C = 192) for its 64 rows.
//
// LN+MLP flavour (swin_block_bf16_kernel<C, HD, K, G>); the first version
// (one window a CTA, mma.sync, W in slices of 32 k by cp.async behind a block
// barrier, two buffers) ran at 4.5-5.6% of the bf16 bound, its tensor cores
// idle most of the time (products 8% of it, W's staging 23%, the MLP 58%).
// This design:
// 1. G windows a CTA (G = 1 or 2, ops/flash_window_attn.py::window_group),
//    one warpgroup each: every linear product is one wgmma m64nNk16 chain
//    (a window's 64 tokens are one warpgroup's M), fp32 accumulators in
//    registers, so each staged W tile feeds G windows' products. Two CTAs
//    share an SM where G windows' buffers and two stages fit half of it.
// 2. W (bf16, prepared once by the wrapper as [k/8][out][8], wqkv's rows
//    head by head as q | k | v) streams by the copy engine (cp.async.bulk)
//    through a ring of stages of 32 or 64 k (2, or up to 6 with one CTA an
//    SM) with full and empty mbarriers, in one fixed sequence of stages
//    (each head group's qkv, proj, then W1 and W2 per MLP step); thread 0
//    refills a slot once every warpgroup released it, so the next product's
//    W is in flight while a warpgroup runs LN, the softmax or GELU. x comes
//    the same way. LN reduces 4 tokens a warp at a time.
// 3. Attention per head group (at most 64 channels: its q | k | v product
//    at most 192 wide), one warp per (head, 16 query rows), in registers on
//    mma.sync m16n8k16 (about 5-17% of the FLOPs): the scores of 16 rows x
//    64 keys, bias (loaded a head ahead), mask and the row softmax over the
//    quad that holds a row (shuffles), the probabilities rounded to bf16 as
//    the A operand of P.v.
// 4. Operands in shared memory as [n/8][64][8] bf16 (csrc/hopper_wgmma.cuh),
//    k-groups 1040 bytes apart: the layout wgmma reads without swizzle, and
//    bank-conflict free for the fragment loads and epilogue stores. x, then
//    the heads' output and the group's q | k | v, then x1, then the MLP's
//    hidden units share one region per window; x1 also goes to `out`, from
//    which the last epilogue reads it back.
// 5. A window over a thread-block cluster of K CTAs (K from the wrapper:
//    cluster_size, the fp32 rules), as the fp32 instance: rank r computes the
//    heads [r*NH/K, (r+1)*NH/K) and the output columns [r*C/K, (r+1)*C/K) of
//    proj and of the MLP's second layer (with its share of each step's 256
//    hidden units, 128 at K = 1 or C = 96, 64 when lean); the heads' output,
//    the x1 columns and each step's hidden units travel between ranks
//    through distributed shared memory.
// 6. Results independent of K and G, bit for bit: each output element is
//    one accumulator that takes the k16 steps of its k range in ascending
//    order (the MLP's second layer across the hidden steps), the bias added
//    after; LN and the softmax reduce in a fixed order; every rank and
//    warpgroup runs the same code for the same element whatever K and G are.
//    On an H100 they are also the first version's bits (its m16n8k16 steps
//    sum the same products in the same order): equal digests at every
//    main-path shape (tools/bf16_redesign/compare.py).
//
// The attention-only flavour (with_ln=False, mlp=None: WACNN's
// WinBasedAttention at (C, head_dim) = (128, 16) and (192, 24)) is
// attn_block_bf16_kernel<C, HD, K>, still the first version: x + bf16(o) .
// bf16(Wproj) + bproj with qkv = bf16(x) . bf16(Wqkv) + bqkv, the same cast
// points (the Pallas body's flash_window_attn.py:93, :173, :183, :195), one
// window per cluster of K CTAs, mma.sync, W ([out][in] bf16) staged by
// cp.async in slices of 32 k. Its residual x is read again from global
// memory in proj's epilogue, so shared memory holds only bf16(x) (later the
// heads' output), q | k, v^T and the staged W: 119 KB at C = 192, K = 1.
// head_dim 24 is not a multiple of m16n8k16's k: q.k^T takes a second step
// over dims 16..31 whose upper half (24..31, past the head) is zeroed in
// registers, as head_dim 8 zeroes 8..15; P.v takes three n8 tiles.
//
// Interface: plain C, raw pointers, the launch stream; returns the launch's
// error (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper_wgmma.cuh"
#include "window_attn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-5f;
constexpr int kKS = 32;         // W's k per staged slice (attention-only)
constexpr int kLW = kKS + 8;    // staged W row stride (bf16)

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

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

// ------------------- LN+MLP flavour: wgmma, several windows a CTA -------------------

constexpr int kLA = kT * 8 + 8;          // k-group stride (bf16) of a [64 x n] operand: [n/8][64][8]
constexpr int kSmemDyn = 232448 - 1024;  // a block's dynamic shared memory, with a margin

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// Channels of one head group: the largest multiple of HD that divides CK and
// is at most cap (its q | k | v product is then at most 3 * cap wide).
__host__ __device__ constexpr int group_width(int ck, int hd, int cap) {
  int g = cap / hd * hd;
  while (g > hd && ck % g != 0) g -= hd;
  return g;
}

// Element (row, col) of a [64 x n] operand in shared memory.
__device__ __forceinline__ int al(int row, int col) { return (col / 8) * kLA + row * 8 + col % 8; }

// Shared-memory geometry (bytes) and stage sequence of one CTA: G windows,
// each 1/K of it on this CTA (rank r of a cluster of K).
template <int C, int HD, int K, int G>
struct SwinWG {
  static constexpr int NH = C / HD;
  static constexpr int HK = NH / K;            // heads per rank
  static constexpr int CK = C / K;             // output columns per rank
  // two windows at C <= 96 run two CTAs an SM (128 registers a thread):
  // head groups of at most 32 channels and MLP steps of 64 units keep
  // their accumulators within it
  static constexpr bool LEAN = G == 2 && C <= 96;
  static constexpr int GW = group_width(CK, HD, LEAN ? 32 : 64);
  static constexpr int GH = GW / HD;           // heads per group
  static constexpr int NG = CK / GW;           // head groups per rank
  // hidden units per MLP step, all ranks together, and per rank: larger
  // steps where the cluster is wide (fewer exchanges), each rank's share at
  // most 128 (its accumulators), 64 when lean
  static constexpr int STEPU = K >= 2 && (4 * C) % 256 == 0 ? 256 : LEAN ? 64 : 128;
  static constexpr int HSK = STEPU / K;
  static constexpr int NMAX = cmax(cmax(3 * GW, CK), HSK);
  static constexpr int LX = C + 4;             // x, x1 rows (fp32)
  // per window: R1 = x then x1 (fp32 [64][LX]) | the heads' output O, this
  // group's q | k and v^T | the MLP step's hidden units H (and, K > 1, this
  // rank's share of them, double-buffered); then A, the LN outputs
  static constexpr int O_ = 0;
  static constexpr int QK_ = O_ + C / 8 * kLA * 2;
  static constexpr int V_ = QK_ + 2 * GW / 8 * kLA * 2;
  static constexpr int ATT_END = V_ + 8 * GW * 16;  // v: [64/8][GW][8 tokens]
  static constexpr int H_ = 0;
  static constexpr int HO_ = H_ + STEPU / 8 * kLA * 2;
  static constexpr int MLP_END = HO_ + (K > 1 ? 2 * (HSK / 8) * kLA * 2 : 0);
  static constexpr int R1 = align128(cmax(cmax(kT * LX * 4, ATT_END), MLP_END));
  static constexpr int A_ = R1;
  static constexpr int WIN = R1 + align128(C / 8 * kLA * 2);
  static constexpr int RING = G * WIN;
  // two CTAs an SM where G windows and two stages of 32 k fit half of its
  // shared memory; else one CTA, stages of 64 k (32 at C = 96), up to 6
  static constexpr int HALF_SM = kSmemPerSM / 2 - kSmemReserved;
  static constexpr bool TWO = RING + 2 * 32 * NMAX * 2 <= HALF_SM;
  static constexpr int MIN_BLOCKS = TWO ? 2 : 1;
  static constexpr int KC = TWO || C % 64 != 0 ? 32 : 64;  // k per ring stage
  static constexpr int SLOT = KC * NMAX * 2;
  static constexpr int FIT = ((TWO ? HALF_SM : kSmemDyn) - RING) / SLOT;
  static constexpr int STAGES = TWO ? 2 : (FIT > 6 ? 6 : FIT);
  static constexpr int BYTES = RING + STAGES * SLOT;
  // the stage sequence: each head group's qkv (C / KC stages), proj (C /
  // KC), then per MLP step W1 (C / KC) and W2 (STEPU / KC)
  static constexpr int CST = C / KC;
  static constexpr int W2ST = STEPU / KC;
  static constexpr int Q_PROJ = NG * CST;
  static constexpr int Q_MLP = Q_PROJ + CST;
  static constexpr int STEP = CST + W2ST;
  static constexpr int NQ = Q_MLP + 4 * C / STEPU * STEP;
  static_assert(C % 32 == 0 && NH * HD == C && NH % K == 0 && CK % GW == 0, "heads split evenly");
  static_assert(GW % HD == 0 && 3 * GW <= 192 && HSK % 8 == 0 && CK % 8 == 0, "wgmma widths");
  static_assert(C % KC == 0 && (4 * C) % STEPU == 0 && HSK <= 128, "stages");
  static_assert(BYTES <= kSmemDyn && STAGES >= 2, "shared memory of a block");
};

// dst = bf16(LN(src) * g + b) for the window's 64 tokens (src fp32 rows of
// stride LX): the warpgroup's 4 warps 16 tokens each, 4 at a time so that
// their reductions' shuffles overlap. Each token's sums run in the same
// order whichever warp takes it.
template <int C, int LX>
__device__ void ln_window(const float* src, bf16* dst, const float* __restrict__ g,
                          const float* __restrict__ b) {
  constexpr int PER = C / 32, NT = 4;
  const int lane = threadIdx.x % 32;
  const int t0 = threadIdx.x % 128 / 32 * (kT / 4);
  for (int tb = t0; tb < t0 + kT / 4; tb += NT) {
    float v[NT][PER], m[NT];
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      m[k] = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        v[k][i] = src[(tb + k) * LX + lane + 32 * i];
        m[k] += v[k][i];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < NT; ++k) m[k] += __shfl_xor_sync(0xffffffffu, m[k], o);
    float q[NT];
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      m[k] /= C;
      q[k] = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        v[k][i] -= m[k];
        q[k] += v[k][i] * v[k][i];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < NT; ++k) q[k] += __shfl_xor_sync(0xffffffffu, q[k], o);
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const float rstd = rsqrtf(q[k] / C + kEps);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        dst[al(tb + k, c)] = __float2bfloat16_rn(v[k][i] * rstd * __ldg(g + c) + __ldg(b + c));
      }
    }
  }
}

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

// One head's attention for 16 query rows (row tile mt), one warp: q and k in
// qk (a [64 x 2GW] operand, k from column GW), v in v ([64/8][GW][8]), the
// head's dims from column hofs; the bf16 output into o (a [64 x C] operand)
// at columns ocol..ocol+HD-1.
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

template <int HD, int GW>
__device__ __forceinline__ void head_attention_wg(const bf16* qk, const bf16* v, int hofs,
                                                  const float2 (&bias)[2][8], bf16* o, int ocol,
                                                  int mt, bool last_row, bool last_col) {
  constexpr int KSTEPS = (HD + 15) / 16;
  constexpr bool HALF = HD % 16 == 8;  // the last k step's upper 8 dims lie past the head
  constexpr int DT = HD / 8;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) s[j][q] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const bool half = HALF && ks == KSTEPS - 1;  // k 8..15 of the step: zero products
    const int c0 = hofs + ks * 16;
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
      mma_bf16(s[j], a, b);
    }
  }
  float mx[2] = {-3.402823466e38f, -3.402823466e38f};  // -FLT_MAX
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int p = mt * 16 + g + hf * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = j * 8 + 2 * t4;
      const float2 bv = bias[hf][j];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float val = s[j][2 * hf + e] + (e == 0 ? bv.x : bv.y);
        const int qq = q + e;
        if (last_row && ((p / kWin < kHalf) != (qq / kWin < kHalf))) val += kNegInf;
        if (last_col && ((p % kWin < kHalf) != (qq % kWin < kHalf))) val += kNegInf;
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
    sum[hf] = 1.f / sum[hf];
  }
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
      const bf16* pb = v + (2 * kc * GW + hofs + d * 8 + g) * 8 + 2 * t4;
      const uint32_t b[2] = {ld_u32(pb), ld_u32(pb + GW * 8)};
      mma_bf16(o_acc[d], a, b);
    }
  }
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = ocol + d * 8 + 2 * t4;
    const int p = mt * 16 + g;
    *reinterpret_cast<uint32_t*>(o + al(p, c)) = pack_bf16(o_acc[d][0], o_acc[d][1]);
    *reinterpret_cast<uint32_t*>(o + al(p + 8, c)) = pack_bf16(o_acc[d][2], o_acc[d][3]);
  }
}

// The W ring of one CTA: STAGES slots, full (the copy engine's bytes) and
// empty (one arrival per consumer warpgroup) mbarriers. Thread 0 issues
// every stage, in the order of the stage sequence, and refills a slot as
// soon as every warpgroup has released it.
template <int C, int HD, int K, int G>
struct SwinPipe {
  using S = SwinWG<C, HD, K, G>;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  const bf16 *wqkv, *wproj, *w1, *w2;
  int rank;

  // Stage q: KC / 8 k-groups of rows row0..row0+n-1 of a [k/8][ld][8] matrix.
  __device__ __forceinline__ void issue(int q) const {
    const bf16* base;
    int ld, row0, n, kg0;
    if (q < S::Q_PROJ) {  // head group q / CST's q | k | v rows (wqkv's rows run head by head)
      base = wqkv, ld = 3 * C, n = 3 * S::GW;
      row0 = (rank * S::HK + q / S::CST * S::GH) * 3 * HD;
      kg0 = q % S::CST * S::KC / 8;
    } else if (q < S::Q_MLP) {
      base = wproj, ld = C, n = S::CK, row0 = rank * S::CK;
      kg0 = (q - S::Q_PROJ) * S::KC / 8;
    } else {
      const int step = (q - S::Q_MLP) / S::STEP, i = (q - S::Q_MLP) % S::STEP;
      if (i < S::CST) {  // W1: this rank's hidden units of the step
        base = w1, ld = 4 * C, n = S::HSK, row0 = step * S::STEPU + rank * S::HSK;
        kg0 = i * S::KC / 8;
      } else {  // W2: this rank's output columns, the step's hidden units as k
        base = w2, ld = C, n = S::CK, row0 = rank * S::CK;
        kg0 = (step * S::STEPU + (i - S::CST) * S::KC) / 8;
      }
    }
    const int slot = q % S::STAGES;
    unsigned char* dst = ring + slot * S::SLOT;
    mbar_expect_tx(&full[slot], S::KC / 8 * n * 16);
#pragma unroll
    for (int i = 0; i < S::KC / 8; ++i)
      bulk_copy(dst + i * n * 16, base + (static_cast<size_t>(kg0 + i) * ld + row0) * 8, n * 16,
                &full[slot]);
  }

  // The warpgroup is done with stage q.
  __device__ __forceinline__ void release(int q) const {
    const int slot = q % S::STAGES;
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[slot]);
    if (threadIdx.x == 0 && q + S::STAGES < S::NQ) {
      mbar_wait(&empty[slot], (q / S::STAGES) & 1);
      issue(q + S::STAGES);
    }
    __syncwarp();
  }

  // acc += A . W^T over stages q0..q0+NST-1 (N columns, KC k each; A a
  // [64 x NST*KC] operand), one k16 step at a time, k ascending. Ends with
  // the warpgroup's barrier (bar_id), every product done.
  template <int N, int NST>
  __device__ __forceinline__ void product(float (&acc)[N / 2], const bf16* A, int q0,
                                          int bar_id) const {
    wg_hold(acc);
    for (int i = 0; i < NST; ++i) {
      const int q = q0 + i;
      const int slot = q % S::STAGES;
      mbar_wait(&full[slot], (q / S::STAGES) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < S::KC / 16; ++kk) {
        const uint64_t da = wg_desc(A + (i * S::KC / 8 + 2 * kk) * kLA, kLA * 2, 128);
        const uint64_t db = wg_desc(ring + slot * S::SLOT + kk * 2 * N * 16, N * 16, 128);
        wgmma_bf16<N>(acc, da, db);
      }
      wg_commit();
      if (i > 0) {
        wg_wait<1>();
        release(q - 1);
      }
    }
    wg_wait<0>();
    wg_hold(acc);
    release(q0 + NST - 1);
    named_sync(bar_id, 128);
  }
};

// One Swin sub-block (LN1 -> qkv -> attention -> proj -> LN2 -> MLP) over G
// windows per CTA (one consumer warpgroup each), each window split over a
// cluster of K CTAs (rank r: heads [r*NH/K, (r+1)*NH/K), output columns
// [r*C/K, (r+1)*C/K), its share of each MLP step's hidden units).
template <int C, int HD, int K, int G>
__global__ void __launch_bounds__(128 * G, (SwinWG<C, HD, K, G>::MIN_BLOCKS))
    swin_block_bf16_kernel(const SwinArgs p) {
  using S = SwinWG<C, HD, K, G>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[S::STAGES], empty[S::STAGES], xbar[G];

  const int tid = threadIdx.x;
  const int w = tid / 128;  // this warpgroup's window of the CTA
  const int bar_id = 1 + w;
  const int rank = K == 1 ? 0 : static_cast<int>(cg::this_cluster().block_rank());
  const int nww = p.W / kWin, nwh = p.H / kWin;
  const int nwin = nww * nwh;
  int win = blockIdx.x / K * G + w;
  const bool valid = win < nwin;  // a last CTA's spare warpgroup redoes the last window, unstored
  if (!valid) win = nwin - 1;
  const int wy = win / nww, wx = win % nww;
  const size_t img = static_cast<size_t>(blockIdx.y) * p.H * p.W * C;
  auto gofs = [&](int t, int c) {
    return img + (static_cast<size_t>(wy * kWin + t / kWin) * p.W + wx * kWin + t % kWin) * C + c;
  };
  const int cbase = rank * S::CK;

  unsigned char* mine = smem + w * S::WIN;
  float* xs = reinterpret_cast<float*>(mine);                  // [64][LX] x, then x1
  bf16* os = reinterpret_cast<bf16*>(mine + S::O_);            // heads' output
  bf16* qk = reinterpret_cast<bf16*>(mine + S::QK_);           // the group's q | k
  bf16* vs = reinterpret_cast<bf16*>(mine + S::V_);            // the group's v
  bf16* hs = reinterpret_cast<bf16*>(mine + S::H_);            // the step's hidden units
  bf16* ho = reinterpret_cast<bf16*>(mine + S::HO_);           // (K > 1) this rank's share, x2
  bf16* as = reinterpret_cast<bf16*>(mine + S::A_);            // LN1, then LN2 output
  const SwinPipe<C, HD, K, G> pipe{smem + S::RING, full, empty, p.wqkv, p.wproj, p.w1, p.w2, rank};

  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G);
    }
    for (int i = 0; i < G; ++i) mbar_init(&xbar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid % 128 < 32) {  // x of this warpgroup's window, row by row, by the copy engine
    if (tid % 128 == 0) mbar_expect_tx(&xbar[w], kT * C * 4);
    __syncwarp();
    for (int t = tid % 32; t < kT; t += 32)
      bulk_copy(xs + t * S::LX, p.x + gofs(t, 0), C * 4, &xbar[w]);
  }
  if (tid == 0)
    for (int q = 0; q < S::STAGES && q < S::NQ; ++q) pipe.issue(q);
  __syncwarp();
  mbar_wait(&xbar[w], 0);
  ln_window<C, S::LX>(xs, as, p.ln1s, p.ln1b);
  fence_async_smem();
  named_sync(bar_id, 128);

  // attention, head group by head group: q | k | v of the group's heads
  // (one product), then one warp per (head, 16 query rows)
  const bool last_row = p.shifted && wy == nwh - 1;
  const bool last_col = p.shifted && wx == nww - 1;
  const int warp4 = tid % 128 / 32;
  for (int g = 0; g < S::NG; ++g) {
    float acc[3 * S::GW / 2];
#pragma unroll
    for (int i = 0; i < 3 * S::GW / 2; ++i) acc[i] = 0.f;
    pipe.template product<3 * S::GW, S::CST>(acc, as, g * S::CST, bar_id);
    const int h0 = rank * S::HK + g * S::GH;  // the group's first head
    wg_epilogue<3 * S::GW>(acc, [&](int t, int n, float v0, float v1) {
      const int hl = n / (3 * HD), seg = n % (3 * HD) / HD, d = n % HD;
      const int gc = seg * C + (h0 + hl) * HD + d;  // wqkv's own row
      v0 += __ldg(p.bqkv + gc);
      v1 += __ldg(p.bqkv + gc + 1);
      if (seg < 2) {
        *reinterpret_cast<uint32_t*>(qk + al(t, seg * S::GW + hl * HD + d)) = pack_bf16(v0, v1);
      } else {
        const int dim = hl * HD + d;
        vs[(t / 8 * S::GW + dim) * 8 + t % 8] = __float2bfloat16_rn(v0);
        vs[(t / 8 * S::GW + dim + 1) * 8 + t % 8] = __float2bfloat16_rn(v1);
      }
    });
    named_sync(bar_id, 128);
    float2 bias[2][8];
    head_bias(bias, p.relb + static_cast<size_t>(h0) * kT * kT, warp4);
#pragma unroll 1
    for (int hl = 0; hl < S::GH; ++hl) {
      float2 next[2][8];
      if (hl + 1 < S::GH)  // the next head's bias in flight meanwhile
        head_bias(next, p.relb + static_cast<size_t>(h0 + hl + 1) * kT * kT, warp4);
      head_attention_wg<HD, S::GW>(qk, vs, hl * HD, bias, os, (h0 + hl) * HD, warp4, last_row,
                                   last_col);
      if (hl + 1 < S::GH) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int j = 0; j < 8; ++j) bias[hf][j] = next[hf][j];
      }
    }
    named_sync(bar_id, 128);
  }
  if constexpr (K > 1) {
    // every rank's heads are in: gather the other ranks' column blocks, then
    // wait until every rank has read this one's (proj's epilogue overwrites them)
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    constexpr int PER = S::CK / 8 * kLA / 8;  // 16-byte chunks of a rank's k-groups
    for (int i = tid % 128; i < K * PER; i += 128) {
      const int r = i / PER;
      if (r == rank) continue;
      const int e = r * S::CK / 8 * kLA + i % PER * 8;
      const bf16* src = cluster.map_shared_rank(os, r);
      *reinterpret_cast<uint4*>(os + e) = *reinterpret_cast<const uint4*>(src + e);
    }
    cluster.sync();
  }
  fence_async_smem();
  named_sync(bar_id, 128);

  {  // x1 = x + (o . Wproj + bproj) on this rank's columns: into xs and out
    float acc[S::CK / 2];
#pragma unroll
    for (int i = 0; i < S::CK / 2; ++i) acc[i] = 0.f;
    pipe.template product<S::CK, S::CST>(acc, os, S::Q_PROJ, bar_id);
    wg_epilogue<S::CK>(acc, [&](int t, int n, float v0, float v1) {
      const int c = cbase + n;
      const size_t o = gofs(t, c);
      const float2 xv = __ldg(reinterpret_cast<const float2*>(p.x + o));
      float2 v;
      v.x = xv.x + (v0 + __ldg(p.bproj + c));
      v.y = xv.y + (v1 + __ldg(p.bproj + c + 1));
      *reinterpret_cast<float2*>(xs + t * S::LX + c) = v;
      if (valid) *reinterpret_cast<float2*>(p.out + o) = v;
    });
  }
  if constexpr (K > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    constexpr int PER = kT * S::CK / 4;
    for (int i = tid % 128; i < K * PER; i += 128) {
      const int r = i / PER;
      if (r == rank) continue;
      const int t = i % PER / (S::CK / 4);
      const int c = r * S::CK + i % (S::CK / 4) * 4;
      const float* src = cluster.map_shared_rank(xs, r);
      *reinterpret_cast<float4*>(xs + t * S::LX + c) =
          *reinterpret_cast<const float4*>(src + t * S::LX + c);
    }
  }
  named_sync(bar_id, 128);
  ln_window<C, S::LX>(xs, as, p.ln2s, p.ln2b);
  fence_async_smem();
  if constexpr (K > 1) cg::this_cluster().sync();  // every rank has read this one's x1
  named_sync(bar_id, 128);

  // MLP in steps of STEPU hidden units: each rank computes HSK of them, the
  // step's units are gathered in ascending order, and the second layer's
  // accumulators (acc2) run on over all 4C units.
  float acc2[S::CK / 2];
#pragma unroll
  for (int i = 0; i < S::CK / 2; ++i) acc2[i] = 0.f;
  for (int s = 0; s < 4 * C / S::STEPU; ++s) {
    const int q0 = S::Q_MLP + s * S::STEP;
    const int u0 = s * S::STEPU + rank * S::HSK;  // this rank's first hidden unit of the step
    bf16* hd = K == 1 ? hs : ho + (s & 1) * (S::HSK / 8) * kLA;
    {
      float acc[S::HSK / 2];
#pragma unroll
      for (int i = 0; i < S::HSK / 2; ++i) acc[i] = 0.f;
      pipe.template product<S::HSK, S::CST>(acc, as, q0, bar_id);
      wg_epilogue<S::HSK>(acc, [&](int t, int n, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(hd + al(t, n)) =
            pack_bf16(gelu(v0 + __ldg(p.b1 + u0 + n)), gelu(v1 + __ldg(p.b1 + u0 + n + 1)));
      });
    }
    if constexpr (K > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      constexpr int PER = S::HSK / 8 * kLA / 8;
      for (int i = tid % 128; i < K * PER; i += 128) {
        const int r = i / PER;
        const bf16* src = cluster.map_shared_rank(hd, r);
        *reinterpret_cast<uint4*>(hs + r * S::HSK / 8 * kLA + i % PER * 8) =
            *reinterpret_cast<const uint4*>(src + i % PER * 8);
      }
    }
    fence_async_smem();
    named_sync(bar_id, 128);
    pipe.template product<S::CK, S::W2ST>(acc2, hs, q0 + S::CST, bar_id);
  }
  if (valid) {
    wg_epilogue<S::CK>(acc2, [&](int t, int n, float v0, float v1) {
      const int c = cbase + n;
      const size_t o = gofs(t, c);
      const float2 x1 = __ldcg(reinterpret_cast<const float2*>(p.out + o));
      float2 v;
      v.x = x1.x + (v0 + __ldg(p.b2 + c));
      v.y = x1.y + (v1 + __ldg(p.b2 + c + 1));
      *reinterpret_cast<float2*>(p.out + o) = v;
    });
  }
  if constexpr (K > 1) cg::this_cluster().sync();  // peers may still read this rank's units
}

template <int C, int HD, int K, int G>
cudaError_t launch_swin(const SwinArgs& a, int B, cudaStream_t stream) {
  using S = SwinWG<C, HD, K, G>;
  cudaError_t e = cudaFuncSetAttribute(swin_block_bf16_kernel<C, HD, K, G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (e != cudaSuccess) return e;
  const int nwin = (a.H / kWin) * (a.W / kWin);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nwin + G - 1) / G * K, B, 1);
  cfg.blockDim = dim3(128 * G, 1, 1);
  cfg.dynamicSmemBytes = S::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, swin_block_bf16_kernel<C, HD, K, G>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

#ifndef SWIN_WIDE  // the attention-only flavour builds with the narrow instances

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

#endif  // SWIN_WIDE

// Instances (C, head_dim, K, G): for each (C, head_dim) the smallest
// cluster (ops/flash_window_attn.py::min_cluster) with one and with two
// windows a CTA, and the largest cluster (max_cluster) with one. The source
// builds twice (ops/build.py): C <= 96, and with SWIN_WIDE C >= 128.
#ifdef SWIN_WIDE
#define SWIN_BF16_INSTANCES(X)                                                              \
  X(128, 8, 1, 1) X(128, 8, 1, 2) X(128, 8, 8, 1) X(128, 16, 1, 1) X(128, 16, 1, 2)         \
  X(128, 16, 8, 1) X(128, 32, 1, 1) X(128, 32, 1, 2) X(128, 32, 4, 1) X(192, 8, 2, 1)       \
  X(192, 8, 2, 2) X(192, 8, 8, 1) X(192, 16, 2, 1) X(192, 16, 2, 2) X(192, 16, 4, 1)        \
  X(192, 32, 2, 1) X(192, 32, 2, 2)
#else
#define SWIN_BF16_INSTANCES(X)                                                              \
  X(64, 8, 1, 1) X(64, 8, 1, 2) X(64, 8, 8, 1) X(64, 16, 1, 1) X(64, 16, 1, 2)              \
  X(64, 16, 4, 1) X(64, 32, 1, 1) X(64, 32, 1, 2) X(64, 32, 2, 1) X(96, 8, 1, 1)            \
  X(96, 8, 1, 2) X(96, 8, 4, 1) X(96, 16, 1, 1) X(96, 16, 1, 2) X(96, 16, 2, 1)             \
  X(96, 32, 1, 1) X(96, 32, 1, 2)
#endif

}  // namespace

extern "C" {

// x, out: [B][H][W][C] float32 (H, W multiples of 8; C 64 or 96, or with
// SWIN_WIDE 128 or 192; head_dim 8, 16 or 32), 16-byte aligned. The
// matrices are bf16 [in/8][out][8] (input group, output, 8 inputs): wqkv
// [C/8][3C][8] with the q rows
// pre-scaled and its outputs head by head (head h's q, k, v rows at
// 3*h*head_dim, ...); wproj [C/8][C][8]; w1 [C/8][4C][8]; w2 [4C/8][C][8];
// bqkv: [3C] in torch order with the q entries pre-scaled; relb:
// [C/head_dim][64][64]; ln*, bproj, b2: [C]; b1: [4C] (float32). cluster:
// CTAs per window and group: windows per CTA, one of SWIN_BF16_INSTANCES'
// (K, G) for (C, head_dim); the result does not depend on them.
int flash_window_block_bf16(const float* x, float* out, const bf16* wqkv, const float* bqkv,
                            const bf16* wproj, const float* bproj, const float* ln1s,
                            const float* ln1b, const float* relb, const float* ln2s,
                            const float* ln2b, const bf16* w1, const float* b1, const bf16* w2,
                            const float* b2, int B, int H, int W, int C, int head_dim,
                            int cluster, int group, int shifted, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % kWin != 0 || W % kWin != 0 || B <= 0) return cudaErrorInvalidValue;
  const SwinArgs a{x,    out,  wqkv, bqkv, wproj, bproj, ln1s, ln1b, relb,
                   ln2s, ln2b, w1,   b1,   w2,    b2,    H,    W,    shifted};
#define SWIN_CASE(c, hd, k, g)                                          \
  if (C == c && head_dim == hd && cluster == k && group == g) \
    return launch_swin<c, hd, k, g>(a, B, s);
  SWIN_BF16_INSTANCES(SWIN_CASE)
#undef SWIN_CASE
  return cudaErrorInvalidValue;
}

#ifndef SWIN_WIDE
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

#endif  // SWIN_WIDE

}  // extern "C"
