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
// A second flavour (FULL = false) drops LN1 and the MLP branch: it computes
// x + o . Wproj + bproj from qkv = x . Wqkv + bqkv, the TPU kernel's
// with_ln=False, mlp=None (WACNN's WinBasedAttention, C = 192, head_dim 24).
//
// The shifted (SW) flavour takes the already rolled map (torch.roll stays
// outside) and adds -1e9 to the scores of token pairs that the roll brought
// together from opposite image edges: in the last window row when the two
// tokens lie on different sides of row 4, and in the last window column when
// they lie on different sides of column 4, as the TPU kernel does.
//
// What bounds it on this card: per window the block does about
// 2*T*(12*C^2 + 2*T*C) FLOP (7.3 MFLOP at C = 64, 27 MFLOP at C = 128) and
// must move only the window in and out, 2*T*C*4 bytes (32 or 64 KB): about
// 225..420 FLOP per byte, so fp32 operations bound it, not memory. The
// composed PyTorch block is instead bound by the bytes of its intermediates
// (qkv, the per-head score tensors, the 4C MLP hidden layer), which this
// kernel keeps in shared memory.
//
// Design: one block of 256 threads per window; the grid is windows x batch,
// so no sequential grid carries state. Shared memory holds the window x
// [T][C], the LN / attention-output buffer [T][C], qkv [T][3C+1] (the odd
// row stride keeps the lanes of a warp that read 32 different key rows on
// 32 different banks) and one head's scores [T][T+1]: 179 KB at C = 128, one
// block per SM. The 4C MLP hidden layer does not fit beside them, so it is
// computed in chunks of 128 hidden units into the space qkv used, each chunk
// multiplied into an accumulator right away. The dense layers read their
// weights from L2 ([in][out] layout: a warp reads 32 consecutive outputs'
// weights in one transaction) and each thread computes one output column
// for 8 tokens, so one weight load serves 8 fused multiply-adds while the
// warp's activation reads are shared-memory broadcasts. LayerNorm and the
// softmax give one warp to each row and reduce with butterfly shuffles.
// Every reduction has a fixed order and there are no atomics, so the
// results are deterministic, which the codec's encoder/decoder symmetry
// needs. Heads are processed one after another (8, 16, 24 or 32 wide), so
// the TPU kernel's head-packed and block-diagonal layouts have no
// counterpart.
//
// At C = 192 (the attention-only flavour) the LN+MLP layout would need 260 KB
// of shared memory (x 48 KB, a separate attention-output buffer 48 KB, qkv
// 148 KB, scores 17 KB) against the 227 KB a block may have. Without LN1
// the LN buffer is not needed, and each head's output overwrites that
// head's q columns once its scores are in the score buffer (nothing reads
// them again), so the proj reads the attention output from qkv's first C
// columns: 212 KB, one block (8 warps) per SM, 384 blocks at 768x512.
// That flavour does 2*T*(4*C^2 + 2*T*C) FLOP per window (22 MFLOP at
// C = 192) for 2*T*C*4 = 96 KB in and out: operations bound it too.
//
// Interface: plain C, raw pointers, the launch stream; returns
// cudaGetLastError() of the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kWin = 8;
constexpr int kT = kWin * kWin;    // tokens per window
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHiddenChunk = 128;  // MLP hidden units per chunk
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

// dst[t][c] = LN(src[t][c]) * g[c] + b[c], one warp per token.
template <int C>
__device__ void layer_norm(const float* src, float* dst, const float* __restrict__ g,
                           const float* __restrict__ b) {
  constexpr int PER = C / 32;
  const int lane = threadIdx.x % 32;
  for (int t = threadIdx.x / 32; t < kT; t += kWarps) {
    float v[PER];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      v[i] = src[t * C + lane + 32 * i];
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
      dst[t * C + c] = v[i] * rstd * __ldg(g + c) + __ldg(b + c);
    }
  }
}

enum Epilogue { kStore = 0, kAccumulate = 1, kGelu = 2 };

// For every token t < 64 and column j < N:
//   v = sum_k A[t*lda + k] * W[k*ldw + j] + bias[j]   (k ascending)
// kStore: D = v; kAccumulate: D += v; kGelu: D = GELU(v).
// bias may be null (adds 0).
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
    const float bj = bias != nullptr ? __ldg(bias + j) : 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float v = acc[r] + bj;
      float* d = D + (t0 + r) * ldd + j;
      if (E == kStore) *d = v;
      if (E == kAccumulate) *d += v;
      if (E == kGelu) *d = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    }
  }
}

template <int C, int HD, bool FULL>
__global__ void __launch_bounds__(kThreads)
    flash_window_block_kernel(const float* __restrict__ x, float* __restrict__ out,
                              const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                              const float* __restrict__ wproj, const float* __restrict__ bproj,
                              const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                              const float* __restrict__ relb, const float* __restrict__ ln2s,
                              const float* __restrict__ ln2b, const float* __restrict__ w1,
                              const float* __restrict__ b1, const float* __restrict__ w2,
                              const float* __restrict__ b2, int H, int W, int shifted) {
  constexpr int NH = C / HD;
  constexpr int LQ = 3 * C + 1;  // qkv row stride
  constexpr int LS = kT + 1;     // score row stride
  constexpr int HID = 4 * C;
  static_assert(C % 32 == 0 && C % HD == 0, "shape");
  static_assert(kT * (kHiddenChunk + 1) + kT * C <= kT * LQ, "MLP buffers fit in qkv's space");
  extern __shared__ float smem[];
  float* xs = smem;                       // [T][C] residual stream
  float* as = xs + kT * C;                // FULL: [T][C] LN output, then attention output
  float* qs = FULL ? as + kT * C : as;    // [T][LQ] qkv; later MLP hidden chunk + accumulator
  float* ss = qs + kT * LQ;               // [T][LS] one head's scores
  // attention output: its own buffer, or (not FULL) over the q columns
  float* os = FULL ? as : qs;
  constexpr int LO = FULL ? C : LQ;

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

  if (FULL) {
    layer_norm<C>(xs, as, ln1s, ln1b);
    __syncthreads();
  }
  dense<kStore>(FULL ? as : xs, C, C, wqkv, 3 * C, 3 * C, bqkv, qs, LQ);
  __syncthreads();

  const bool last_row = shifted && wy == nwh - 1;
  const bool last_col = shifted && wx == nww - 1;
  constexpr int S = kWin / 2;
  for (int h = 0; h < NH; ++h) {
    // scores: thread owns key q (lane-varying) for rows p = tid/64 + 4i
    {
      const int q = threadIdx.x % kT;
      float kq[HD];
#pragma unroll
      for (int d = 0; d < HD; ++d) kq[d] = qs[q * LQ + C + h * HD + d];
      const float* rb = relb + static_cast<size_t>(h) * kT * kT;
      for (int p = threadIdx.x / kT; p < kT; p += kThreads / kT) {
        const float* qp = qs + p * LQ + h * HD;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) s = fmaf(qp[d], kq[d], s);
        s += __ldg(rb + p * kT + q);
        if (last_row && ((p / kWin < S) != (q / kWin < S))) s += kNegInf;
        if (last_col && ((p % kWin < S) != (q % kWin < S))) s += kNegInf;
        ss[p * LS + q] = s;
      }
    }
    __syncthreads();
    // softmax over each row, one warp per row
    {
      const int lane = threadIdx.x % 32;
      for (int p = threadIdx.x / 32; p < kT; p += kWarps) {
        const float v0 = ss[p * LS + lane];
        const float v1 = ss[p * LS + lane + 32];
        const float m = warp_max(fmaxf(v0, v1));
        const float e0 = expf(v0 - m);
        const float e1 = expf(v1 - m);
        const float inv = 1.f / warp_sum(e0 + e1);
        ss[p * LS + lane] = e0 * inv;
        ss[p * LS + lane + 32] = e1 * inv;
      }
    }
    __syncthreads();
    // o_h = P v_h, written into os[:, h*HD : (h+1)*HD] (not FULL: head h's
    // q columns, which no later step reads)
    for (int it = threadIdx.x; it < kT * HD; it += kThreads) {
      const int d = it % HD;
      const int p = it / HD;
      const float* pp = ss + p * LS;
      const float* vv = qs + 2 * C + h * HD + d;
      float o = 0.f;
      for (int q = 0; q < kT; ++q) o = fmaf(pp[q], vv[q * LQ], o);
      os[p * LO + h * HD + d] = o;
    }
    __syncthreads();
  }

  dense<kAccumulate>(os, LO, C, wproj, C, C, bproj, xs, C);
  __syncthreads();

  if (!FULL) {
    for (int i = threadIdx.x; i < kT * C; i += kThreads) out[gofs(i / C, i % C)] = xs[i];
    return;
  }

  layer_norm<C>(xs, as, ln2s, ln2b);
  float* hs = qs;                          // [T][kHiddenChunk + 1]
  float* acc = qs + kT * (kHiddenChunk + 1);  // [T][C]
  for (int i = threadIdx.x; i < kT * C; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  for (int c0 = 0; c0 < HID; c0 += kHiddenChunk) {
    dense<kGelu>(as, C, C, w1 + c0, HID, kHiddenChunk, b1 + c0, hs, kHiddenChunk + 1);
    __syncthreads();
    dense<kAccumulate>(hs, kHiddenChunk + 1, kHiddenChunk, w2 + static_cast<size_t>(c0) * C, C,
                       C, nullptr, acc, C);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < kT * C; i += kThreads) {
    const int c = i % C;
    out[gofs(i / C, c)] = xs[i] + (acc[i] + __ldg(b2 + c));
  }
}

template <int C, int HD, bool FULL = true>
cudaError_t launch(const float* x, float* out, const float* wqkv, const float* bqkv,
                   const float* wproj, const float* bproj, const float* ln1s, const float* ln1b,
                   const float* relb, const float* ln2s, const float* ln2b, const float* w1,
                   const float* b1, const float* w2, const float* b2, int B, int H, int W,
                   int shifted, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((FULL ? 2 : 1) * kT * C + kT * (3 * C + 1) + kT * (kT + 1));
  cudaError_t e = cudaFuncSetAttribute(flash_window_block_kernel<C, HD, FULL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((H / kWin) * (W / kWin), B);
  flash_window_block_kernel<C, HD, FULL><<<grid, kThreads, smem, stream>>>(
      x, out, wqkv, bqkv, wproj, bproj, ln1s, ln1b, relb, ln2s, ln2b, w1, b1, w2, b2, H, W,
      shifted);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_c(int head_dim, const float* x, float* out, const float* wqkv,
                     const float* bqkv, const float* wproj, const float* bproj,
                     const float* ln1s, const float* ln1b, const float* relb, const float* ln2s,
                     const float* ln2b, const float* w1, const float* b1, const float* w2,
                     const float* b2, int B, int H, int W, int shifted, cudaStream_t s) {
  if (head_dim == 8)
    return launch<C, 8>(x, out, wqkv, bqkv, wproj, bproj, ln1s, ln1b, relb, ln2s, ln2b, w1, b1,
                        w2, b2, B, H, W, shifted, s);
  if (head_dim == 16)
    return launch<C, 16>(x, out, wqkv, bqkv, wproj, bproj, ln1s, ln1b, relb, ln2s, ln2b, w1,
                         b1, w2, b2, B, H, W, shifted, s);
  if (head_dim == 32)
    return launch<C, 32>(x, out, wqkv, bqkv, wproj, bproj, ln1s, ln1b, relb, ln2s, ln2b, w1,
                         b1, w2, b2, B, H, W, shifted, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, out: [B][H][W][C] (H, W multiples of 8; C 64 or 128; head_dim 8, 16
// or 32). wqkv: [C][3C] with the q columns pre-scaled; bqkv: [3C];
// wproj: [C][C]; w1: [C][4C]; w2: [4C][C] (all [in][out]); relb:
// [C/head_dim][64][64]; ln*, bproj, b2: [C]; b1: [4C].
int flash_window_block_f32(const float* x, float* out, const float* wqkv, const float* bqkv,
                           const float* wproj, const float* bproj, const float* ln1s,
                           const float* ln1b, const float* relb, const float* ln2s,
                           const float* ln2b, const float* w1, const float* b1,
                           const float* w2, const float* b2, int B, int H, int W, int C,
                           int head_dim, int shifted, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % kWin != 0 || W % kWin != 0) return cudaErrorInvalidValue;
  if (C == 64)
    return launch_c<64>(head_dim, x, out, wqkv, bqkv, wproj, bproj, ln1s, ln1b, relb, ln2s,
                        ln2b, w1, b1, w2, b2, B, H, W, shifted, s);
  if (C == 128)
    return launch_c<128>(head_dim, x, out, wqkv, bqkv, wproj, bproj, ln1s, ln1b, relb, ln2s,
                         ln2b, w1, b1, w2, b2, B, H, W, shifted, s);
  return cudaErrorInvalidValue;
}

// The attention-only flavour (no LN1, no MLP): out = x + attn(x) . Wproj +
// bproj. x, out: [B][H][W][C] (H, W multiples of 8; C 192 with head_dim
// 24). wqkv: [C][3C] with the q columns pre-scaled; bqkv: [3C]; wproj:
// [C][C] ([in][out]); bproj: [C]; relb: [C/head_dim][64][64].
int window_attention_block_f32(const float* x, float* out, const float* wqkv,
                               const float* bqkv, const float* wproj, const float* bproj,
                               const float* relb, int B, int H, int W, int C, int head_dim,
                               int shifted, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % kWin != 0 || W % kWin != 0) return cudaErrorInvalidValue;
  if (C == 192 && head_dim == 24)
    return launch<192, 24, false>(x, out, wqkv, bqkv, wproj, bproj, nullptr, nullptr, relb,
                                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, H,
                                  W, shifted, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
