// Per-window qkv attention for Hopper (sm_90a), fp32.
//
// Replaces the repository's per-head Pallas TPU kernel
// pallas_attn_perhead.py (fused_qkv_attention / _kernel), which sits beside
// the JAX package and is not imported by it. For each window w of Nw windows of T
// tokens with C channels and NH = C / HD heads:
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
// plus the weights (1.6 MB once from device memory; every window reads
// them again from L2): 1.29 GFLOP for 5.6 MB at WACNN's 96 windows, about
// 230 FLOP per byte, so fp32 operations bound it. The composed
// PyTorch version is bound instead by the round trips of qkv, the per-head
// scores and the probabilities through device memory, which this kernel
// keeps in shared memory.
//
// Design: one block of 256 threads per window (96 blocks at WACNN's
// 768x512, window 4, C = 320). Shared memory holds the window x [T][C]
// (later the attention output), qkv [T][3C+1] (the odd row stride puts the
// 16 key rows a warp reads on 16 different banks) and all heads' scores
// [NH][T][T+1]: 89 KB at T = 16, C = 320, two blocks per SM. The dense
// layers read their weights from L2 in [in][out] layout (a warp reads 32
// consecutive outputs' weights in one transaction); each thread computes
// one output column for all T tokens, so one weight load serves T fused
// multiply-adds while the activation reads are shared-memory broadcasts.
// The softmax gives one thread to each (head, row) and uses exact expf.
// Every sum has a fixed order and there are no atomics, so the result is
// deterministic, which the codec's encoder/decoder symmetry needs.
//
// Interface: plain C, raw pointers, the launch stream; returns
// cudaGetLastError() of the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// For every token t < T and column j < N:
//   D[t*ldd + j] = sum_k A[t*lda + k] * W[k*ldw + j] + bias[j]   (k ascending)
template <int T>
__device__ void dense(const float* A, int lda, int K, const float* __restrict__ W, int ldw,
                      int N, const float* __restrict__ bias, float* D, int ldd) {
  for (int j = threadIdx.x; j < N; j += kThreads) {
    float acc[T];
#pragma unroll
    for (int r = 0; r < T; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(W + static_cast<size_t>(k) * ldw + j);
#pragma unroll
      for (int r = 0; r < T; ++r) acc[r] = fmaf(A[r * lda + k], w, acc[r]);
    }
    const float bj = __ldg(bias + j);
#pragma unroll
    for (int r = 0; r < T; ++r) D[static_cast<size_t>(r) * ldd + j] = acc[r] + bj;
  }
}

template <int T, int C, int HD>
__global__ void __launch_bounds__(kThreads)
    qkv_attention_kernel(const float* __restrict__ x, float* __restrict__ out,
                         const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                         const float* __restrict__ relb, const float* __restrict__ wproj,
                         const float* __restrict__ bproj, const float* __restrict__ mask,
                         int n_mask, float scale) {
  constexpr int NH = C / HD;
  constexpr int LQ = 3 * C + 1;  // qkv row stride
  constexpr int LS = T + 1;      // score row stride
  static_assert(C % HD == 0, "shape");
  extern __shared__ float smem[];
  float* xs = smem;             // [T][C] window, later the attention output
  float* qs = xs + T * C;       // [T][LQ] qkv
  float* ss = qs + T * LQ;      // [NH][T][LS] scores, then probabilities

  const size_t win = blockIdx.x;
  const float* xw = x + win * T * C;
  for (int i = threadIdx.x; i < T * C; i += kThreads) xs[i] = xw[i];
  __syncthreads();

  dense<T>(xs, C, C, wqkv, 3 * C, 3 * C, bqkv, qs, LQ);
  __syncthreads();

  const float* mw = mask != nullptr ? mask + (win % n_mask) * T * T : nullptr;
  for (int it = threadIdx.x; it < NH * T * T; it += kThreads) {
    const int q = it % T;
    const int p = (it / T) % T;
    const int h = it / (T * T);
    const float* qp = qs + p * LQ + h * HD;
    const float* kq = qs + q * LQ + C + h * HD;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) s = fmaf(qp[d], kq[d], s);
    s = s * scale + __ldg(relb + (h * T + p) * T + q);
    if (mw != nullptr) s += __ldg(mw + p * T + q);
    ss[(h * T + p) * LS + q] = s;
  }
  __syncthreads();

  for (int row = threadIdx.x; row < NH * T; row += kThreads) {
    float* sr = ss + row * LS;
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

  for (int it = threadIdx.x; it < T * C; it += kThreads) {
    const int c = it % C;
    const int p = it / C;
    const int h = c / HD;
    const float* pp = ss + (h * T + p) * LS;
    const float* vv = qs + 2 * C + c;
    float o = 0.f;
    for (int q = 0; q < T; ++q) o = fmaf(pp[q], vv[q * LQ], o);
    xs[p * C + c] = o;
  }
  __syncthreads();

  dense<T>(xs, C, C, wproj, C, C, bproj, out + win * T * C, C);
}

template <int T, int C, int HD>
cudaError_t launch(const float* x, float* out, const float* wqkv, const float* bqkv,
                   const float* relb, const float* wproj, const float* bproj, const float* mask,
                   int n_windows, int n_mask, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (T * C + T * (3 * C + 1) + (C / HD) * T * (T + 1));
  cudaError_t e = cudaFuncSetAttribute(qkv_attention_kernel<T, C, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  qkv_attention_kernel<T, C, HD><<<n_windows, kThreads, smem, stream>>>(
      x, out, wqkv, bqkv, relb, wproj, bproj, mask, n_mask, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: [Nw][T][C] windows (T 16 with C 320 and head_dim 40). wqkv:
// [C][3C]; wproj: [C][C] (both [in][out]); bqkv: [3C]; bproj: [C]; relb:
// [C/head_dim][T][T]; mask: [n_mask][T][T] additive, or null (n_mask is
// then ignored); scale: head_dim^-0.5.
int qkv_attention_f32(const float* x, float* out, const float* wqkv, const float* bqkv,
                      const float* relb, const float* wproj, const float* bproj,
                      const float* mask, int n_windows, int T, int C, int head_dim, int n_mask,
                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_windows <= 0 || (mask != nullptr && n_mask <= 0)) return cudaErrorInvalidValue;
  if (T == 16 && C == 320 && head_dim == 40)
    return launch<16, 320, 40>(x, out, wqkv, bqkv, relb, wproj, bproj, mask, n_windows, n_mask,
                               scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
