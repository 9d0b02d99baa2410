// The device coder's lane coders for Hopper (sm_90a): interleaved rANS with
// 32-bit states, 16-bit renormalisation words and 16-bit probabilities, the
// scheme of reslic_tcm_tpu/coding/device_rans.py and analytic_rans.py.
//
// Replaces no Pallas kernel: the JAX package runs these lane loops as
// lax.scan programs. Four kernels, each beside a plain PyTorch version in
// coding/device_rans.py and coding/analytic_rans.py:
//
//   D1 rans_encode_kernel     encode_interleaved (packed-table variant)
//   D2 rans_decode_kernel     decode_segment (inverse-table variant)
//   D3 gaussian_encode_kernel encode_gaussian_grouped's lane walk
//   D4 gaussian_decode_kernel decode_gaussian_grouped_segment
//
// What bounds them on this card: neither bytes nor operations. A lane is a
// chain of dependent state updates, one per step (480 steps for a 768x512
// TCM-S image at k=1024), and only k lanes run at once, so a launch fills a
// few SMs at most and its time is the chain's latency. The designs keep the
// chain short: one thread walks a lane with its state in a register, D1
// writes its words straight into its row (no compaction pass), and the
// analytic kernels compute their CDF boundaries from sigma in registers (no
// table gathers). Exact integer / and % replace JAX's float-estimate
// quotient with its two corrections, which gives the same quotient.
//
// Bits: the analytic boundaries must equal XLA's float32 arithmetic bit for
// bit, erf included (xla_erf: clamp, then x * alpha(x^2) / beta(x^2), each
// Horner step one fused multiply-add). Every step is written with a
// rounding intrinsic (__fmaf_rn for the Horner steps, __fmul_rn, __fadd_rn,
// __fsub_rn and __fdiv_rn for the rest) so that nvcc's default --fmad=true
// contracts nothing; the build must not use -use_fast_math.
//
// Tensors (all from the wrapper, coding/device_kernels.py): symbols,
// indexes, words and counts int32 (a word is a value in [0, 2^16)); CDF
// lengths and offsets int32; the inverse table int16 [R][65536]; the packed
// table int32 [R][L] holding uint32 start << 16 | freq; lane states and read
// pointers int64 (a state is a uint32 value).
//
// Interface: plain C, raw pointers, the launch stream; each function returns
// cudaGetLastError() of its launch (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr uint32_t kMask16 = 0xFFFFu;
constexpr int kTotal = 1 << 16;
constexpr int kCmax = 511;
constexpr int kSearchIters = 11;
constexpr int kMaxThreads = 1024;

// ------------------------------ D1: encode ------------------------------

// One thread per lane: walk the steps in reverse and write the emitted
// words in emission order into the lane's row; words past `cap` are dropped
// and counted (the wrapper reports overflow from the count).
__global__ void rans_encode_kernel(const int* __restrict__ symbols, const int* __restrict__ indexes,
                                   const int* __restrict__ packed, int L,
                                   const int* __restrict__ cdf_length, const int* __restrict__ offset,
                                   int steps, int k, int cap, int* __restrict__ words,
                                   int* __restrict__ counts) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= k) return;
  int* row = words + static_cast<long long>(lane) * cap;
  int pos = 0;
  auto emit = [&](uint32_t w) {
    if (pos < cap) row[pos] = static_cast<int>(w);
    ++pos;
  };
  uint32_t x = kRansL;
  for (int s = steps - 1; s >= 0; --s) {
    const long long p = static_cast<long long>(s) * k + lane;
    const int sym = symbols[p];
    const int idx = indexes[p];
    const int max_value = cdf_length[idx] - 2;
    int val = sym - offset[idx];
    if (val < 0 || val >= max_value) {
      // escape: two raw 16-bit words (the state invariant renormalises each)
      const uint32_t raw = static_cast<uint32_t>(sym);
      emit(x & kMask16);
      x = ((x >> 16) << 16) | (raw & kMask16);
      emit(x & kMask16);
      x = ((x >> 16) << 16) | (raw >> 16);
      val = max_value;
    }
    const uint32_t sf = static_cast<uint32_t>(packed[static_cast<long long>(idx) * L + val]);
    const uint32_t start = sf >> 16, freq = sf & kMask16;
    if (x >= (freq << 16)) {
      emit(x & kMask16);
      x >>= 16;
    }
    x = ((x / freq) << 16) | ((x % freq) + start);
  }
  emit(x & kMask16);
  emit(x >> 16);
  counts[lane] = pos;
}

// ------------------------------ D2: decode ------------------------------

// One thread per lane over one segment; the carry (state, read pointer)
// is read from and written back to device memory, so segments chain.
// base[lane] is where the lane's word 0 lies (lane * cap for per-lane rows,
// the lane offset for a flat stream); reads are clamped into the stream.
__global__ void rans_decode_kernel(const int* __restrict__ words, long long n_words,
                                   const long long* __restrict__ base, long long* __restrict__ x_io,
                                   long long* __restrict__ rp_io, const int* __restrict__ indexes,
                                   const short* __restrict__ inverse, const int* __restrict__ packed,
                                   int L, const int* __restrict__ cdf_length,
                                   const int* __restrict__ offset, int steps, int k,
                                   int* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= k) return;
  const long long b = base[lane];
  uint32_t x = static_cast<uint32_t>(x_io[lane]);
  long long rp = rp_io[lane];
  auto read = [&]() -> uint32_t {
    long long i = b + (rp > 0 ? rp : 0);
    if (i > n_words - 1) i = n_words - 1;
    return static_cast<uint32_t>(words[i]);
  };
  auto get_bits16 = [&]() -> uint32_t {
    const uint32_t val = x & kMask16;
    x >>= 16;
    if (x < kRansL) {
      x = (x << 16) | read();
      --rp;
    }
    return val;
  };
  for (int s = 0; s < steps; ++s) {
    const long long p = static_cast<long long>(s) * k + lane;
    const int idx = indexes[p];
    const uint32_t cf = x & kMask16;
    const int sym = inverse[static_cast<long long>(idx) * kTotal + cf];
    const uint32_t sf = static_cast<uint32_t>(packed[static_cast<long long>(idx) * L + sym]);
    const uint32_t start = sf >> 16, freq = sf & kMask16;
    x = freq * (x >> 16) + cf - start;
    if (x < kRansL) {
      x = (x << 16) | read();
      --rp;
    }
    if (sym == cdf_length[idx] - 2) {
      const uint32_t hi = get_bits16();
      const uint32_t lo = get_bits16();
      out[p] = static_cast<int>((hi << 16) | lo);
    } else {
      out[p] = sym + offset[idx];
    }
  }
  x_io[lane] = x;
  rp_io[lane] = rp;
}

// --------------------- analytic boundaries (XLA's bits) ---------------------

// The constants are double literals rounded to float32 once, as XLA and
// numpy round them (a float literal would round the decimal directly).
#define F32(v) static_cast<float>(v)

__device__ __forceinline__ float xla_erf(float x) {
  const float kClamp = F32(3.7439211627767994);
  x = fminf(fmaxf(x, -kClamp), kClamp);
  const float x2 = __fmul_rn(x, x);
  float p = F32(0.00022905065861350646);
  p = __fmaf_rn(p, x2, F32(0.0034082910107109506));
  p = __fmaf_rn(p, x2, F32(0.050955695062380861));
  p = __fmaf_rn(p, x2, F32(0.18520832239976145));
  p = __fmaf_rn(p, x2, F32(1.128379143519084));
  float q = F32(-1.1791602954361697e-7);
  q = __fmaf_rn(q, x2, F32(2.3547966471313185e-05));
  q = __fmaf_rn(q, x2, F32(0.0010179625278914885));
  q = __fmaf_rn(q, x2, F32(0.014070470171167667));
  q = __fmaf_rn(q, x2, F32(0.11098505178285362));
  q = __fmaf_rn(q, x2, F32(0.49746925110067538));
  q = __fmaf_rn(q, x2, 1.0f);
  return __fdiv_rn(__fmul_rn(x, p), q);
}

__device__ __forceinline__ float phi(float z) {
  return __fmul_rn(__fadd_rn(xla_erf(__fmul_rn(z, F32(0.7071067811865476))), 1.0f), 0.5f);
}

struct Params {
  int c, nb;
  float coff, inv_sigma, g0, scale_inv, a;
};

// analytic_rans.py::coder_params for one symbol
__device__ __forceinline__ Params coder_params(float sigma) {
  Params q;
  sigma = fminf(fmaxf(sigma, F32(0.11)), 256.0f);
  q.c = static_cast<int>(fminf(ceilf(__fmul_rn(sigma, 6.0f)), static_cast<float>(kCmax)));
  q.nb = 2 * q.c + 1;
  q.coff = __fadd_rn(static_cast<float>(q.c), 0.5f);
  q.inv_sigma = __fdiv_rn(1.0f, sigma);
  q.g0 = phi(__fmul_rn(-q.coff, q.inv_sigma));
  const float g1 = phi(__fmul_rn(q.coff, q.inv_sigma));
  q.a = static_cast<float>(kTotal - q.nb);
  q.scale_inv = __fdiv_rn(q.a, __fsub_rn(g1, q.g0));
  return q;
}

// analytic_rans.py::_boundary: B(s) for s in [0, nb]; B(nb) == 2^16
__device__ __forceinline__ uint32_t boundary(int s, const Params& q) {
  if (s >= q.nb) return static_cast<uint32_t>(kTotal);
  const float d = __fsub_rn(phi(__fmul_rn(__fsub_rn(static_cast<float>(s), q.coff), q.inv_sigma)),
                            q.g0);
  float raw = floorf(__fmul_rn(d, q.scale_inv));
  raw = fmaxf(fminf(raw, q.a), 0.0f);
  return static_cast<uint32_t>(raw) + static_cast<uint32_t>(s);
}

// ------------------------- D3: analytic encode -------------------------

// One thread per lane: for each step in reverse, the symbol's (start, freq)
// from its sigma, then the state update. ws[t][lane] is the low word of the
// state before step t and need[t][lane] whether it was emitted; the wrapper
// compacts the emitted words into decode-read order.
__global__ void gaussian_encode_kernel(const int* __restrict__ symbols,
                                       const float* __restrict__ sigma, int steps, int k,
                                       int* __restrict__ ws, unsigned char* __restrict__ need,
                                       long long* __restrict__ x_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= k) return;
  uint32_t x = kRansL;
  for (int s = steps - 1; s >= 0; --s) {
    const long long p = static_cast<long long>(s) * k + lane;
    const Params q = coder_params(sigma[p]);
    const int bin = symbols[p] + q.c;
    const uint32_t start = boundary(bin, q);
    const uint32_t freq = boundary(bin + 1, q) - start;
    const bool emit = x >= (freq << 16);
    ws[p] = static_cast<int>(x & kMask16);
    need[p] = emit;
    if (emit) x >>= 16;
    x = ((x / freq) << 16) | ((x % freq) + start);
  }
  x_out[lane] = x;
}

// ------------------------- D4: analytic decode -------------------------

// One CTA per stream, kLanes lanes per thread (consecutive lanes, so a
// thread's lanes are in rank order). Per step each lane binary-searches its
// bin over the analytic boundaries and updates its state; the renormalising
// lanes then take consecutive words after the shared stream pointer g, in
// lane order: an exclusive block-wide scan of the per-thread counts gives
// each its rank. The window's start is clamped to n_flat - k, as XLA's
// dynamic_slice clamps it.
template <int kLanes>
__global__ void __launch_bounds__(kMaxThreads)
gaussian_decode_kernel(long long* __restrict__ x_io, long long* __restrict__ g_io,
                       const int* __restrict__ flat, long long n_flat,
                       const float* __restrict__ sigma, int steps, int k, int* __restrict__ out) {
  __shared__ int warp_sums[kMaxThreads / 32];
  const int t = threadIdx.x;
  const int warp = t >> 5, wl = t & 31;
  const int nwarps = blockDim.x >> 5;
  const int lane0 = t * kLanes;
  uint32_t x[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) x[j] = lane0 + j < k ? static_cast<uint32_t>(x_io[lane0 + j]) : 0u;
  long long g = *g_io;
  for (int s = 0; s < steps; ++s) {
    int cnt = 0;
    unsigned needs = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const int lane = lane0 + j;
      if (lane >= k) break;
      const long long p = static_cast<long long>(s) * k + lane;
      const Params q = coder_params(sigma[p]);
      const uint32_t cf = x[j] & kMask16;
      int lo = 0, hi = q.nb - 1;
      for (int it = 0; it < kSearchIters; ++it) {
        const int mid = (lo + hi + 1) >> 1;
        if (boundary(mid, q) <= cf) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const uint32_t start = boundary(lo, q);
      const uint32_t freq = boundary(lo + 1, q) - start;
      x[j] = freq * (x[j] >> 16) + cf - start;
      if (x[j] < kRansL) {
        needs |= 1u << j;
        ++cnt;
      }
      out[p] = lo - q.c;
    }
    // exclusive scan of cnt over the block: within the warp, then the warps
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (wl >= d) incl += v;
    }
    if (wl == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int v = wl < nwarps ? warp_sums[wl] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (wl >= d) v += u;
      }
      if (wl < nwarps) warp_sums[wl] = v;
    }
    __syncthreads();
    int rank = incl - cnt + (warp > 0 ? warp_sums[warp - 1] : 0);
    const int total = warp_sums[nwarps - 1];
    long long start = g < n_flat - k ? g : n_flat - k;
    if (start < 0) start = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (needs & (1u << j)) {
        x[j] = (x[j] << 16) | static_cast<uint32_t>(flat[start + rank]);
        ++rank;
      }
    }
    g += total;
    __syncthreads();  // warp_sums is rewritten next step
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    if (lane0 + j < k) x_io[lane0 + j] = x[j];
  if (t == 0) *g_io = g;
}

template <int kLanes>
int launch_gaussian_decode(long long* x, long long* g, const int* flat, long long n_flat,
                           const float* sigma, int steps, int k, int* out, cudaStream_t s) {
  const int used = (k + kLanes - 1) / kLanes;
  const int threads = (used + 31) / 32 * 32;
  gaussian_decode_kernel<kLanes><<<1, threads, 0, s>>>(x, g, flat, n_flat, sigma, steps, k, out);
  return static_cast<int>(cudaGetLastError());
}

int blocks_for(int k, int threads) { return (k + threads - 1) / threads; }

}  // namespace

extern "C" {

// D1. symbols, indexes: [steps * k]; packed: [R][L]; words: [k][cap]
// (zeroed by the caller); counts: [k].
int rans_encode_lanes(const int* symbols, const int* indexes, const int* packed, int L,
                      const int* cdf_length, const int* offset, int steps, int k, int cap,
                      int* words, int* counts, void* stream) {
  if (k <= 0 || steps < 0 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  rans_encode_kernel<<<blocks_for(k, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      symbols, indexes, packed, L, cdf_length, offset, steps, k, cap, words, counts);
  return static_cast<int>(cudaGetLastError());
}

// D2. words: n_words int32; base, x, rp: [k]; indexes, out: [steps * k];
// inverse: [R][65536] int16; packed: [R][L].
int rans_decode_lanes(const int* words, long long n_words, const long long* base, long long* x,
                      long long* rp, const int* indexes, const short* inverse, const int* packed,
                      int L, const int* cdf_length, const int* offset, int steps, int k, int* out,
                      void* stream) {
  if (k <= 0 || steps < 0 || n_words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  rans_decode_kernel<<<blocks_for(k, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      words, n_words, base, x, rp, indexes, inverse, packed, L, cdf_length, offset, steps, k, out);
  return static_cast<int>(cudaGetLastError());
}

// D3. symbols (clamped to the support), sigma: [steps * k]; ws: [steps][k];
// need: [steps][k] bytes; x_out: [k].
int gaussian_encode_lanes(const int* symbols, const float* sigma, int steps, int k, int* ws,
                          unsigned char* need, long long* x_out, void* stream) {
  if (k <= 0 || steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  gaussian_encode_kernel<<<blocks_for(k, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      symbols, sigma, steps, k, ws, need, x_out);
  return static_cast<int>(cudaGetLastError());
}

// D4. x: [k] states; g: [1] stream pointer; flat: n_flat words (n_flat >= k);
// sigma, out: [steps * k]. k up to 8192 (up to 8 lanes per thread).
int gaussian_decode_lanes(long long* x, long long* g, const int* flat, long long n_flat,
                          const float* sigma, int steps, int k, int* out, void* stream) {
  if (k <= 0 || steps < 0 || n_flat < k) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= kMaxThreads) return launch_gaussian_decode<1>(x, g, flat, n_flat, sigma, steps, k, out, s);
  if (k <= 2 * kMaxThreads) return launch_gaussian_decode<2>(x, g, flat, n_flat, sigma, steps, k, out, s);
  if (k <= 4 * kMaxThreads) return launch_gaussian_decode<4>(x, g, flat, n_flat, sigma, steps, k, out, s);
  if (k <= 8 * kMaxThreads) return launch_gaussian_decode<8>(x, g, flat, n_flat, sigma, steps, k, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
