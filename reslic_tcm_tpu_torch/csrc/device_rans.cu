// The device coder's lane coders for Hopper (sm_90a): interleaved rANS with
// 32-bit states, 16-bit renormalisation words and 16-bit probabilities, the
// scheme of reslic_tcm_tpu/coding/device_rans.py and analytic_rans.py.
//
// Replaces no Pallas kernel: the JAX package runs these lane loops as
// lax.scan programs. Four kernels, each beside a plain PyTorch version in
// coding/device_rans.py and coding/analytic_rans.py:
//
//   D1 rans_encode_kernel     encode_interleaved (packed-table variant)
//   D2 rans_decode_kernel     decode_segment (inverse-table variant's bits)
//   D3 gaussian_encode_kernel encode_gaussian_grouped's lane walk
//   D4 gaussian_decode_kernel decode_gaussian_grouped_segment
//
// What bounds them on this card: neither bytes nor operations. A lane is a
// chain of dependent state updates, one per step (480 steps for a 768x512
// TCM-S image at k=1024), and only k lanes run at once, so a launch's time
// is the chain's latency. Each kernel takes off the chain whatever does not
// depend on the state:
//
//   D1 splits a CTA into groups of producer warps, each of which looks up
//   each symbol's table entry and the reciprocal of its freq for its own
//   slot of a ring of tiles (steps x lanes) in shared memory, so that the
//   groups' loads overlap, and one walker warp, which runs the integer
//   chain over the tiles (a thread per lane): a compare, a shift, and a
//   quotient from a high multiply with one correction in place of an
//   integer divide. It writes each lane's words straight into its row (no
//   compaction pass).
//
//   D2 finds each symbol by a short search in shared memory in place of the
//   inverse table's 8-24 MB gather: a CTA stages the launch's search table
//   (each row's entries back to back and a bucket index of 256 buckets a
//   row, 143 KB for y's 64 rows) with cp.async while its lanes load their
//   carry; a thread per lane then reads its bucket, searches the few
//   entries the bucket spans and takes the entry it lands on. Each lane
//   holds its next two words in registers and copies its indexes into
//   shared memory a chunk of kChunk steps ahead, so neither read is on the
//   chain. A table too large for shared memory is read where it lies, with
//   the same bits.
//
//   D3 splits a CTA into producer warps, which compute each symbol's
//   (start, freq) for tiles of steps x lanes into a ring in shared memory,
//   and one walker warp, which runs the integer chain over the tiles (a
//   thread per lane); named barriers hand the tiles over. Small CTAs of 8
//   lanes spread the producers' erf work over the card.
//
//   D4 reads one grouped stream in lane order, so its lanes share a word
//   pointer: the lanes are spread over a thread-block cluster of K CTAs,
//   which exchange their per-step counts of renormalising lanes through
//   distributed shared memory behind one cluster barrier a step. A thread
//   serves one lane (up to 16,384 lanes on 16 CTAs) or, beyond that,
//   several consecutive lanes whose states it keeps in global memory; it
//   searches each lane's bin in halvings that stop when the bin is found;
//   with a lane a thread the next step's parameters are computed while the
//   barrier waits.
//
// D3 divides with exact integer / and %, D1 with its reciprocal: both give
// the quotient of JAX's float estimate with its two corrections.
//
// Bits: the analytic boundaries must equal XLA's float32 arithmetic bit for
// bit, erf included (xla_erf: clamp, then x * alpha(x^2) / beta(x^2), each
// Horner step one fused multiply-add). Every step is written with a
// rounding intrinsic (__fmaf_rn for the Horner steps, __fmul_rn, __fadd_rn,
// __fsub_rn and __fdiv_rn for the rest) so that nvcc's default --fmad=true
// contracts nothing; the build must not use -use_fast_math. D4's search
// order differs from JAX's 11 halvings and finds the same bin, the last s
// with B(s) <= cf, because B is non-decreasing in s: B(s) = raw(s) + s,
// and float32 Phi's rounding can lower raw by at most one from one bin to
// the next (then B(s + 1) == B(s), a bin of width zero).
// tests/test_torch_port_analytic_search.py checks both on the CPU.
//
// Tensors (all from the wrapper, coding/device_kernels.py): symbols,
// indexes, words and counts int32 (a word is a value in [0, 2^16)); CDF
// lengths and offsets int32; the packed table int32 [R][L] holding uint32
// start << 16 | freq; D2's search table one int32 array
// (coding/device_rans.py::search_table); lane states and read pointers
// int64 (a state is a uint32 value).
//
// Interface: plain C, raw pointers, the launch stream; each function returns
// cudaGetLastError() of its launch (0 on success).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kRansL = 1u << 16;
constexpr uint32_t kMask16 = 0xFFFFu;
constexpr int kTotal = 1 << 16;
constexpr int kCmax = 511;
constexpr int kMaxThreads = 1024;

// Named barriers (id 0 is __syncthreads'): in D1 and D3, tile slot r of a
// ring of R is full behind barrier 1 + r and empty behind barrier 1 + R + r.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------ D1: encode ------------------------------

// A CTA of D1 codes kEncLanes lanes in tiles of kEncDepth steps; kEncRing
// tiles are in flight, each slot of the ring filled by its own group of
// kEncProducers producer warps, so that the groups' loads overlap.
constexpr int kEncLanes = 32;
constexpr int kEncDepth = 32;
constexpr int kEncProducers = 4;
constexpr int kEncRing = 4;
constexpr int kGroupThreads = kEncProducers * 32;
constexpr int kEncThreads = kEncRing * kGroupThreads + 32;
constexpr int kSlotThreads = kGroupThreads + 32;  // a slot's barriers: its group and the walker
constexpr int kPer = kEncDepth / kEncProducers;  // a producer thread's elements a tile

// The quotient x / freq for any uint32 x and freq in [1, 65535], from
// m = 0xFFFFFFFF / freq: m >= 2^32 / freq - 1, so x * m / 2^32 lies in
// (x / freq - 1, x / freq] and its floor is the quotient or one less; one
// correction on the remainder makes it exact
// (tests/test_torch_port_table_lanes.py checks every freq).
__device__ __forceinline__ uint32_t put(uint32_t x, uint32_t start, uint32_t freq, uint32_t m) {
  uint32_t q = __umulhi(x, m);
  uint32_t r = x - q * freq;
  if (r >= freq) {
    ++q;
    r -= freq;
  }
  return (q << 16) | (r + start);
}

// A CTA codes kEncLanes lanes (lanes blockIdx.x * kEncLanes on) walking
// the steps in reverse. Producer group g (warps g * kEncProducers on) looks
// up each symbol's table entry for tiles g, g + kEncRing, ... (kEncDepth
// steps of the CTA's lanes, a warp's lanes a step) into slot g of the ring:
// the entry start << 16 | freq, the reciprocal m of freq and, for an
// escaped symbol, its lane's bit in the step's escape mask. The last warp
// walks the lanes (a thread per lane) over the tiles and writes each
// lane's words in emission order into its row; words past `cap` are
// dropped and counted (the wrapper reports overflow from the count). Only
// the walker's compare, shift and quotient are on the lane's chain; an
// escape (two raw words, then the escape bin) reads its raw symbol.
__global__ void __launch_bounds__(kEncThreads)
rans_encode_kernel(const int* __restrict__ symbols, const int* __restrict__ indexes,
                   const int* __restrict__ packed, int L, const int* __restrict__ cdf_length,
                   const int* __restrict__ offset, int steps, int k, int cap,
                   int* __restrict__ words, int* __restrict__ counts) {
  __shared__ uint32_t tile_sf[kEncRing][kEncDepth][kEncLanes];
  __shared__ uint32_t tile_m[kEncRing][kEncDepth][kEncLanes];
  __shared__ uint32_t tile_esc[kEncRing][kEncDepth];
  const int t = threadIdx.x;
  const int lane0 = blockIdx.x * kEncLanes;
  const int n_tiles = (steps + kEncDepth - 1) / kEncDepth;
  if (t < kEncRing * kGroupThreads) {
    const int slot = t / kGroupThreads, w = (t % kGroupThreads) >> 5;
    const int l = t & 31, lane = lane0 + l;
    for (int i = slot; i < n_tiles; i += kEncRing) {
      if (i >= kEncRing) named_sync(1 + kEncRing + slot, kSlotThreads);
      const int top = steps - 1 - i * kEncDepth;  // the tile's first step
      // the loads of a thread's kPer elements in three rounds, each round's
      // loads independent of one another
      int sym[kPer], idx[kPer], len[kPer], off[kPer];
      bool ok[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int d = w + j * kEncProducers;
        const long long p = static_cast<long long>(top - d) * k + lane;
        ok[j] = d <= top && lane < k;
        sym[j] = ok[j] ? symbols[p] : 0;
        idx[j] = ok[j] ? indexes[p] : 0;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        len[j] = cdf_length[idx[j]];
        off[j] = offset[idx[j]];
      }
      uint32_t sf[kPer];
      bool esc[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int max_value = len[j] - 2;
        int val = sym[j] - off[j];
        esc[j] = ok[j] && (val < 0 || val >= max_value);
        if (esc[j]) val = max_value;
        sf[j] = ok[j] ? static_cast<uint32_t>(packed[static_cast<long long>(idx[j]) * L + val])
                      : 1u;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int d = w + j * kEncProducers;
        if (ok[j]) {
          tile_sf[slot][d][l] = sf[j];
          tile_m[slot][d][l] = 0xFFFFFFFFu / (sf[j] & kMask16);
        }
        const unsigned mask = __ballot_sync(0xffffffffu, esc[j]);
        if (l == 0) tile_esc[slot][d] = mask;
      }
      named_arrive(1 + slot, kSlotThreads);
    }
    return;
  }
  const int l = t - kEncRing * kGroupThreads;
  const int lane = lane0 + l;
  const bool active = lane < k;
  int* row = words + static_cast<long long>(active ? lane : 0) * cap;
  int pos = 0;
  auto emit = [&](uint32_t w) {
    if (pos < cap) row[pos] = static_cast<int>(w);
    ++pos;
  };
  uint32_t x = kRansL;
  for (int i = 0; i < n_tiles; ++i) {
    const int slot = i % kEncRing;
    named_sync(1 + slot, kSlotThreads);
    const int top = steps - 1 - i * kEncDepth;
    const int depth = top + 1 < kEncDepth ? top + 1 : kEncDepth;
    if (active) {
#pragma unroll 4
      for (int d = 0; d < depth; ++d) {
        const uint32_t sf = tile_sf[slot][d][l];
        const uint32_t m = tile_m[slot][d][l];
        const uint32_t start = sf >> 16, freq = sf & kMask16;
        if ((tile_esc[slot][d] >> l) & 1u) {
          // escape: two raw 16-bit words (the state invariant renormalises
          // each); the raw symbol is read where it lies (escapes are rare)
          const uint32_t raw = static_cast<uint32_t>(
              symbols[static_cast<long long>(top - d) * k + lane]);
          emit(x & kMask16);
          x = ((x >> 16) << 16) | (raw & kMask16);
          emit(x & kMask16);
          x = ((x >> 16) << 16) | (raw >> 16);
        }
        // renormalise without a branch: the store is predicated
        const bool out = x >= (freq << 16);
        if (out && pos < cap) row[pos] = static_cast<int>(x & kMask16);
        pos += out;
        x = out ? x >> 16 : x;
        x = put(x, start, freq, m);
      }
    }
    // the producers wait on this slot only for a tile they still have to fill
    if (i + kEncRing < n_tiles) named_arrive(1 + kEncRing + slot, kSlotThreads);
  }
  if (active) {
    emit(x & kMask16);
    emit(x >> 16);
    counts[lane] = pos;
  }
}

// ------------------------------ D2: decode ------------------------------

// D2's table, one int32 array from coding/device_rans.py::search_table:
// rows int4 [R] (entry start, bucket start, cdf_length, offset) from word
// 0, the bucket index uint16 [R][nb] from buckets_at, the entries uint32
// start << 16 | freq from entries_at (a multiple of 4 words each, and in all).
// Bucket j of a row holds the last symbol s with cdf[s] <= j << shift.
constexpr int kMaxSmem = 232448;  // dynamic shared memory a CTA can take
constexpr int kMaxDevices = 64;
constexpr int kChunk = 32;        // steps of indexes a lane stages at a time

__device__ __forceinline__ void cp_async16(int4* dst, const int4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)) : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's cp.async groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Dynamic shared memory of a D2 launch: the table where staged, then each
// lane's two chunks of indexes.
__host__ __device__ constexpr int decode_smem_bytes(int lanes, bool staged, int table_words) {
  return (staged ? table_words * 4 : 0) + 2 * kChunk * lanes * 4;
}

// A thread per lane over one segment; the carry (state, read pointer) is
// read from and written back to device memory, so segments chain. base[lane]
// is where the lane's word 0 lies (lane * cap for per-lane rows, the lane
// offset for a flat stream); reads are clamped into the stream. With
// kStaged the CTA first copies the table into shared memory (cp.async,
// while the lanes load their carry and their next two words); else it
// reads the table where it lies. Each lane copies its own indexes into its
// column of a two-chunk ring in shared memory (cp.async), a chunk ahead of
// its walk, so no global load waits on the chain. Per step the chain is:
// its cf's bucket (two 16-bit loads), a binary search of the entries
// between the bucket's symbol and the next bucket's (none where they are
// equal), the entry, the state update and, where it renormalises, the word
// already in a register. The symbol is the last s with cdf[s] <= cf, what
// the inverse table holds, because each row is non-decreasing.
template <int kLanes, bool kStaged>
__global__ void __launch_bounds__(kLanes)
rans_decode_kernel(const int* __restrict__ words, long long n_words,
                   const long long* __restrict__ base, long long* __restrict__ x_io,
                   long long* __restrict__ rp_io, const int* __restrict__ indexes,
                   const int* __restrict__ table, int table_words, int buckets_at,
                   int entries_at, int shift, int steps, int k, int* __restrict__ out) {
  extern __shared__ int4 smem[];
  const int t = threadIdx.x;
  const int lane = blockIdx.x * kLanes + t;
  const bool active = lane < k;
  int* ring = reinterpret_cast<int*>(smem) + (kStaged ? table_words : 0) + t;
  const int n_chunks = (steps + kChunk - 1) / kChunk;
  // this lane's indexes of chunk c into ring slot c & 1 (its column)
  auto stage = [&](int c) {
    if (active && c < n_chunks) {
      const int s0 = c * kChunk;
      const int depth = min(kChunk, steps - s0);
      int* dst = ring + (c & 1) * kChunk * kLanes;
      for (int d = 0; d < depth; ++d)
        cp_async4(dst + d * kLanes, indexes + static_cast<long long>(s0 + d) * k + lane);
    }
    cp_async_commit();
  };
  if constexpr (kStaged) {
    const int4* src = reinterpret_cast<const int4*>(table);
    for (int i = t; i < table_words / 4; i += kLanes) cp_async16(smem + i, src + i);
  }
  stage(0);
  const long long b = active ? base[lane] : 0;
  uint32_t x = active ? static_cast<uint32_t>(x_io[lane]) : 0u;
  long long rp = active ? rp_io[lane] : 0;
  auto read = [&](long long r) -> uint32_t {
    long long i = b + (r > 0 ? r : 0);
    if (i > n_words - 1) i = n_words - 1;
    return static_cast<uint32_t>(words[i]);
  };
  // w0 is the word at rp, w1 the one at rp - 1: the next two a lane reads
  uint32_t w0 = 0, w1 = 0;
  if (active) {
    w0 = read(rp);
    w1 = read(rp - 1);
  }
  const int* tab = table;
  if constexpr (kStaged) {
    cp_async_wait<0>();
    __syncthreads();
    tab = reinterpret_cast<const int*>(smem);
  }
  if (!active) return;
  const int4* rows = reinterpret_cast<const int4*>(tab);
  const unsigned short* buckets = reinterpret_cast<const unsigned short*>(tab + buckets_at);
  const uint32_t* entries = reinterpret_cast<const uint32_t*>(tab + entries_at);
  auto take = [&]() {
    x = (x << 16) | w0;
    --rp;
    w0 = w1;
    w1 = read(rp - 1);
  };
  auto get_bits16 = [&]() -> uint32_t {
    const uint32_t val = x & kMask16;
    x >>= 16;
    if (x < kRansL) take();
    return val;
  };
  for (int c = 0; c < n_chunks; ++c) {
    stage(c + 1);
    cp_async_wait<1>();  // this lane's chunk c is in
    const int* idx = ring + (c & 1) * kChunk * kLanes;
    const int s0 = c * kChunk;
    const int depth = min(kChunk, steps - s0);
    int4 row = rows[idx[0]];
#pragma unroll 4
    for (int d = 0; d < depth; ++d) {
      const long long p = static_cast<long long>(s0 + d) * k + lane;
      const int4 next_row = rows[idx[min(d + 1, depth - 1) * kLanes]];
      const uint32_t cf = x & kMask16;
      const int bucket = row.y + static_cast<int>(cf >> shift);
      int lo = buckets[bucket];
      int hi = min(static_cast<int>(buckets[bucket + 1]), row.z - 2);
      const uint32_t* e = entries + row.x;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if ((e[mid] >> 16) <= cf) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const uint32_t sf = e[lo];
      x = (sf & kMask16) * (x >> 16) + cf - (sf >> 16);
      if (x < kRansL) take();
      if (lo == row.z - 2) {
        const uint32_t hi16 = get_bits16();
        const uint32_t lo16 = get_bits16();
        out[p] = static_cast<int>((hi16 << 16) | lo16);
      } else {
        out[p] = lo + row.w;
      }
      row = next_row;
    }
  }
  x_io[lane] = x;
  rp_io[lane] = rp;
}

template <int kLanes, bool kStaged>
int launch_rans_decode(const int* words, long long n_words, const long long* base, long long* x,
                       long long* rp, const int* indexes, const int* table, int table_words,
                       int buckets_at, int entries_at, int shift, int steps, int k, int* out,
                       cudaStream_t s) {
  const int smem = decode_smem_bytes(kLanes, kStaged, table_words);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // the shared-memory limit is raised once per device (a benign race)
  static bool raised[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[device]) {
    e = cudaFuncSetAttribute(rans_decode_kernel<kLanes, kStaged>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[device] = true;
  }
  rans_decode_kernel<kLanes, kStaged><<<(k + kLanes - 1) / kLanes, kLanes, smem, s>>>(
      words, n_words, base, x, rp, indexes, table, table_words, buckets_at, entries_at, shift,
      steps, k, out);
  return static_cast<int>(cudaGetLastError());
}

// Instances (lanes a CTA, staged): coding/device_kernels.py's
// TABLE_DECODE_VARIANTS, in that order.
#define TABLE_DECODE_INSTANCES(X) X(0, 128, true) X(1, 32, false)

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
  q.a = static_cast<float>(kTotal - q.nb);
  q.g0 = phi(__fmul_rn(-q.coff, q.inv_sigma));
  const float g1 = phi(__fmul_rn(q.coff, q.inv_sigma));
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

// A CTA of D3 codes kLanes lanes in tiles of kDepth steps, filled by
// kProducers producer warps: the fastest configuration measured on an H100
// at k=1024 and k=4096 (PERF.md section 6). kRing tiles are in flight
// between the producers and the walker.
constexpr int kLanes = 8;
constexpr int kDepth = 32;
constexpr int kProducers = 8;
constexpr int kRing = 4;
constexpr int kEncodeThreads = (kProducers + 1) * 32;

// A CTA codes kLanes lanes (lanes blockIdx.x * kLanes on). Warps 0 ..
// kProducers - 1 compute each symbol's (start, freq) from sigma and the
// symbol, tile by tile (kDepth steps of the CTA's lanes, the steps in
// reverse as the walk goes), into slot i % kRing of the ring; the last warp
// walks the lanes (a thread per lane) over the tiles: for each step in
// reverse, ws[t][lane] is the low word of the state before step t and
// need[t][lane] whether it was emitted; the wrapper compacts the emitted
// words into decode-read order. Only the walker's compare, shift, divide
// and modulo are on the lane's chain. freq is 0 in a bin of width zero,
// which no encoder of the scheme can code: a producer sets *zero_freq for
// the wrapper to raise on, and the division runs unguarded there, as
// JAX's does, so the bits are those of JAX's coder.
__global__ void __launch_bounds__(kEncodeThreads)
gaussian_encode_kernel(const int* __restrict__ symbols, const float* __restrict__ sigma,
                       int steps, int k, int* __restrict__ ws, unsigned char* __restrict__ need,
                       long long* __restrict__ x_out, int* __restrict__ zero_freq) {
  __shared__ uint32_t tile_start[kRing][kDepth][kLanes];
  __shared__ uint32_t tile_freq[kRing][kDepth][kLanes];
  const int t = threadIdx.x;
  const int lane0 = blockIdx.x * kLanes;
  const int n_tiles = (steps + kDepth - 1) / kDepth;
  if (t < kProducers * 32) {
    for (int i = 0; i < n_tiles; ++i) {
      const int slot = i % kRing;
      if (i >= kRing) named_sync(1 + kRing + slot, kEncodeThreads);
      const int top = steps - 1 - i * kDepth;  // the tile's first step
      for (int e = t; e < kDepth * kLanes; e += kProducers * 32) {
        const int d = e / kLanes, l = e % kLanes;
        if (d <= top && lane0 + l < k) {
          const long long p = static_cast<long long>(top - d) * k + lane0 + l;
          const Params q = coder_params(sigma[p]);
          const int bin = symbols[p] + q.c;
          const uint32_t start = boundary(bin, q);
          const uint32_t freq = boundary(bin + 1, q) - start;
          if (freq == 0) *zero_freq = 1;
          tile_start[slot][d][l] = start;
          tile_freq[slot][d][l] = freq;
        }
      }
      named_arrive(1 + slot, kEncodeThreads);
    }
    return;
  }
  const int l = t - kProducers * 32;
  const int lane = lane0 + l;
  const bool active = l < kLanes && lane < k;
  uint32_t x = kRansL;
  for (int i = 0; i < n_tiles; ++i) {
    const int slot = i % kRing;
    named_sync(1 + slot, kEncodeThreads);
    const int top = steps - 1 - i * kDepth;
    const int depth = top + 1 < kDepth ? top + 1 : kDepth;
    if (active) {
#pragma unroll 4
      for (int d = 0; d < depth; ++d) {
        const uint32_t start = tile_start[slot][d][l];
        const uint32_t freq = tile_freq[slot][d][l];
        const long long p = static_cast<long long>(top - d) * k + lane;
        const bool emit = x >= (freq << 16);
        ws[p] = static_cast<int>(x & kMask16);
        need[p] = emit;
        if (emit) x >>= 16;
        x = ((x / freq) << 16) | ((x % freq) + start);
      }
    }
    // the producers wait on this slot only for a tile they still have to fill
    if (i + kRing < n_tiles) named_arrive(1 + kRing + slot, kEncodeThreads);
  }
  if (active) x_out[lane] = x;
}

// ------------------------- D4: analytic decode -------------------------

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The analytic bin of cf under q: the last s in [0, hi] with B(s) <= cf
// (hi = nb - 1 for a lane, 0 for none), found in halvings of [lo, hi] that
// stop when lo == hi (ceil(log2 nb) of them at most, against JAX's fixed
// 11); B(lo) and B(lo + 1), which start and freq need, are values a halving
// computed (B(0) = 0 and B(nb) = 2^16 where none did).
__device__ __forceinline__ int find_bin(uint32_t cf, int hi, const Params& q, uint32_t& b_lo,
                                        uint32_t& b_hi) {
  int lo = 0;
  b_lo = 0;
  b_hi = static_cast<uint32_t>(kTotal);
  while (lo < hi) {
    const int m = lo + (hi - lo + 2) / 2;
    const uint32_t b = boundary(m, q);
    if (b <= cf) {
      lo = m;
      b_lo = b;
    } else {
      hi = m - 1;
      b_hi = b;
    }
  }
  return lo;
}

// The first half of a step's exchange in D4's form with several lanes a
// thread. cnt: the calling thread's renormalising lanes this step. An
// inclusive scan of the counts over the warp gives each thread's lanes
// before its own in the warp; the warps' counts go to shared memory, the
// CTA's count into slot [par][rank] of every CTA of the cluster
// (distributed shared memory, one thread a peer); then the thread arrives
// on the cluster barrier. Returns the CTA's renormalising lanes before the
// thread's.
template <int K>
__device__ __forceinline__ int publish_counts(cg::cluster_group& cluster, int rank, int cnt,
                                              int par, int* warp_counts, int (*cta_counts)[K]) {
  const int t = threadIdx.x, warp = t >> 5, wl = t & 31;
  const int nwarps = blockDim.x >> 5;
  int incl = cnt;  // the renormalising lanes of the warp's threads up to this one
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (wl >= d) incl += v;
  }
  if (wl == 31) warp_counts[warp] = incl;
  __syncthreads();
  const int wc = wl < nwarps ? warp_counts[wl] : 0;
  const int warp_off = __reduce_add_sync(0xffffffffu, wl < warp ? wc : 0);
  const int cta_count = __reduce_add_sync(0xffffffffu, wc);
  if (t < K) *cluster.map_shared_rank(&cta_counts[par][rank], t) = cta_count;
  cluster_arrive();
  return warp_off + incl - cnt;
}

// The second half, after the cluster barrier's wait: (the renormalising
// lanes of the CTAs before this one, those of the whole cluster).
template <int K>
__device__ __forceinline__ int2 cluster_counts(int rank, int par, int (*cta_counts)[K]) {
  const int wl = threadIdx.x & 31;
  const int cc = wl < K ? cta_counts[par][wl] : 0;
  return make_int2(__reduce_add_sync(0xffffffffu, wl < rank ? cc : 0),
                   __reduce_add_sync(0xffffffffu, cc));
}

// D4's two forms: a thread a lane, its state and parameters in registers
// (the kernel's only form while the wrapper took at most 8192 lanes, kept
// line for line but for its search, now find_bin, so that its time
// stays), wherever a CTA of ceil(k / K) lanes fits in kMaxThreads
// threads, that is every k up to 16,384 on 16 CTAs: ptxas (sm_90a) gives
// it 32 of the 64 registers a thread has at 1024 threads, no spill, so the
// 8192 lanes that the wrapper once allowed were its own limit, not the
// kernel's; beyond that, ceil(per_cta / kMaxThreads) consecutive lanes a
// thread, each lane's state kept in x_io and its parameters computed at
// its step (39 registers). Forms holding 2 and 4 lanes a thread in
// registers took as long a lane-step as this one on an H100 (PERF.md
// section 6); with 8 they spilled.
__host__ __device__ constexpr bool one_lane_a_thread(int per_cta) {
  return per_cta <= kMaxThreads;
}

// One stream over a cluster of K CTAs (the grid). CTA rank r holds lanes
// r * per_cta .. (r + 1) * per_cta - 1 and its thread t the lpt of them
// from r * per_cta + t * lpt on (lpt = 1 where kOneLane), so lane order
// runs through the ranks, the threads and each thread's lanes: the
// stream's order. Per step each lane finds its bin (find_bin); then the
// renormalising lanes take consecutive words after the shared stream
// pointer g in lane order: each thread's rank in its CTA comes from the
// warps' counts, the CTA's count goes to every CTA of the cluster, and
// after the cluster barrier each CTA adds the lower ranks' counts for its
// offset and all of them for g (replicated in every CTA).
// Slot parity makes one barrier a step enough: a CTA writes slot s & 1
// again only after the barrier of step s + 1, which every CTA passes only
// after reading step s's counts. A barrier before the first step makes
// sure that every CTA of the cluster runs before any writes into its
// shared memory; the last step's barrier, that none exits while a peer
// still writes there. The window's start is clamped to n_flat - k, as
// XLA's dynamic_slice clamps it. With a lane a thread the next step's sigma
// is read during the search and its parameters computed while the barrier
// waits, and a warp ballot ranks the renormalising lanes; with lanes in
// memory each lane's parameters are computed when it is decoded, its state
// read from and written to x_io, and its renormalising word taken in a
// second pass over the thread's lanes. K and kOneLane are template
// parameters so that each instance is a kernel of its own name (the
// profiler times each).
template <int K, bool kOneLane>
__global__ void __launch_bounds__(kMaxThreads)
gaussian_decode_kernel(long long* __restrict__ x_io, long long* __restrict__ g_io,
                       const int* __restrict__ flat, long long n_flat,
                       const float* __restrict__ sigma, int steps, int k, int per_cta, int lpt,
                       int* __restrict__ out) {
  __shared__ int warp_counts[kMaxThreads / 32];
  __shared__ int cta_counts[2][K];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  long long g = *g_io;
  const long long last_start = n_flat - k;
  if constexpr (kOneLane) {  // the one-lane form, unchanged (its search is find_bin)
    const int t = threadIdx.x;
    const int warp = t >> 5, wl = t & 31;
    const int nwarps = blockDim.x >> 5;
    const int lane = rank * per_cta + t;
    const bool active = t < per_cta && lane < k;
    uint32_t x = active ? static_cast<uint32_t>(x_io[lane]) : 0u;
    Params q{};
    cluster_arrive_relaxed();
    if (active && steps > 0) q = coder_params(sigma[lane]);
    cluster_wait();
    for (int s = 0; s < steps; ++s) {
      const long long p = static_cast<long long>(s) * k + lane;
      const int par = s & 1;
      const bool more = s + 1 < steps;
      float sigma_next = 1.0f;
      if (active && more) sigma_next = sigma[p + k];  // in flight during the search
      const uint32_t cf = x & kMask16;
      uint32_t b_lo, b_hi;
      const int lo = find_bin(cf, active ? q.nb - 1 : 0, q, b_lo, b_hi);
      bool need = false;
      if (active) {
        x = (b_hi - b_lo) * (x >> 16) + cf - b_lo;
        need = x < kRansL;
        out[p] = lo - q.c;
      }
      // the CTA's renormalising lanes: ranks within each warp, then the warps
      const unsigned votes = __ballot_sync(0xffffffffu, need);
      if (wl == 0) warp_counts[warp] = __popc(votes);
      __syncthreads();
      const int wc = wl < nwarps ? warp_counts[wl] : 0;
      const int warp_off = __reduce_add_sync(0xffffffffu, wl < warp ? wc : 0);
      const int cta_count = __reduce_add_sync(0xffffffffu, wc);
      if (t < K) *cluster.map_shared_rank(&cta_counts[par][rank], t) = cta_count;
      cluster_arrive();
      if (active && more) q = coder_params(sigma_next);
      cluster_wait();
      const int2 counts = cluster_counts<K>(rank, par, cta_counts);
      if (need) {
        long long start = g < last_start ? g : last_start;
        if (start < 0) start = 0;
        const int r = counts.x + warp_off + __popc(votes & ((1u << wl) - 1u));
        x = (x << 16) | static_cast<uint32_t>(flat[start + r]);
      }
      g += counts.y;
    }
    if (active) x_io[lane] = x;
  } else {
    const long long first = static_cast<long long>(threadIdx.x) * lpt;  // in the CTA
    const long long lane0 = static_cast<long long>(rank) * per_cta + first;
    // this thread's lanes: fewer than lpt (or none) at the CTA's or the stream's end
    const int n = static_cast<int>(
        max(0LL, min(min(static_cast<long long>(lpt), per_cta - first), k - lane0)));
    cluster_arrive_relaxed();
    cluster_wait();
    for (int s = 0; s < steps; ++s) {
      const long long p = static_cast<long long>(s) * k + lane0;
      const int par = s & 1;
      int cnt = 0;
      for (int j = 0; j < n; ++j) {
        uint32_t x = static_cast<uint32_t>(x_io[lane0 + j]);
        const uint32_t cf = x & kMask16;
        const Params q = coder_params(sigma[p + j]);
        uint32_t b_lo, b_hi;
        const int lo = find_bin(cf, q.nb - 1, q, b_lo, b_hi);
        x = (b_hi - b_lo) * (x >> 16) + cf - b_lo;
        out[p + j] = lo - q.c;
        x_io[lane0 + j] = x;
        cnt += x < kRansL;
      }
      const int before = publish_counts<K>(cluster, rank, cnt, par, warp_counts, cta_counts);
      cluster_wait();
      const int2 counts = cluster_counts<K>(rank, par, cta_counts);
      if (cnt) {
        long long start = g < last_start ? g : last_start;
        if (start < 0) start = 0;
        int r = counts.x + before;
        for (int j = 0; j < n; ++j) {
          const uint32_t x = static_cast<uint32_t>(x_io[lane0 + j]);
          if (x < kRansL) {
            x_io[lane0 + j] = (x << 16) | static_cast<uint32_t>(flat[start + r]);
            ++r;
          }
        }
      }
      g += counts.y;
    }
  }
  if (rank == 0 && threadIdx.x == 0) *g_io = g;
}

template <int K, bool kOneLane>
int launch_gaussian_decode(long long* x, long long* g, const int* flat, long long n_flat,
                           const float* sigma, int steps, int k, int* out, cudaStream_t s) {
  const int per_cta = (k + K - 1) / K;
  const int lpt = kOneLane ? 1 : (per_cta + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((per_cta + lpt - 1) / lpt + 31) / 32 * 32;
  if (threads > kMaxThreads || K > k) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSuccess;
  if (K > 8) {
    e = cudaFuncSetAttribute(gaussian_decode_kernel<K, kOneLane>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gaussian_decode_kernel<K, kOneLane>, x, g, flat, n_flat, sigma,
                         steps, k, per_cta, lpt, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Instances: CTAs in the cluster (coding/device_kernels.py's
// DECODE_CLUSTERS), each in both forms; a launch refuses a cluster larger
// than k.
#define DECODE_INSTANCES(X) X(1) X(2) X(4) X(8) X(16)

int blocks_for(int k, int threads) { return (k + threads - 1) / threads; }

}  // namespace

extern "C" {

// D1. symbols, indexes: [steps * k]; packed: [R][L]; words: [k][cap]
// (zeroed by the caller); counts: [k].
int rans_encode_lanes(const int* symbols, const int* indexes, const int* packed, int L,
                      const int* cdf_length, const int* offset, int steps, int k, int cap,
                      int* words, int* counts, void* stream) {
  if (k <= 0 || steps < 0 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  rans_encode_kernel<<<blocks_for(k, kEncLanes), kEncThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(symbols, indexes, packed, L,
                                                            cdf_length, offset, steps, k, cap,
                                                            words, counts);
  return static_cast<int>(cudaGetLastError());
}

// D2. words: n_words int32; base, x, rp: [k]; indexes, out: [steps * k];
// table: table_words int32 (16-byte aligned, table_words a multiple of 4),
// the search table with its buckets 2^shift cf wide. variant: an index
// into TABLE_DECODE_INSTANCES; a staged variant refuses a table of more
// than kMaxSmem bytes. The result does not depend on the variant.
int rans_decode_lanes(const int* words, long long n_words, const long long* base, long long* x,
                      long long* rp, const int* indexes, const int* table, int table_words,
                      int buckets_at, int entries_at, int shift, int steps, int k, int variant,
                      int* out, void* stream) {
  if (k <= 0 || steps < 0 || n_words <= 0 || table_words <= 0 || table_words % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TABLE_DECODE_CASE(i, lanes, staged)                                                   \
  if (variant == i)                                                                          \
    return launch_rans_decode<lanes, staged>(words, n_words, base, x, rp, indexes, table,    \
                                             table_words, buckets_at, entries_at, shift,     \
                                             steps, k, out, s);
  TABLE_DECODE_INSTANCES(TABLE_DECODE_CASE)
#undef TABLE_DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// D3. symbols (clamped to the support), sigma: [steps * k]; ws: [steps][k];
// need: [steps][k] bytes; x_out: [k]; zero_freq: [1], zeroed by the caller,
// set where a symbol lies in a bin of width zero.
int gaussian_encode_lanes(const int* symbols, const float* sigma, int steps, int k, int* ws,
                          unsigned char* need, long long* x_out, int* zero_freq, void* stream) {
  if (k <= 0 || steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  gaussian_encode_kernel<<<blocks_for(k, kLanes), kEncodeThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(symbols, sigma, steps, k, ws,
                                                                need, x_out, zero_freq);
  return static_cast<int>(cudaGetLastError());
}

// D4. x: [k] states; g: [1] stream pointer; flat: n_flat words (n_flat >= k);
// sigma, out: [steps * k]. cluster: one of DECODE_INSTANCES, at most k; the
// form (a lane a thread, or lanes in memory) follows from k and cluster
// (one_lane_a_thread). The result does not depend on the cluster size.
int gaussian_decode_lanes(long long* x, long long* g, const int* flat, long long n_flat,
                          const float* sigma, int steps, int k, int cluster, int* out,
                          void* stream) {
  if (k <= 0 || steps < 0 || n_flat < k || cluster <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one_lane = one_lane_a_thread((k + cluster - 1) / cluster);
#define DECODE_CASE(c)                                                                        \
  if (cluster == c)                                                                           \
    return one_lane                                                                           \
               ? launch_gaussian_decode<c, true>(x, g, flat, n_flat, sigma, steps, k, out, s) \
               : launch_gaussian_decode<c, false>(x, g, flat, n_flat, sigma, steps, k, out, s);
  DECODE_INSTANCES(DECODE_CASE)
#undef DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
