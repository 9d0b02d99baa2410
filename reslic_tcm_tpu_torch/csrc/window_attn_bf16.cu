// Window attention for Hopper (sm_90a) on the bf16 tensor cores: the bf16
// instance of csrc/flash_window_attn.cu's attention-only flavour (WACNN's
// WinBasedAttention, (C, head_dim) = (128, 16) and (192, 24)).
//
// Replaces the Pallas TPU kernel reslic_tcm_tpu/ops/flash_window_attn.py:239
// (flash_window_block / _kernel, pallas_call :335) with with_ln=False,
// mlp=None in its bf16 mode (compute_dtype=bfloat16, the TPU's default). For
// each 8x8 window (T = 64 tokens) of an NHWC float32 map, bf16(.) a round to
// nearest even at the Pallas body's cast points (flash_window_attn.py:93,
// :173, :183, :195), all sums fp32:
//
//   qkv = bf16(x) . bf16(Wqkv) + bqkv    (head_dim^-0.5 folded into q in fp32)
//   per head h: o_h = bf16(softmax(bf16(q_h) bf16(k_h)^T + rel_bias[h] + mask))
//                     . bf16(v_h)
//   out = x + bf16(o) . bf16(Wproj) + bproj
//
// The softmax, the biases and the residual stay fp32; the shifted (SW)
// flavour takes the rolled map and adds -1e9 to the scores of token pairs
// the roll brought together.
//
// What bounds it on this card: per window 2*T*(4*C^2 + 2*T*C) FLOP (22
// MFLOP at C = 192) against 2*T*C*4 bytes of x in and out (96 KB): 150-230
// FLOP per byte, below the 295 where the bf16 tensor cores (989 TFLOP/s)
// meet the 3.35 TB/s memory, so moving x binds it (0.0114 ms a launch of
// 384 windows at C = 192).
//
// The first version (one window a CTA or a cluster, mma.sync, all of W
// streamed by cp.async in slices of 32 k behind block barriers for every
// window: 113 MB of L2 reads a 384-window launch at C = 192) ran at 10% of
// that bound; taking out its W staging saved 20% of its time, its qkv
// product with its staging 40%, the attention core 17%, proj 14%, the load
// and cast of x 7% (tools/bf16_redesign/ablate.py --only=attn). This design:
// 1. W resident. A window belongs to a cluster of K >= 2 CTAs; rank r keeps
//    its heads' rows of Wqkv (heads [r*NH/K, (r+1)*NH/K)) and its output
//    columns' rows of Wproj ([r*C/K, (r+1)*C/K)) in shared memory for the
//    whole launch, loaded once by the copy engine (bulk copies): 147 KB at
//    C = 192, K = 2. W leaves L2 once a CTA.
// 2. Persistent clusters: the grid holds `grid` clusters (the wrapper's
//    choice: as many as are resident on the card at once, at most one a
//    window), each looping over the windows grid apart.
// 3. x ahead of the compute, by the copy engine (one box of the tensor map
//    (C, W, H, B), this rank's columns, fp32): the next window's x lands in
//    v's region once the attention has read v, while proj runs. proj's
//    residual, x again, comes from L2 into registers while the heads'
//    output travels and the product runs.
// 4. The ranks exchange by the copy engine, not by cluster barriers: each
//    rank casts its columns of x into its k-groups of A and pushes them, one
//    bulk copy a peer, into the same k-groups of every peer's A; after the
//    attention it pushes its heads' output (its q columns) there too, over
//    the x that the peer's qkv product has read. Each push is counted on the
//    peer's mbarrier (xready, oready) as bytes; a rank pushes only after the
//    peer has said, by one arrival a warpgroup on the rank's afree_o (qkv
//    has read x) or afree_x (proj has read o), that the region is free.
//    (The first form of this design pulled the peers' data through
//    distributed shared memory between cluster barriers: 0.073 ms a
//    384-window launch at C = 192, against 0.056 by pushes.)
// 5. qkv and proj on wgmma m64nNk16: a window's 64 tokens are a warpgroup's
//    M; two warpgroups take half of each product's columns each, operands in
//    shared memory as [n/8][64][8] bf16 (no swizzle), fp32 accumulators in
//    registers; proj's k steps read o where it lies, this rank's heads in
//    qk, a peer's in A. The epilogues are unrolled per warpgroup, so every
//    tile's place (head; q, k or v) is a constant; the biases sit in shared
//    memory.
// 6. Attention on mma.sync m16n8k16 (bf16_attention.cuh), one warp per
//    (head, 16 query rows), 8 warps: head_dim 24 as a zero-padded second k
//    step. The heads' output overwrites their q (only the warp that read it
//    reads it). A warp runs two tasks at once (head_attention_tasks: each
//    one's latencies under the other's work). A warp's tasks are the same in
//    every window: the rel_bias of its first two stays in registers for the
//    launch (the others' arrive from L2 in their turn). The SW mask's code
//    runs only in the map's last row and column of windows.
//    (Tried and dropped, same bits: four warpgroups, one task a warp,
//    capped the registers at 128 and spilled; the attention's products on
//    wgmma, P from registers, one warpgroup a head, spilled more.)
// 7. Results independent of K, the grid and the card: each output element
//    is one accumulator over the k16 steps of its k range in ascending order,
//    the bias added after; the softmax reduces in a fixed order. On an H100
//    they are also the first version's bits (equal digests at every
//    main-path shape: tools/bf16_redesign/compare.py).
// On an H100 (PERF.md §6) a 384-window launch at C = 192 takes 0.056 ms
// against the first version's 0.116, 20% of the bound; the attention core
// holds 30% of it, the qkv product 14%, the pushes 11%
// (tools/bf16_redesign/ablate.py --only=attn --new).
//
// Interface: plain C, raw pointers, the launch stream; returns the launch's
// error (0 on success).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_attention.cuh"
#include "bf16_mma.cuh"
#include "hopper_wgmma.cuh"
#include "window_attn_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSmemDyn = kSmemPerBlock - 128;  // a block's dynamic shared memory (1 a SM)
constexpr int kThr = 256;  // threads a CTA: two warpgroups
constexpr int kWarpsA = kThr / 32;
constexpr int kGroups = kThr / 128;

__host__ __device__ constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

struct AttnArgs {
  const float* x;
  float* out;
  const bf16* wqkv;   // [C/8][3C][8], rows head by head, q rows pre-scaled
  const float* bqkv;  // [3C] in torch order, q entries pre-scaled
  const bf16* wproj;  // [C/8][C][8]
  const float* bproj;
  const float* relb;  // [C/head_dim][64][64]
  int B, H, W, shifted;
};

// Shared-memory geometry (bytes) of rank r of a cluster of K CTAs.
template <int C, int HD, int K>
struct Attn {
  static constexpr int NH = C / HD;
  static constexpr int HK = NH / K;      // heads a rank
  static constexpr int CK = C / K;       // a rank's channels: its heads' and its output columns
  static constexpr int NQ = 3 * CK / kGroups;  // qkv columns a warpgroup
  static constexpr int NP = CK / kGroups;      // proj columns a warpgroup
  static constexpr int TASKS = 4 * HK / kWarpsA;  // (head, 16 query rows) a warp
  static constexpr int NT = TASKS < 2 ? TASKS : 2;   // tasks run together; the first NT's
                                                     // bias stays in registers
  static constexpr int SLICE = CK / 8 * kLA * 2;  // a rank's k-groups of a [64 x n] operand
  static constexpr int XF_BYTES = kT * CK * 4;    // a rank's columns of x, fp32
  // W: this rank's qkv rows (3 CK) and proj rows (CK), each [C/8][rows][8]
  static constexpr int WQ = 0;
  static constexpr int WP = WQ + C / 8 * 3 * CK * 16;
  // A: bf16(x), a [64 x C] operand, each rank's columns in its k-groups;
  // once the qkv product has read it, each peer's heads' output lands in
  // the peer's k-groups
  static constexpr int A = WP + C / 8 * CK * 16;
  // QK: q | k, a [64 x 2 CK] operand; this rank's heads' output overwrites q
  static constexpr int QK = A + align128(C / 8 * kLA * 2);
  // this rank's qkv biases (by product column) and proj biases, fp32
  static constexpr int BQ = QK + align128(2 * SLICE);
  static constexpr int BP = BQ + 3 * CK * 4;
  // V: v, [64/8][CK][8]; once the attention has read it, the next window's
  // x (this rank's columns, fp32 [64][CK]) lands over it
  static constexpr int V = align128(BP + CK * 4);
  static constexpr int BYTES = V + cmax(kT * CK * 2, XF_BYTES);
  static_assert(K >= 2 && NH * HD == C && NH % K == 0 && CK % 16 == 0 && HD % 8 == 0,
                "heads split evenly in k16 steps over two ranks or more");
  static_assert((4 * HK) % kWarpsA == 0 && TASKS % NT == 0, "whole tasks a warp");
  static_assert(NQ % 8 == 0 && NQ <= 256 && NP % 8 == 0 && CK % 4 == 0, "wgmma widths");
  static_assert(BYTES <= kSmemDyn, "shared memory of a block");
};

// The address of the shared-memory object at p in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}
// One arrival on a peer's mbarrier (peer_addr), after this thread's reads
// and writes so far.
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// `bytes` (a multiple of 16) of this CTA's shared memory at src into a
// peer's at dst (peer_addr) by the copy engine, counted on the peer's
// mbarrier bar (peer_addr) as transaction bytes.
__device__ __forceinline__ void bulk_copy_peer(uint32_t dst, const void* src, uint32_t bytes,
                                               uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// mbar_wait for a barrier that peers arrive on: acquires at cluster scope.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  } while (!done);
}

// The qkv epilogue of warpgroup WG (columns [WG*NQ, (WG+1)*NQ) of this
// rank's product): + bqkv (bq, by product column), q and k into qk, v into
// vs. Every 8-column tile lies in one head and one of q, k, v, so with WG a
// constant each tile's place is one.
template <int C, int HD, int K, int WG>
__device__ __forceinline__ void qkv_epilogue(const float (&acc)[Attn<C, HD, K>::NQ / 2],
                                             const float* bq, bf16* qk, bf16* vs) {
  using S = Attn<C, HD, K>;
  const int lt = threadIdx.x % 128;
  const int r = 16 * (lt / 32) + lt % 32 / 4, t2 = 2 * (lt % 4);
#pragma unroll
  for (int j = 0; j < S::NQ / 8; ++j) {
    const int m0 = WG * S::NQ + 8 * j;  // the tile's first product column
    const int hl = m0 / (3 * HD), seg = m0 % (3 * HD) / HD, d = m0 % HD + t2;
    const float2 b = *reinterpret_cast<const float2*>(bq + m0 + t2);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = r + 8 * hf;
      const float v0 = acc[4 * j + 2 * hf] + b.x, v1 = acc[4 * j + 2 * hf + 1] + b.y;
      if (seg < 2) {
        *reinterpret_cast<uint32_t*>(qk + al(t, seg * S::CK + hl * HD + d)) = pack_bf16(v0, v1);
      } else {
        const int dim = hl * HD + d;
        vs[(t / 8 * S::CK + dim) * 8 + t % 8] = __float2bfloat16_rn(v0);
        vs[(t / 8 * S::CK + dim + 1) * 8 + t % 8] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// out = x + (o . Wproj + bproj) of warpgroup WG's columns [WG*NP, (WG+1)*NP)
// of this rank's: res[u][hf] the residual (x) at this thread's columns of
// tile u, rows r + 8 hf; bp by column; row0, row8: out at this thread's rows
// r and r + 8, this rank's first column.
template <int C, int HD, int K, int WG>
__device__ __forceinline__ void proj_epilogue(const float (&acc)[Attn<C, HD, K>::NP / 2],
                                              const float2 (&res)[Attn<C, HD, K>::NP / 8][2],
                                              const float* bp, float* row0, float* row8) {
  using S = Attn<C, HD, K>;
  const int t2 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int u = 0; u < S::NP / 8; ++u) {
    const int c = WG * S::NP + 8 * u + t2;
    const float2 b = *reinterpret_cast<const float2*>(bp + c);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float2 v;
      v.x = res[u][hf].x + (acc[4 * u + 2 * hf] + b.x);
      v.y = res[u][hf].y + (acc[4 * u + 2 * hf + 1] + b.y);
      *reinterpret_cast<float2*>((hf ? row8 : row0) + c) = v;
    }
  }
}

// out = x + bf16(attn(x)) . bf16(Wproj) + bproj over the windows of the
// batch, window after window on each persistent cluster of K CTAs: rank r
// computes the heads [r*NH/K, (r+1)*NH/K) and the output columns [r*C/K,
// (r+1)*C/K). Each rank pushes its columns of bf16(x), then its heads'
// output, into its k-groups of the peers' A by the copy engine (counted on
// the peer's xready, oready); it writes there only after the peer has said,
// by an arrival on this rank's afree_o (its qkv product has read x) or
// afree_x (its proj product has read o), that the region is free.
template <int C, int HD, int K>
__global__ void __launch_bounds__(kThr, 1)
    window_attn_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const AttnArgs p) {
  using S = Attn<C, HD, K>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t wqbar, wpbar, xbar, xready, oready, afree_x, afree_o;

  const int tid = threadIdx.x, warp = tid / 32, wg = tid / 128, lt = tid % 128;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  bf16* as = reinterpret_cast<bf16*>(smem + S::A);
  const float4* xf = reinterpret_cast<const float4*>(smem + S::V);
  bf16* qk = reinterpret_cast<bf16*>(smem + S::QK);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::V);
  float* bq = reinterpret_cast<float*>(smem + S::BQ);
  float* bp = reinterpret_cast<float*>(smem + S::BP);

  const int nww = p.W / kWin, nwh = p.H / kWin, nwin = nww * nwh;
  const int total = p.B * nwin;
  const int stride = gridDim.x / K;  // clusters
  const int cbase = rank * S::CK;    // this rank's first channel
  const int h0 = rank * S::HK;       // and head
  const int w4 = warp % 4;           // the 16 query rows of this warp's tasks
  bf16* mine = as + cbase / 8 * kLA;  // this rank's k-groups of A
  // x or out at token t of window win, this rank's first column
  auto row_of = [&](auto* base, int win, int t) {
    const int b = win / nwin, wy = win % nwin / nww, wx = win % nww;
    return base + (static_cast<size_t>(b * p.H + wy * kWin + t / kWin) * p.W + wx * kWin +
                   t % kWin) * C + cbase;
  };
  // this rank's columns of window win's x, [64][CK] fp32, into V: one box of
  // the tensor map (C, W, H, B) by the copy engine
  auto fetch_x = [&](int win) {
    if (tid == 0) {
      fence_async_smem();
      mbar_expect_tx(&xbar, S::XF_BYTES);
      tma_load_4d(smem + S::V, &xmap, cbase, win % nww * kWin, win % nwin / nww * kWin,
                  win / nwin, &xbar);
    }
  };
  // this rank's S::SLICE bytes at src into every peer's A (this rank's
  // k-groups), counted on the peer's barrier bar
  auto push = [&](const bf16* src, uint64_t* bar) {
    for (int i = 1; i < K; ++i) {
      const int r = (rank + i) % K;
      bulk_copy_peer(peer_addr(mine, r), src, S::SLICE, peer_addr(bar, r));
    }
  };
  // one arrival of this warpgroup on every peer's barrier bar
  auto arrive_peers = [&](uint64_t* bar) {
    if (lt == 0)
      for (int i = 1; i < K; ++i) mbar_arrive_peer(peer_addr(bar, (rank + i) % K));
  };

  if (tid == 0) {
    mbar_init(&wqbar, 1);
    mbar_init(&wpbar, 1);
    mbar_init(&xbar, 1);
    mbar_init(&xready, 1);
    mbar_init(&oready, 1);
    mbar_init(&afree_x, kGroups * (K - 1));
    mbar_init(&afree_o, kGroups * (K - 1));
    mbar_fence_init();
  }
  cg::this_cluster().sync();  // every rank's barriers are initialised
  int win = blockIdx.x / K;
  if (warp == 0) {  // this rank's W, once: qkv's rows, then proj's (waited for at first use)
    if (tid == 0) {
      mbar_expect_tx(&wqbar, S::WP - S::WQ);
      mbar_expect_tx(&wpbar, S::A - S::WP);
    }
    __syncwarp();
    for (int i = tid; i < C / 8; i += 32)
      bulk_copy(smem + S::WQ + i * 3 * S::CK * 16,
                p.wqkv + (static_cast<size_t>(i) * 3 * C + 3 * cbase) * 8, 3 * S::CK * 16, &wqbar);
    for (int i = tid; i < C / 8; i += 32)
      bulk_copy(smem + S::WP + i * S::CK * 16, p.wproj + (static_cast<size_t>(i) * C + cbase) * 8,
                S::CK * 16, &wpbar);
  }
  fetch_x(win);
  // a task's rel_bias at this thread's rows and keys (row_softmax's bias(hf,
  // u)); a warp's tasks are the same in every window, so its first NT
  // tasks' stay in registers for the launch
  auto bias_at = [&](int task, int hf, int u) {
    return __ldg(reinterpret_cast<const float2*>(
        p.relb + (static_cast<size_t>(h0 + task / 4) * kT + task % 4 * 16 + lt % 32 / 4 + 8 * hf) *
                     kT + 8 * u + 2 * (lt % 4)));
  };
  float2 held[S::NT][2][8];
#pragma unroll
  for (int i = 0; i < S::NT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int u = 0; u < 8; ++u) held[i][hf][u] = bias_at(warp + i * kWarpsA, hf, u);
  for (int m = tid; m < 3 * S::CK; m += kThr) {  // product column m: head m / 3HD, q | k | v
    const int hl = m / (3 * HD), seg = m % (3 * HD) / HD;
    bq[m] = p.bqkv[seg * C + (h0 + hl) * HD + m % HD];
  }
  for (int c = tid; c < S::CK; c += kThr) bp[c] = p.bproj[cbase + c];
  __syncthreads();

  for (int j = 0; win < total; ++j, win += stride) {
    if (tid == 0) {  // this window's bytes from the peers
      mbar_expect_tx(&xready, (K - 1) * S::SLICE);
      mbar_expect_tx(&oready, (K - 1) * S::SLICE);
    }
    // bf16(x) of this rank's columns into its k-groups of A, once every peer
    // has taken the last window's (its proj product has read this rank's o,
    // pushed after them); then into the peers' A
    mbar_wait(&xbar, j & 1);
    if (j > 0) mbar_wait_cluster(&afree_x, (j - 1) & 1);
    constexpr int NX = kT * S::CK / 4;  // float4 chunks
    constexpr int NCH = (NX + kThr - 1) / kThr;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int q = tid + i * kThr;
      if (NX % kThr != 0 && q >= NX) break;
      const float4 xv = xf[q];
      uint2 v;
      v.x = pack_bf16(xv.x, xv.y);
      v.y = pack_bf16(xv.z, xv.w);
      *reinterpret_cast<uint2*>(as + al(q / (S::CK / 4), cbase + q % (S::CK / 4) * 4)) = v;
    }
    fence_async_smem();
    __syncthreads();
    if (tid == 0) push(mine, &xready);
    mbar_wait(&xready, j & 1);  // the peers' columns are in

    // qkv of this rank's heads: warpgroup wg takes columns [wg*NQ, (wg+1)*NQ)
    {
      float acc[S::NQ / 2];
#pragma unroll
      for (int i = 0; i < S::NQ / 2; ++i) acc[i] = 0.f;
      if (j == 0) mbar_wait(&wqbar, 0);
      wg_hold(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        const uint64_t da = wg_desc(as + 2 * kk * kLA, kLA * 2, 128);
        const uint64_t db = wg_desc(smem + S::WQ + (2 * kk * 3 * S::CK + wg * S::NQ) * 16,
                                    3 * S::CK * 16, 128);
        wgmma_bf16<S::NQ>(acc, da, db);
      }
      wg_commit();
      wg_wait<0>();
      wg_hold(acc);
      arrive_peers(&afree_o);  // the peers' x is read: their o may land
      if (wg == 0)
        qkv_epilogue<C, HD, K, 0>(acc, bq, qk, vs);
      else
        qkv_epilogue<C, HD, K, 1>(acc, bq, qk, vs);
    }
    __syncthreads();

    // attention: warp w takes (head, 16 query rows) tasks w, w + 8, ...; o_h
    // overwrites q_h
    const int wy = win % nwin / nww, wx = win % nww;
    const bool last_row = p.shifted && wy == nwh - 1;
    const bool last_col = p.shifted && wx == nww - 1;
    auto attend = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < S::TASKS; i += S::NT) {  // tasks warp + 8 i, NT of them at once
        int hofs[S::NT];
#pragma unroll
        for (int n = 0; n < S::NT; ++n) hofs[n] = (warp + (i + n) * kWarpsA) / 4 * HD;
        if (i == 0) {
          head_attention_tasks<HD, S::CK, S::NT, decltype(masked)::value>(
              qk, vs, hofs, [&](int n, int hf, int u) { return held[n][hf][u]; }, qk, hofs, w4,
              last_row, last_col);
        } else {
          head_attention_tasks<HD, S::CK, S::NT, decltype(masked)::value>(
              qk, vs, hofs,
              [&](int n, int hf, int u) { return bias_at(warp + (i + n) * kWarpsA, hf, u); }, qk,
              hofs, w4, last_row, last_col);
        }
      }
    };
    if (last_row || last_col)  // only the map's last row and column of windows are masked
      attend(std::true_type{});
    else
      attend(std::false_type{});
    fence_async_smem();
    __syncthreads();  // v is dead: the next window's x lands over it meanwhile
    if (win + stride < total) fetch_x(win + stride);
    // proj's residual, x at this thread's rows and columns, from L2 while
    // the heads' output travels and the product runs
    const int r = 16 * (lt / 32) + lt % 32 / 4;
    float2 res[S::NP / 8][2];
#pragma unroll
    for (int u = 0; u < S::NP / 8; ++u)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        res[u][hf] = __ldg(reinterpret_cast<const float2*>(
            row_of(p.x, win, r + 8 * hf) + wg * S::NP + 8 * u + 2 * (lt % 4)));
    // this rank's heads' output (its q columns) into the peers' A, once
    // their qkv product has read x there
    if (tid == 0) {
      mbar_wait_cluster(&afree_o, j & 1);
      push(qk, &oready);
    }
    mbar_wait(&oready, j & 1);  // the peers' heads' output is in

    // out[:, this rank's columns] = x + (o . Wproj + bproj): warpgroup wg
    // takes columns [wg*NP, (wg+1)*NP); k step s reads o's channels
    // 16s..16s+15 where they lie: this rank's in qk, a peer's in A
    {
      float acc[S::NP / 2];
#pragma unroll
      for (int i = 0; i < S::NP / 2; ++i) acc[i] = 0.f;
      if (j == 0) mbar_wait(&wpbar, 0);
      wg_hold(acc);
      wg_fence();
#pragma unroll
      for (int s = 0; s < C / 16; ++s) {
        const bf16* o = s * 16 / S::CK == rank ? qk + s * 16 % S::CK / 8 * kLA
                                              : as + s * 2 * kLA;
        const uint64_t da = wg_desc(o, kLA * 2, 128);
        const uint64_t db =
            wg_desc(smem + S::WP + (2 * s * S::CK + wg * S::NP) * 16, S::CK * 16, 128);
        wgmma_bf16<S::NP>(acc, da, db);
      }
      wg_commit();
      wg_wait<0>();
      wg_hold(acc);
      if (win + stride < total) arrive_peers(&afree_x);  // the peers' o is read
      float* out0 = row_of(p.out, win, r);
      float* out8 = row_of(p.out, win, r + 8);
      if (wg == 0)
        proj_epilogue<C, HD, K, 0>(acc, res, bp, out0, out8);
      else
        proj_epilogue<C, HD, K, 1>(acc, res, bp, out0, out8);
    }
  }
  cg::this_cluster().sync();  // no peer copies into or arrives here after
}

template <int C, int HD, int K>
cudaError_t configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], int grid,
                      cudaStream_t stream) {
  using S = Attn<C, HD, K>;
  cudaError_t e = cudaFuncSetAttribute(window_attn_bf16_kernel<C, HD, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (e != cudaSuccess) return e;
  cfg = {};
  cfg.gridDim = dim3(grid * K, 1, 1);
  cfg.blockDim = dim3(kThr, 1, 1);
  cfg.dynamicSmemBytes = S::BYTES;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int C, int HD, int K>
cudaError_t launch_attn(const AttnArgs& a, int grid, cudaStream_t stream) {
  // x as a tensor (C, W, H, B) read in boxes of a rank's channels x 8 x 8
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(a.W),
                              static_cast<cuuint64_t>(a.H), static_cast<cuuint64_t>(a.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 4,
                                 static_cast<cuuint64_t>(a.W) * C * 4,
                                 static_cast<cuuint64_t>(a.H) * a.W * C * 4};
  const cuuint32_t box[4] = {Attn<C, HD, K>::CK, kWin, kWin, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (fn(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(a.x), dims, strides, box,
         unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<C, HD, K>(cfg, attr, grid, stream);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, window_attn_bf16_kernel<C, HD, K>, xmap, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The clusters of the instance that the card holds at once.
template <int C, int HD, int K>
int max_clusters() {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<C, HD, K>(cfg, attr, 1, nullptr);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, window_attn_bf16_kernel<C, HD, K>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Instances (C, head_dim, K): ops/flash_window_attn.py::ATTN_CLUSTERS_BF16 for
// each (C, head_dim) of KERNEL_SHAPES_ATTN. At C = 192 a rank's W needs K >= 2;
// at C = 128 one CTA a window ran slower than two at every size measured.
#define ATTN_BF16_INSTANCES(X) \
  X(128, 16, 2) X(128, 16, 4) X(192, 24, 2) X(192, 24, 4)

}  // namespace

extern "C" {

// x, out: [B][H][W][C] float32 (H, W multiples of 8), 16-byte aligned, not
// overlapping. wqkv: bf16 [C/8][3C][8] (input group, output, 8 inputs) with
// the q rows pre-scaled and the outputs head by head (head h's q, k, v rows
// at 3*h*head_dim, ...); wproj: bf16 [C/8][C][8]; bqkv: [3C] in torch order
// with the q entries pre-scaled; bproj: [C]; relb: [C/head_dim][64][64]
// (float32). cluster: CTAs a window, one of ATTN_BF16_INSTANCES' K for (C,
// head_dim); grid: clusters launched, 1 to B*H*W/64 (each takes every
// grid-th window); the result depends on neither.
int window_attention_block_bf16(const float* x, float* out, const bf16* wqkv,
                                const float* bqkv, const bf16* wproj, const float* bproj,
                                const float* relb, int B, int H, int W, int C, int head_dim,
                                int cluster, int grid, int shifted, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0 || H % kWin != 0 || W % kWin != 0 || B <= 0 || grid <= 0 ||
      grid > B * (H / kWin) * (W / kWin))
    return cudaErrorInvalidValue;
  const AttnArgs a{x, out, wqkv, bqkv, wproj, bproj, relb, B, H, W, shifted};
#define ATTN_CASE(c, hd, k) \
  if (C == c && head_dim == hd && cluster == k) return launch_attn<c, hd, k>(a, grid, s);
  ATTN_BF16_INSTANCES(ATTN_CASE)
#undef ATTN_CASE
  return cudaErrorInvalidValue;
}

// The clusters of the instance (C, head_dim, cluster) resident on the current
// device at once (the default grid's cap), or -(the CUDA error).
int window_attention_bf16_max_clusters(int C, int head_dim, int cluster) {
#define ATTN_CASE(c, hd, k) \
  if (C == c && head_dim == hd && cluster == k) return max_clusters<c, hd, k>();
  ATTN_BF16_INSTANCES(ATTN_CASE)
#undef ATTN_CASE
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
