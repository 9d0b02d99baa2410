// Probe of csrc/hopper_wgmma.cuh's conventions on the card: one warpgroup
// loads A and B images by bulk copy, runs k16 steps of wgmma on the
// descriptors it is given and writes D by the documented fragment layout;
// tools/bf16_redesign/ablate.py compares D with A . B^T (exact: the test
// values are multiples of 1/4).
#include "hopper_wgmma.cuh"

template <int N>
__global__ void __launch_bounds__(128) probe_kernel(const bf16* aimg, int abytes, const bf16* bimg,
                                                    int bbytes, float* D, int a_off, int a_lbo,
                                                    int a_sbo, int a_kstep, int b_lbo, int b_sbo,
                                                    int b_kstep, int ksteps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  unsigned char* as = smem;
  unsigned char* bs = smem + ((abytes + 127) / 128) * 128;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar, abytes + bbytes);
    bulk_copy(as, aimg, abytes, &bar);
    bulk_copy(bs, bimg, bbytes, &bar);
  }
  mbar_wait(&bar, 0);
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  wg_hold(d);
  wg_fence();
  for (int ks = 0; ks < ksteps; ++ks) {
    wgmma_bf16<N>(d, wg_desc(as + a_off + ks * a_kstep, a_lbo, a_sbo),
                  wg_desc(bs + ks * b_kstep, b_lbo, b_sbo));
  }
  wg_commit();
  wg_wait<0>();
  wg_hold(d);
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int j = i / 4, e = i % 4;
    const int row = 16 * (t / 32) + (t % 32) / 4 + 8 * (e / 2);
    const int col = 8 * j + 2 * (t % 4) + e % 2;
    D[row * N + col] = d[i];
  }
}

template <int N>
int launch(const bf16* aimg, int abytes, const bf16* bimg, int bbytes, float* D, int a_off,
           int a_lbo, int a_sbo, int a_kstep, int b_lbo, int b_sbo, int b_kstep, int ksteps) {
  const int sm = ((abytes + 127) / 128) * 128 + bbytes;
  cudaFuncSetAttribute(probe_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, sm);
  probe_kernel<N><<<1, 128, sm>>>(aimg, abytes, bimg, bbytes, D, a_off, a_lbo, a_sbo, a_kstep,
                                  b_lbo, b_sbo, b_kstep, ksteps);
  return cudaGetLastError();
}

extern "C" int probe(int n, const bf16* aimg, int abytes, const bf16* bimg, int bbytes, float* D,
                     int a_off, int a_lbo, int a_sbo, int a_kstep, int b_lbo, int b_sbo,
                     int b_kstep, int ksteps) {
#define P(NN) \
  if (n == NN) return launch<NN>(aimg, abytes, bimg, bbytes, D, a_off, a_lbo, a_sbo, a_kstep, b_lbo, b_sbo, b_kstep, ksteps);
  P(8) P(24) P(64) P(96) P(144) P(192)
#undef P
  return -1;
}
