// Micro-benchmark: what a batch of wgmma products costs one SM of the card,
// at the instruction shapes the port's kernels use (attn_fwd_kernel's S and
// PV products per padded head dim and key tile; conv3x3_kernel's step), with
// one to three warpgroups multiplying at once, waited for at once (depth 0) or
// with one batch left in flight (depth 1). Prints clocks a batch beside the
// tensor cores' peak (2048 bf16 FMA a clock an SM).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/port_bench_wgmma scripts/port_bench_wgmma.cu
//   /tmp/port_bench_wgmma
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdio.h>
#include "../rich_text_to_image_tpu_torch/csrc/wgmma.cuh"
using namespace rtt;

template <int N, int SS, int TB>
__device__ __forceinline__ void mma(float* d, uint64_t da, const uint32_t a[4], uint64_t db) {
  if constexpr (SS) {
    if constexpr (N == 64) wgmma_ss_n64<TB>(d, da, db, 1);
    if constexpr (N == 128) wgmma_ss_n128<TB>(d, da, db, 1);
    if constexpr (N == 160) wgmma_ss_n160<TB>(d, da, db, 1);
  } else {
    if constexpr (N == 48) wgmma_rs_n48<TB>(d, a, db, 1);
    if constexpr (N == 80) wgmma_rs_n80<TB>(d, a, db, 1);
    if constexpr (N == 160) wgmma_rs_n160<TB>(d, a, db, 1);
  }
}

// each warpgroup: REPS x { fence; CHAIN products into one accumulator; commit; wait<DEPTH> }
template <int N, int SS, int TB, int CHAIN, int DEPTH>
__global__ void bench(long long* out, int reps) {
  extern __shared__ unsigned char raw[];
  uint32_t base = (smem_addr(raw) + 1023u) & ~1023u;
  for (int i = threadIdx.x; i < 40960 / 4; i += blockDim.x) reinterpret_cast<uint32_t*>(raw + (base - smem_addr(raw)))[i] = 0;
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t a[4] = {0, 0, 0, 0};
  const uint64_t da = desc_kmajor(base);
  const uint64_t db = TB ? desc_mnmajor(base + 8192, 8192) : desc_kmajor(base + 8192);
  long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CHAIN; ++kk)
      mma<N, SS, TB>(d, da + (kk % 4) * 2, a, db + (TB ? (kk % 4) * 128 : (kk % 4) * 2));
    wgmma_commit();
    wgmma_wait<DEPTH>();
  }
  wgmma_wait<0>();
  fence_regs<N / 2>(d);
  long long t1 = clock64();
  float sum = 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sum += d[i];
  if (threadIdx.x % 128 == 0) out[threadIdx.x / 128] = (t1 - t0) + (sum == 12345.f);
}

template <int N, int SS, int TB, int CHAIN, int DEPTH>
void run(const char* name) {
  long long* dout; cudaMalloc(&dout, 64);
  int smem = 50 * 1024;
  cudaFuncSetAttribute(bench<N, SS, TB, CHAIN, DEPTH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  for (int nwg = 1; nwg <= 3; ++nwg) {
    const int reps = 2000;
    bench<N, SS, TB, CHAIN, DEPTH><<<1, 128 * nwg, smem>>>(dout, reps);
    cudaError_t e = cudaDeviceSynchronize();
    long long h[4] = {0, 0, 0, 0}; cudaMemcpy(h, dout, 32, cudaMemcpyDeviceToHost);
    double clk = (double)h[0] / reps;
    double ideal = CHAIN * (64.0 * N * 16) / 2048.0;  // 2048 FMA a clock an SM
    printf("%-26s N=%3d %s tb=%d chain=%d depth=%d wgs=%d: %.0f clk a group (cuda %d); tensor-ideal for all wgs %.0f -> %.0f%%\n",
           name, N, SS ? "SS" : "RS", TB, CHAIN, DEPTH, nwg, clk, (int)e, ideal * nwg, 100.0 * ideal * nwg / clk);
  }
  cudaFree(dout);
}

int main() {
  run<64, 1, 0, 3, 0>("S d=40 tk=64");
  run<128, 1, 0, 3, 0>("S d=40 tk=128");
  run<128, 1, 0, 5, 0>("S d=80 tk=128");
  run<64, 1, 0, 10, 0>("S d=160 tk=64");
  run<48, 0, 1, 4, 0>("PV d=40 tk=64");
  run<48, 0, 1, 8, 0>("PV d=40 tk=128");
  run<80, 0, 1, 8, 0>("PV d=80 tk=128");
  run<160, 0, 1, 4, 0>("PV d=160 tk=64");
  run<160, 1, 1, 4, 0>("conv 64x160 step");
  run<160, 1, 1, 4, 1>("conv 64x160 step depth1");
  run<128, 1, 0, 3, 1>("S d=40 tk=128 depth1");
  run<80, 0, 1, 8, 1>("PV d=80 tk=128 depth1");
  return 0;
}
