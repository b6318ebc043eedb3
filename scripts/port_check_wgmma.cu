// Check of csrc/wgmma.cuh on the card: one warpgroup multiplies a 64 x 64
// A by B of N columns, 64 deep, through each wrapper and operand layout the
// port's kernels use (A from shared memory or registers; B K-major, or
// MN-major in one, two or two and a half 64-column chunks; N a part of a
// chunk), with the tiles written to the swizzled places by swz_offset, and
// holds the result against a product on the host. Prints OK or WRONG a case.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/port_check_wgmma scripts/port_check_wgmma.cu
//   /tmp/port_check_wgmma
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdio.h>
#include <stdlib.h>
#include <vector>
#include <math.h>
#include "../rich_text_to_image_tpu_torch/csrc/wgmma.cuh"
using namespace rtt;

template <int N, int SS, int TB>
__device__ __forceinline__ void mma(float* d, uint64_t da, const uint32_t a[4], uint64_t db, int sc) {
  if constexpr (SS) {
    if constexpr (N == 64) wgmma_ss_n64<TB>(d, da, db, sc);
    if constexpr (N == 128) wgmma_ss_n128<TB>(d, da, db, sc);
    if constexpr (N == 160) wgmma_ss_n160<TB>(d, da, db, sc);
  } else {
    if constexpr (N == 48) wgmma_rs_n48<TB>(d, a, db, sc);
    if constexpr (N == 80) wgmma_rs_n80<TB>(d, a, db, sc);
    if constexpr (N == 160) wgmma_rs_n160<TB>(d, a, db, sc);
  }
}

// A [64][64] row-major; B: TB=0 [N][64] row-major, TB=1 [64][N] row-major. D [64][N] fp32
template <int N, int SS, int TB>
__global__ void __launch_bounds__(128) test_kernel(const bf16* A, const bf16* B, float* D) {
  extern __shared__ unsigned char raw[];
  uint32_t base = (smem_addr(raw) + 1023u) & ~1023u;
  unsigned char* sm = raw + (base - smem_addr(raw));
  const int t = threadIdx.x;
  unsigned char* As = sm;            // 64 rows * 128
  unsigned char* Bs = sm + 8192;     // TB=0: N rows*128 ; TB=1: chunks of 64 rows*128
  for (int idx = t; idx < 64 * 8; idx += 128) {
    int r = idx / 8, j = idx % 8;
    *reinterpret_cast<uint4*>(As + swz_offset(r, j)) = *reinterpret_cast<const uint4*>(A + r * 64 + j * 8);
  }
  if (TB == 0) {
    for (int idx = t; idx < N * 8; idx += 128) {
      int r = idx / 8, j = idx % 8;
      *reinterpret_cast<uint4*>(Bs + swz_offset(r, j)) = *reinterpret_cast<const uint4*>(B + r * 64 + j * 8);
    }
  } else {
    for (int idx = t; idx < 64 * (N / 8); idx += 128) {
      int k = idx / (N / 8), jj = idx % (N / 8);
      int c = jj / 8, j = jj % 8;
      *reinterpret_cast<uint4*>(Bs + c * 8192 + swz_offset(k, j)) = *reinterpret_cast<const uint4*>(B + k * N + jj * 8);
    }
  }
  fence_async_smem();
  __syncthreads();
  const int warp = t / 32, lane = t % 32, g = lane >> 2, tig = lane & 3;
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const uint64_t da = desc_kmajor(base);
  const uint64_t db = TB ? desc_mnmajor(base + 8192, 8192) : desc_kmajor(base + 8192);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4] = {0, 0, 0, 0};
    if (!SS) {
      const bf16* ar = A + (warp * 16 + g) * 64 + kk * 16 + tig * 2;
      a[0] = *reinterpret_cast<const uint32_t*>(ar);
      a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * 64);
      a[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * 64 + 8);
    }
    mma<N, SS, TB>(d, da + kk * 2, a, db + (TB ? kk * 128 : kk * 2), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<N / 2>(d);
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    int r = warp * 16 + g, c = i * 8 + tig * 2;
    D[r * N + c] = d[4 * i]; D[r * N + c + 1] = d[4 * i + 1];
    D[(r + 8) * N + c] = d[4 * i + 2]; D[(r + 8) * N + c + 1] = d[4 * i + 3];
  }
}

int bad = 0;

template <int N, int SS, int TB>
void run(const char* name) {
  std::vector<bf16> A(64 * 64), B(64 * N);
  std::vector<float> Af(64 * 64), Bf(64 * N), ref(64 * N), got(64 * N);
  srand(N * 7 + SS * 3 + TB);
  for (int i = 0; i < 64 * 64; ++i) { A[i] = __float2bfloat16(rand() / (float)RAND_MAX - 0.5f); Af[i] = __bfloat162float(A[i]); }
  for (int i = 0; i < 64 * N; ++i) { B[i] = __float2bfloat16(rand() / (float)RAND_MAX - 0.5f); Bf[i] = __bfloat162float(B[i]); }
  for (int m = 0; m < 64; ++m) for (int n = 0; n < N; ++n) {
    float s = 0; for (int k = 0; k < 64; ++k) s += Af[m * 64 + k] * (TB ? Bf[k * N + n] : Bf[n * 64 + k]);
    ref[m * N + n] = s; }
  bf16 *dA, *dB; float* dD;
  cudaMalloc(&dA, A.size() * 2); cudaMalloc(&dB, B.size() * 2); cudaMalloc(&dD, got.size() * 4);
  cudaMemcpy(dA, A.data(), A.size() * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, B.data(), B.size() * 2, cudaMemcpyHostToDevice);
  cudaMemset(dD, 0, got.size() * 4);
  int smem = 1024 + 8192 + 3 * 8192 + 128 * 128;
  cudaFuncSetAttribute(test_kernel<N, SS, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  test_kernel<N, SS, TB><<<1, 128, smem>>>(dA, dB, dD);
  cudaError_t e = cudaDeviceSynchronize();
  cudaMemcpy(got.data(), dD, got.size() * 4, cudaMemcpyDeviceToHost);
  float err = 0; for (int i = 0; i < 64 * N; ++i) err = fmaxf(err, fabsf(got[i] - ref[i]));
  printf("%-28s N=%3d %s tnspB=%d: cuda=%d max_err=%.3e %s\n", name, N, SS ? "SS" : "RS", TB, (int)e, err, err < 1e-3 ? "OK" : "WRONG");
  bad |= !(e == cudaSuccess && err < 1e-3);
  cudaFree(dA); cudaFree(dB); cudaFree(dD);
}

int main() {

  run<64, 1, 0>("ss kmajor");
  run<128, 1, 0>("ss kmajor");
  run<64, 1, 1>("ss mnmajor one chunk");
  run<128, 1, 1>("ss mnmajor two chunks lbo");
  run<160, 1, 1>("ss mnmajor 2.5 chunks lbo");
  run<160, 1, 0>("ss kmajor n160");
  run<48, 0, 1>("rs mnmajor partial");
  run<80, 0, 1>("rs mnmajor 1.25 chunks");
  run<160, 0, 1>("rs mnmajor 2.5 chunks");
  return bad;
}
