// Micro-benchmark: what one tile of attn_fwd_kernel's online softmax costs
// one SM of the card, with no product beside it: one warp of 32 threads
// holds 32 scores a thread (a 16-row x 64-key block), and 1 to 4 warps run
// on each of the SM's four schedulers. Variants: the kernel's own (exp2 on
// the special-function units, cvt.rn.bf16x2 for the probabilities), without
// the conversion, with the conversion done by integer adds and a byte
// permute, with a half, a third or a quarter of the exponentials taken by a
// degree-3 polynomial on the FMA units, without the row sum (as when the
// P V product sums the probabilities into a column of ones), and with two
// exponentials an instruction: ex2.approx.f16x2 on the arguments rounded to
// f16 (then widened for the sum and packed to bf16), or ex2.approx.ftz.bf16x2
// on arguments rounded to bf16 (the result is P's bf16 pair), each with and
// without the row sum. Prints clocks a tile beside the special-function
// units' floor (16 exp2 a clock an SM); the instructions the packed forms
// compile to show in `cuobjdump -sass` (MUFU.EX2 lines).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/port_bench_softmax scripts/port_bench_softmax.cu
//   /tmp/port_bench_softmax
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdio.h>
#include "../rich_text_to_image_tpu_torch/csrc/wgmma.cuh"
using namespace rtt;

constexpr int TK = 64;
enum Mode { KERNEL, NO_PACK, INT_PACK, POLY_HALF, POLY_THIRD, POLY_QUARTER,
            NO_SUM, F16X2, F16X2_NO_SUM, BF16X2, BF16X2_NO_SUM };

// 2^a, 2^b with one instruction: the arguments rounded to f16 (f16x2) or
// bf16 (bf16x2); returns the pair as it comes out, b in the high half.
__device__ __forceinline__ uint32_t ex2_f16x2(float a, float b) {
  uint32_t x, y;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(x) : "f"(b), "f"(a));
  asm("ex2.approx.f16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t ex2_bf16x2(float a, float b) {
  uint32_t x, y;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(x) : "f"(b), "f"(a));
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void f16x2_to_f32(uint32_t x, float& a, float& b) {
  asm("{\n.reg .f16 lo, hi;\nmov.b32 {lo, hi}, %2;\n"
      "cvt.f32.f16 %0, lo;\ncvt.f32.f16 %1, hi;\n}\n"
      : "=f"(a), "=f"(b) : "r"(x));
}

// 2^x for x <= 0 on the FMA units: the nearest integer through the float
// format's magic number, a degree-3 polynomial on [-0.5, 0.5] (relative
// error 7.5e-5), the integer added to the exponent.
__device__ __forceinline__ float poly_exp2(float x) {
  x = fmaxf(x, -125.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  float p = fmaf(0.05517167f, f, 0.24261113f);
  p = fmaf(p, f, 0.69326097f);
  p = fmaf(p, f, 0.99992806f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
}

template <int MODE>
__global__ void bench(long long* out, const float* in, float* sink, int reps) {
  float s[TK / 2];
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) s[i] = in[threadIdx.x + i * 32];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  uint32_t x = 0;
  const float scale = 0.2f;
  constexpr int EVERY = MODE == POLY_HALF ? 2 : MODE == POLY_THIRD ? 3
                        : MODE == POLY_QUARTER ? 4 : 1 << 30;
  __syncthreads();
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < TK / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * scale);
    const float mn1 = fmaxf(m1, quad_max(mx1) * scale);
    const float al0 = fast_exp2(m0 - mn0), al1 = fast_exp2(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
    constexpr bool SUM = MODE != NO_SUM && MODE != F16X2_NO_SUM &&
                         MODE != BF16X2_NO_SUM;
    if constexpr (MODE == F16X2 || MODE == F16X2_NO_SUM) {
#pragma unroll
      for (int i = 0; i < TK / 4; ++i) {
        const float mn = (i & 1) ? -mn1 : -mn0;
        const uint32_t p = ex2_f16x2(fmaf(s[2 * i], scale, mn),
                                     fmaf(s[2 * i + 1], scale, mn));
        float a, b;
        f16x2_to_f32(p, a, b);
        if (SUM) (i & 1 ? ls1 : ls0) += a + b;
        x ^= pack_bf16(a, b);
        s[2 * i] = a;  // the next round's scores
      }
    } else if constexpr (MODE == BF16X2 || MODE == BF16X2_NO_SUM) {
#pragma unroll
      for (int i = 0; i < TK / 4; ++i) {
        const float mn = (i & 1) ? -mn1 : -mn0;
        const uint32_t p = ex2_bf16x2(fmaf(s[2 * i], scale, mn),
                                      fmaf(s[2 * i + 1], scale, mn));
        const float a = __uint_as_float(p << 16);
        if (SUM)
          (i & 1 ? ls1 : ls0) += a + __uint_as_float(p & 0xFFFF0000u);
        x ^= p;
        s[2 * i] = a;
      }
    } else {
#pragma unroll
      for (int i = 0; i < TK / 2; ++i) {
        const float e = fmaf(s[i], scale, (i & 2) ? -mn1 : -mn0);
        s[i] = i % EVERY == EVERY - 1 ? poly_exp2(e) : fast_exp2(e);
      }
      if (SUM) {
#pragma unroll
        for (int i = 0; i < TK / 8; ++i) {
          ls0 += s[4 * i] + s[4 * i + 1];
          ls1 += s[4 * i + 2] + s[4 * i + 3];
        }
      }
#pragma unroll
      for (int i = 0; i < TK / 4; ++i) {
        if (MODE == INT_PACK)
          x ^= __byte_perm(__float_as_uint(s[2 * i]) + 0x8000u,
                           __float_as_uint(s[2 * i + 1]) + 0x8000u, 0x7632);
        else if (MODE != NO_PACK)
          x ^= pack_bf16(s[2 * i], s[2 * i + 1]);
      }
    }
    l0 = l0 * al0 + ls0;
    l1 = l1 * al1 + ls1;
    m0 = mn0;
    m1 = mn1;
  }
  const long long t1 = clock64();
  float sum = l0 + l1 + m0 + m1;
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) sum += s[i];
  sink[threadIdx.x] = sum + x;
  if (threadIdx.x == 0) out[0] = t1 - t0;
}

template <int MODE>
void run(const char* name) {
  long long* dout;
  float *din, *dsink;
  cudaMalloc(&dout, 8);
  cudaMalloc(&din, 1024 * TK * 4);
  cudaMalloc(&dsink, 4096);
  cudaMemset(din, 0, 1024 * TK * 4);
  for (int warps = 1; warps <= 4; ++warps) {
    const int reps = 2000;
    bench<MODE><<<1, 128 * warps>>>(dout, din, dsink, reps);
    const cudaError_t e = cudaDeviceSynchronize();
    long long h = 0;
    cudaMemcpy(&h, dout, 8, cudaMemcpyDeviceToHost);
    printf("%-36s warps a scheduler %d: %.0f clk a tile (cuda %d); floor of "
           "%d exp2 a warp on the special-function units %d clk\n",
           name, warps, (double)h / reps, (int)e, TK / 2 + 2,
           warps * (TK / 2 + 2) * 8);
  }
  cudaFree(dout);
  cudaFree(din);
  cudaFree(dsink);
}

int main() {
  run<KERNEL>("as in the kernel (exp2, cvt pack)");
  run<NO_PACK>("without the bf16 conversion");
  run<INT_PACK>("conversion by iadd and prmt");
  run<POLY_HALF>("half of exp2 by polynomial");
  run<POLY_THIRD>("a third of exp2 by polynomial");
  run<POLY_QUARTER>("a quarter of exp2 by polynomial");
  run<NO_SUM>("without the row sum (ones column)");
  run<F16X2>("ex2.approx.f16x2, two a instruction");
  run<F16X2_NO_SUM>("ex2.approx.f16x2, no row sum");
  run<BF16X2>("ex2.approx.ftz.bf16x2, two a instruction");
  run<BF16X2_NO_SUM>("ex2.approx.ftz.bf16x2, no row sum");
  return 0;
}
