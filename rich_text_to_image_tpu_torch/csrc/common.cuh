// Building blocks shared by the package's Hopper kernels (sm_90a): the
// commit and wait of asynchronous copies, bf16 packing, the quad reductions
// and the output store of the attention kernels, and the head-dim dispatch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows r0 (= o[.][0..1]) and r0 + 8 (= o[.][2..3]) of O, times inv0 / inv1.
template <int DP>
__device__ __forceinline__ void store_out(bf16* o_base, long long stride_s,
                                          const float o[DP / 8][4], int r0,
                                          int sq, int d, int tig, float inv0,
                                          float inv1) {
#pragma unroll
  for (int db = 0; db < DP / 8; ++db) {
    const int c = db * 8 + tig * 2;
    if (c >= d) continue;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(o_base + (long long)r0 * stride_s + c) =
          pack_bf16(o[db][0] * inv0, o[db][1] * inv0);
    if (r0 + 8 < sq)
      *reinterpret_cast<uint32_t*>(o_base + (long long)(r0 + 8) * stride_s + c) =
          pack_bf16(o[db][2] * inv1, o[db][3] * inv1);
  }
}

struct Strides {
  long long b, h, s;
};

// The padded head dims the attention kernels are instantiated for: a head
// dim d (a multiple of 8, at most 160) runs at the smallest of them >= d.
// They are the padded head dims of the SD-1.5 UNet (40, 80, 160), the
// SDXL UNet's 64 (every SDXL head), which is one 128-byte swizzle row of
// bf16 and so needs no padding, and FLUX.1's 128 (two such rows); another
// model's head dim gets its own instantiation when a path brings it.
#define RTT_DISPATCH(FN, ...)                                        \
  if (d <= 48) return (int)FN<48>(__VA_ARGS__);                      \
  if (d <= 64) return (int)FN<64>(__VA_ARGS__);                      \
  if (d <= 80) return (int)FN<80>(__VA_ARGS__);                      \
  if (d <= 128) return (int)FN<128>(__VA_ARGS__);                    \
  if (d <= 160) return (int)FN<160>(__VA_ARGS__);                    \
  return (int)cudaErrorInvalidValue;

}  // namespace rtt
