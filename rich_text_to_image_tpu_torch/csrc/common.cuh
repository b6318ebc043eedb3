// Building blocks shared by the package's Hopper kernels (sm_90a): the
// bf16 tensor-core product, shared-memory matrix loads, asynchronous
// 16-byte copies, and the fragment-level pieces of the attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rtt {

constexpr int BN = 64;   // keys per score block
constexpr int PAD = 8;   // shared-memory row padding, in elements

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two transposed 8x8 bf16 matrices from shared memory: lanes 0-7 give the
// row addresses of the first, lanes 8-15 of the second. Lane t receives
// rows 2(t%4), 2(t%4)+1 of column t/4: the B fragment of mma16816 for a
// [k][n] row-major tile.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// Four 8x8 matrices; lanes 8j..8j+7 give the row addresses of matrix j and
// register j receives it (transposed in the .trans form).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// As stored: lane t receives columns 2(t%4), 2(t%4)+1 of row t/4. For a
// [m][k] row-major tile these are A fragments, for a [n][k] one B fragments.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// 16 bytes from device to shared memory without passing through registers;
// with valid == false nothing is read and the 16 bytes are zero-filled (src
// must still be an address inside the tensor).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(n)
               : "memory");
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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + ROWS) of one (batch, head) into a [ROWS][DP + PAD]
// tile, by NT threads of which this is thread t; rows >= n_valid and
// head-dim columns >= d are zero-filled.
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(bf16 (*dst)[DP + PAD],
                                          const bf16* src, long long stride_s,
                                          int row0, int n_valid, int d, int t) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  for (int idx = t; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid && c < d)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride_s + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

// The A fragments of 16 query rows, from row r = first row + lane / 4.
template <int DP>
__device__ __forceinline__ void load_q_frags(uint32_t qf[DP / 16][4],
                                             const bf16 (*Qs)[DP + PAD],
                                             int r, int tig) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = ld32(&Qs[r][c]);
    qf[kk][1] = ld32(&Qs[r + 8][c]);
    qf[kk][2] = ld32(&Qs[r][c + 8]);
    qf[kk][3] = ld32(&Qs[r + 8][c + 8]);
  }
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
// They are the padded head dims of the SD-1.5 UNet (40, 80, 160); another
// model's head dim gets its own instantiation when a path brings it.
#define RTT_DISPATCH(FN, ...)                                        \
  if (d <= 48) return (int)FN<48>(__VA_ARGS__);                      \
  if (d <= 80) return (int)FN<80>(__VA_ARGS__);                      \
  if (d <= 160) return (int)FN<160>(__VA_ARGS__);                    \
  return (int)cudaErrorInvalidValue;

}  // namespace rtt
