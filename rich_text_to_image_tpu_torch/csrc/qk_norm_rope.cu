// FLUX.1's q/k prologue of a joint attention on Hopper (sm_90a): the RMS
// norm of every head row of q and k with its weight, then RoPE on
// interleaved pairs, bf16 in and out, written straight into the
// [B, S, H, D] rows the attention kernel reads, each source's rows at its
// own token offset.
//
// Replaces no Pallas kernel: the JAX package has no FLUX.1. It replaces the
// eager chain of models/flux.py (RMSNorm, apply_rope, a torch.cat of the
// text and image rows): 16 device kernels a tensor, each float32
// intermediate through device memory, about 47 bytes moved for each bf16
// byte of q or k, which took about 9 s of a 34 s FLUX.1-dev sample at 1024²
// on an H100 (80 GB HBM3, 700 W).
//
// What bounds it on an H100. A few operations a byte: the bytes. q and k are
// read once and written once, 4 * B * S * H * D * 2 bytes, plus this
// launch's float32 cos and sin rows, 2 * S * D * 4: at B = 1, S = 4,608,
// H * D = 3,072 that is 118 MB, 35 us at 3.35 TB/s (69 us at B = 2).
//
// What the design does about it. One CTA a (token, batch row) of the joint
// sequence; 16 threads a head row of D = 128, each 8 consecutive elements
// (one 16-byte load and store), so a RoPE pair (2i, 2i+1) never straddles
// two threads; eight head rows a CTA at once, q and k of a head together, so
// that each thread has two loads in flight. The sum of squares is a shuffle
// reduction inside the 16 threads. The token's cos and sin (the same for
// every head, q and k) and the two weights stay in registers across the
// heads; the tables, 2.4 MB each at 1024², stay in L2 across the batch rows.
//
// Every rounding of the eager chain is repeated, so that the result is the
// eager one to the bit but for the order of the sum of squares: float32
// squares summed, times 1/D, plus eps, rsqrtf (PyTorch's rsqrt); x * r
// rounded to bf16; times the bf16 weight in float32, rounded to bf16 (bf16 x
// bf16 in PyTorch); RoPE in float32 as y * cos + rot * sin with rot =
// (-y[2i+1], y[2i]), each product and the sum rounded on their own
// (__fmul_rn, __fadd_rn: no contraction into an FMA, which the eager
// chain's separate kernels cannot do); rounded to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 128;                 // the head dim FLUX.1 runs at
constexpr int VEC = 8;                 // elements a thread: 16 bytes of bf16
constexpr int LANES = D / VEC;         // threads a head row
constexpr int THREADS = 128;
constexpr int ROWS = THREADS / LANES;  // head rows a CTA at once

// The tokens of one projection: q, k [B, n, H, D] contiguous, and the bf16
// weights [D] of their two norms.
struct Source {
  const bf16* q;
  const bf16* k;
  const bf16* wq;
  const bf16* wk;
};

__device__ __forceinline__ void unpack(uint4 raw, float f[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One thread's 8 elements of a head row; every thread of the warp calls it
// (the shuffles), those past the last head with zeros.
__device__ __forceinline__ uint4 norm_rope(uint4 raw, const float w[VEC],
                                           const float c[VEC],
                                           const float s[VEC], float eps) {
  float x[VEC];
  unpack(raw, x);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) ss = __fadd_rn(ss, __fmul_rn(x[i], x[i]));
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)  // inside the 16 threads
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / D), eps));
  float y[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    y[i] = round_bf16(__fmul_rn(round_bf16(__fmul_rn(x[i], r)), w[i]));
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float a = y[2 * i], b = y[2 * i + 1];
    const float lo =
        __fadd_rn(__fmul_rn(a, c[2 * i]), __fmul_rn(-b, s[2 * i]));
    const float hi =
        __fadd_rn(__fmul_rn(b, c[2 * i + 1]), __fmul_rn(a, s[2 * i + 1]));
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    o[i] = *reinterpret_cast<uint32_t*>(&v);
  }
  return out;
}

// Token t of the joint sequence [S] comes from `first` (row t) below
// `split`, from `second` (row t - split) above it; q_out, k_out [B, S, H, D].
__global__ void __launch_bounds__(THREADS)
    qk_norm_rope_kernel(Source first, Source second, int split, int S, int H,
                        const float* __restrict__ cos_tab,
                        const float* __restrict__ sin_tab, float eps,
                        bf16* __restrict__ q_out, bf16* __restrict__ k_out) {
  const int t = blockIdx.x, b = blockIdx.y;
  const bool lead = t < split;
  const Source src = lead ? first : second;
  const int n = lead ? split : S - split;  // the source's tokens
  const int row = lead ? t : t - split;
  const int col = (threadIdx.x % LANES) * VEC;

  float c[VEC], s[VEC], wq[VEC], wk[VEC];
  const long long tab = (long long)t * D + col;
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const float4 cv = *reinterpret_cast<const float4*>(cos_tab + tab + i);
    const float4 sv = *reinterpret_cast<const float4*>(sin_tab + tab + i);
    c[i] = cv.x, c[i + 1] = cv.y, c[i + 2] = cv.z, c[i + 3] = cv.w;
    s[i] = sv.x, s[i + 1] = sv.y, s[i + 2] = sv.z, s[i + 3] = sv.w;
  }
  unpack(*reinterpret_cast<const uint4*>(src.wq + col), wq);
  unpack(*reinterpret_cast<const uint4*>(src.wk + col), wk);

  const long long in = ((long long)b * n + row) * H * D + col;
  const long long out = ((long long)b * S + t) * H * D + col;
  for (int h0 = 0; h0 < H; h0 += ROWS) {  // the same trips for every thread
    const int h = h0 + threadIdx.x / LANES;
    const bool on = h < H;
    uint4 rq = make_uint4(0u, 0u, 0u, 0u), rk = rq;
    if (on) {
      rq = *reinterpret_cast<const uint4*>(src.q + in + (long long)h * D);
      rk = *reinterpret_cast<const uint4*>(src.k + in + (long long)h * D);
    }
    const uint4 oq = norm_rope(rq, wq, c, s, eps);
    const uint4 ok = norm_rope(rk, wk, c, s, eps);
    if (on) {
      *reinterpret_cast<uint4*>(q_out + out + (long long)h * D) = oq;
      *reinterpret_cast<uint4*>(k_out + out + (long long)h * D) = ok;
    }
  }
}

}  // namespace

// q_out, k_out [B, S, H, D] from the sources' q, k: tokens [0, split) from
// the first (q0, k0 [B, split, H, D], weights wq0, wk0), [split, S) from the
// second; split 0 for one source. cos_tab, sin_tab: float32 [S, D]. The head
// dim is D = 128, every pointer 16-byte aligned, every tensor contiguous
// (the wrapper checks). Returns the launch's CUDA error.
extern "C" int rtt_qk_norm_rope(const void* q0, const void* k0,
                                const void* wq0, const void* wk0,
                                const void* q1, const void* k1,
                                const void* wq1, const void* wk1, int split,
                                int B, int S, int H,
                                const void* cos_tab, const void* sin_tab,
                                float eps, void* q_out, void* k_out,
                                void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || split < 0 || split >= S)
    return (int)cudaErrorInvalidValue;
  const Source first{(const bf16*)q0, (const bf16*)k0, (const bf16*)wq0,
                     (const bf16*)wk0};
  const Source second{(const bf16*)q1, (const bf16*)k1, (const bf16*)wq1,
                      (const bf16*)wk1};
  qk_norm_rope_kernel<<<dim3((unsigned)S, (unsigned)B), THREADS, 0,
                        (cudaStream_t)stream>>>(
      first, second, split, S, H, (const float*)cos_tab,
      (const float*)sin_tab, eps, (bf16*)q_out, (bf16*)k_out);
  return (int)cudaGetLastError();
}
