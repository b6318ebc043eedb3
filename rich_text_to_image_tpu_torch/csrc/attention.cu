// Self-attention kernels for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the three full-row Pallas kernels of the JAX package
// (rich_text_to_image_tpu/ops/attention.py):
//   * attn_fwd_kernel  <- _full_kernel   (SD 64^2 self-attention, d=40)
//                      <- _full_kernel_t (SD 32^2 self-attention, d=80)
//   * attn_avgp_kernel <- _full_kernel_avgp (the 32^2 capture layers: the
//                         output plus the head-averaged probabilities)
//
// What bounds them on an H100. At the main path's shapes attention does
// 4*S*S*d FLOPs for 2*(3*S*d) bf16 bytes per (batch, head): S=4096, d=40 is
// ~1,000 FLOPs per byte, far above the card's ~295 FLOP/B ridge, so the
// tensor cores (989 TFLOP/s bf16) and the exponentials (one exp2 per score on
// the 16-wide-per-SM special-function unit) bound it, not device memory.
// The capture kernel adds a [B, Sq, Skv] fp32 write, which is bytes.
//
// What the design does about it. The TPU kernels keep the whole K/V row of
// one (batch, head) in VMEM (~16 MB). A Hopper block has at most 227 KB of
// shared memory and K+V of one (batch, head) at S=4096 is ~786 KB, so the
// full-row layout does not carry over. Instead:
//   * each warp owns 16 query rows and keeps their Q fragments in registers
//     for the whole KV loop;
//   * K/V stream through shared memory in 64-row tiles; the PV product reads
//     V with ldmatrix.trans, so V is stored as it lies in device memory;
//   * scores come from mma.sync m16n8k16 (bf16 in, fp32 accumulate); the
//     softmax is online in fp32 with exp2 and log2(e) folded into the scale;
//     the score fragments are re-packed in registers as the A operand of
//     the PV product, so probabilities never touch device memory;
//   * K1 and K2 compute the same function: the TPU's transposed layout
//     answered a 128-lane padding cost that Hopper does not have, so one
//     kernel (one CTA of 4 warps per 64-row Q tile of one (batch, head)),
//     templated on the padded head dim (40 -> 48, 80 -> 80; 160 for the
//     1280-channel level at sizes above 512^2), serves both;
//   * the capture kernel is deterministic, with no atomics: one CTA owns
//     (batch, 16-row Q tile), and its 4 warps take 4 heads at a time, each
//     with its own K/V tiles. Per head a first KV pass finds each row's max
//     and sum; a second recomputes the scores, writes O, and puts p/(l*H)
//     into the warp's slot in shared memory, whose 4 slots are summed in a
//     fixed order and added to the pavg rows the CTA alone owns. Owning 16
//     rows (not 64) gives 128 CTAs at B=2, S=1024, enough for the card.
// This is a simple version: no TMA, no wgmma, no pipelining of the tile
// loads. Its times are in PERF.md.

#include "common.cuh"

namespace {

using namespace rtt;

constexpr int NWARPS = 4;     // warps per CTA, each owning 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int BM = 16 * NWARPS;  // query rows per attn_fwd CTA

// Scores of this warp's 16 rows against the 64 keys in Ks, scaled to log2
// units, with keys >= kv_len masked to -inf.
template <int DP>
__device__ __forceinline__ void tile_scores(float s[BN / 8][4],
                                            const uint32_t qf[DP / 16][4],
                                            const bf16 (*Ks)[DP + PAD],
                                            int g, int tig, int n0, int kv_len,
                                            float scale_log2) {
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
    s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const bf16* kr = &Ks[nb * 8 + g][kk * 16 + tig * 2];
      mma16816(s[nb], qf[kk], ld32(kr), ld32(kr + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n0 + nb * 8 + tig * 2 + (e & 1);
      s[nb][e] = col < kv_len ? s[nb][e] * scale_log2 : -INFINITY;
    }
  }
}

// o += p . V for this warp's rows; p given as score-layout fragments, V as
// a [64][DP + PAD] row-major tile.
template <int DP>
__device__ __forceinline__ void tile_pv(float o[DP / 8][4],
                                        const float p[BN / 8][4],
                                        const bf16 (*Vs)[DP + PAD], int lane) {
#pragma unroll
  for (int kt = 0; kt < BN / 16; ++kt) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kt][0], p[2 * kt][1]);
    a[1] = pack_bf16(p[2 * kt][2], p[2 * kt][3]);
    a[2] = pack_bf16(p[2 * kt + 1][0], p[2 * kt + 1][1]);
    a[3] = pack_bf16(p[2 * kt + 1][2], p[2 * kt + 1][3]);
#pragma unroll
    for (int db = 0; db < DP / 8; ++db) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, &Vs[kt * 16 + (lane & 15)][db * 8]);
      mma16816(o[db], a, b0, b1);
    }
  }
}

// softmax(Q K^T * scale) V for one 64-row Q tile of one (batch, head).
template <int DP>
__global__ void __launch_bounds__(NTHREADS)
    attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                    int sq, int skv, int d, Strides qs, Strides ks, Strides vs,
                    Strides os, float scale_log2) {
  // Q lives in shared memory only until its fragments are in registers, so
  // it shares the K tile's room: at DP = 160 three tiles would pass the 48 KB
  // a block may declare statically
  static_assert(BM == BN, "the Q tile borrows the K tile");
  __shared__ __align__(16) bf16 Ks[BN][DP + PAD];
  __shared__ __align__(16) bf16 Vs[BN][DP + PAD];
  bf16 (*Qs)[DP + PAD] = Ks;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  bf16* ob = o + b * os.b + h * os.h;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;

  load_tile<DP, BM, NTHREADS>(Qs, qb, qs.s, q0, sq, d, threadIdx.x);
  __syncthreads();
  uint32_t qf[DP / 16][4];
  load_q_frags<DP>(qf, Qs, wr + g, tig);

  float acc[DP / 8][4];
#pragma unroll
  for (int db = 0; db < DP / 8; ++db)
    acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int n0 = 0; n0 < skv; n0 += BN) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<DP, BN, NTHREADS>(Ks, kb, ks.s, n0, skv, d, threadIdx.x);
    load_tile<DP, BN, NTHREADS>(Vs, vb, vs.s, n0, skv, d, threadIdx.x);
    __syncthreads();

    float s[BN / 8][4];
    tile_scores<DP>(s, qf, Ks, g, tig, n0, skv, scale_log2);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
    // every tile holds at least one unmasked key, so the new max is finite
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      s[nb][0] = exp2f(s[nb][0] - mn0);
      s[nb][1] = exp2f(s[nb][1] - mn0);
      s[nb][2] = exp2f(s[nb][2] - mn1);
      s[nb][3] = exp2f(s[nb][3] - mn1);
      ls0 += s[nb][0] + s[nb][1];
      ls1 += s[nb][2] + s[nb][3];
    }
    l0 = l0 * al0 + ls0;  // per-thread partial sums; the quad is summed last
    l1 = l1 * al1 + ls1;
#pragma unroll
    for (int db = 0; db < DP / 8; ++db) {
      acc[db][0] *= al0; acc[db][1] *= al0;
      acc[db][2] *= al1; acc[db][3] *= al1;
    }
    tile_pv<DP>(acc, s, Vs, lane);
    m0 = mn0;
    m1 = mn1;
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_out<DP>(ob, os.s, acc, q0 + wr + g, sq, d, tig, 1.f / l0, 1.f / l1);
}

// Shared memory of attn_avgp_kernel: each warp's Q/K/V tiles and its slot
// of head-scaled probabilities for the current KV tile.
template <int DP>
struct AvgpSmem {
  bf16 q[NWARPS][16][DP + PAD];
  bf16 k[NWARPS][BN][DP + PAD];
  bf16 v[NWARPS][BN][DP + PAD];
  float p[NWARPS][16][BN + 8];
};

// attn_fwd_kernel's output plus pavg[b, i, j] = sum_h p_h[i, j] / H, for
// one 16-row Q tile of one batch row; warp w takes heads w, w + 4, ...
template <int DP>
__global__ void __launch_bounds__(NTHREADS)
    attn_avgp_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ pavg, int H, int sq, int skv, int d,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AvgpSmem<DP>& sm = *reinterpret_cast<AvgpSmem<DP>*>(smem_raw);

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  float* pb = pavg + (long long)b * sq * skv;
  const float inv_h = 1.f / H;
  bf16 (*Qs)[DP + PAD] = sm.q[warp];
  bf16 (*Ks)[DP + PAD] = sm.k[warp];
  bf16 (*Vs)[DP + PAD] = sm.v[warp];
  float (*Ps)[BN + 8] = sm.p[warp];

  for (int h0 = 0; h0 < H; h0 += NWARPS) {
    const int h = h0 + warp;
    const bool active = h < H;  // uniform within the warp
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* kb = k + b * ks.b + h * ks.h;
    const bf16* vb = v + b * vs.b + h * vs.h;

    // pass 1: each row's max and sum (this warp alone)
    uint32_t qf[DP / 16][4];
    float m0 = -INFINITY, m1 = -INFINITY, il0 = 0.f, il1 = 0.f;
    if (active) {
      __syncwarp();  // the warp's previous head is done with Qs
      load_tile<DP, 16, 32>(Qs, qb, qs.s, q0, sq, d, lane);
      __syncwarp();
      load_q_frags<DP>(qf, Qs, g, tig);
      float l0 = 0.f, l1 = 0.f;
      for (int n0 = 0; n0 < skv; n0 += BN) {
        __syncwarp();
        load_tile<DP, BN, 32>(Ks, kb, ks.s, n0, skv, d, lane);
        __syncwarp();
        float s[BN / 8][4];
        tile_scores<DP>(s, qf, Ks, g, tig, n0, skv, scale_log2);
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb) {
          mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
          mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
        }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb) {
          ls0 += exp2f(s[nb][0] - mn0) + exp2f(s[nb][1] - mn0);
          ls1 += exp2f(s[nb][2] - mn1) + exp2f(s[nb][3] - mn1);
        }
        l0 = l0 * exp2f(m0 - mn0) + ls0;
        l1 = l1 * exp2f(m1 - mn1) + ls1;
        m0 = mn0;
        m1 = mn1;
      }
      il0 = 1.f / quad_sum(l0);
      il1 = 1.f / quad_sum(l1);
    }

    // pass 2: normalized probabilities -> O, and the head sum into pavg
    float acc[DP / 8][4];
#pragma unroll
    for (int db = 0; db < DP / 8; ++db)
      acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;
    for (int n0 = 0; n0 < skv; n0 += BN) {  // the same trip count in every warp
      float s[BN / 8][4];
      if (active) {
        __syncwarp();
        load_tile<DP, BN, 32>(Ks, kb, ks.s, n0, skv, d, lane);
        load_tile<DP, BN, 32>(Vs, vb, vs.s, n0, skv, d, lane);
        __syncwarp();
        tile_scores<DP>(s, qf, Ks, g, tig, n0, skv, scale_log2);
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb) {
          s[nb][0] = exp2f(s[nb][0] - m0) * il0;
          s[nb][1] = exp2f(s[nb][1] - m0) * il0;
          s[nb][2] = exp2f(s[nb][2] - m1) * il1;
          s[nb][3] = exp2f(s[nb][3] - m1) * il1;
        }
        tile_pv<DP>(acc, s, Vs, lane);
      } else {
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb)
          s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      }
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) {
        const int c = nb * 8 + tig * 2;
        *reinterpret_cast<float2*>(&Ps[g][c]) =
            make_float2(s[nb][0] * inv_h, s[nb][1] * inv_h);
        *reinterpret_cast<float2*>(&Ps[g + 8][c]) =
            make_float2(s[nb][2] * inv_h, s[nb][3] * inv_h);
      }
      __syncthreads();  // every warp's slot is written
      for (int e = threadIdx.x; e < 16 * BN; e += NTHREADS) {
        const int r = e / BN, c = e % BN;
        const int row = q0 + r, col = n0 + c;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) sum += sm.p[w][r][c];
        if (row < sq && col < skv) {
          float* dst = pb + (long long)row * skv + col;
          *dst = h0 == 0 ? sum : *dst + sum;
        }
      }
      __syncthreads();  // the slots are free for the next tile
    }
    if (active)
      store_out<DP>(o + b * os.b + h * os.h, os.s, acc, q0 + g, sq, d, tig,
                    1.f, 1.f);
  }
}

template <int DP>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                       int B, int H, int sq, int skv, int d, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale_log2,
                       cudaStream_t stream) {
  dim3 grid((sq + BM - 1) / BM, B * H);
  attn_fwd_kernel<DP><<<grid, NTHREADS, 0, stream>>>(
      q, k, v, o, H, sq, skv, d, qs, ks, vs, os, scale_log2);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_avgp(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                        float* pavg, int B, int H, int sq, int skv, int d,
                        Strides qs, Strides ks, Strides vs, Strides os,
                        float scale_log2, cudaStream_t stream) {
  const int smem = (int)sizeof(AvgpSmem<DP>);  // above the 48 KB static limit
  cudaError_t err = cudaFuncSetAttribute(
      attn_avgp_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + 15) / 16, B);
  attn_avgp_kernel<DP><<<grid, NTHREADS, smem, stream>>>(
      q, k, v, o, pavg, H, sq, skv, d, qs, ks, vs, os, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes). Tensors are bf16 with a contiguous last
// dim; strides are in elements for the batch, head and sequence dims. The
// head dim d must be a multiple of 8 and at most 160 (RTT_DISPATCH in
// common.cuh); the wrapper checks.
// Each entry returns cudaGetLastError() after the launch (0 = success).
extern "C" int rtt_attn_fwd(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int sq, int skv, int d,
                            long long qsb, long long qsh, long long qss,
                            long long ksb, long long ksh, long long kss,
                            long long vsb, long long vsh, long long vss,
                            long long osb, long long osh, long long oss,
                            float scale_log2, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  RTT_DISPATCH(launch_fwd, (const bf16*)q, (const bf16*)k, (const bf16*)v,
               (bf16*)o, B, H, sq, skv, d, qs, ks, vs, os, scale_log2,
               (cudaStream_t)stream)
}

extern "C" int rtt_attn_avgp_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* pavg, int B, int H, int sq,
                                 int skv, int d, long long qsb, long long qsh,
                                 long long qss, long long ksb, long long ksh,
                                 long long kss, long long vsb, long long vsh,
                                 long long vss, long long osb, long long osh,
                                 long long oss, float scale_log2,
                                 void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  RTT_DISPATCH(launch_avgp, (const bf16*)q, (const bf16*)k, (const bf16*)v,
               (bf16*)o, (float*)pavg, B, H, sq, skv, d, qs, ks, vs, os,
               scale_log2, (cudaStream_t)stream)
}
