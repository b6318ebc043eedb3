// Streaming self-attention for long rows on Hopper (sm_90a), bf16 in, fp32
// online softmax.
//
// Replaces the online-softmax Pallas kernel of the JAX package
// (rich_text_to_image_tpu/ops/attention.py, _flash_kernel): the kernel that
// flash_attention takes when the K/V row of one (batch, head) is too long for
// the TPU's full-row layout (SD-1.5 at 768^2 and above: S = 9216 or 16384,
// d = 40), or when the caller names block sizes.
//
// What bounds it on an H100. 4*S*S*d FLOPs for 8*S*d bytes per (batch,
// head): at S = 9216, d = 40 that is ~2,300 FLOPs per byte, so the tensor
// cores and the exponentials bound it, never device memory. What is scarce
// at these lengths is the traffic between L2, shared memory and registers:
// every CTA reads the whole K/V row of its head (2.6 MB at S = 16384), and a
// head has 72-128 Q tiles.
//
// What the design does about it, where it differs from attn_fwd_kernel:
//   * a CTA owns 128 query rows, so each K/V tile brought into shared
//     memory serves twice as many rows, and the head's row is read from L2
//     half as often;
//   * up to a padded head dim of 64 a warp owns 32 of those rows (4 warps a
//     CTA): every K and V fragment it loads from shared memory then feeds
//     two row blocks, 4 tensor-core products a 512-byte ldmatrix, where 2 a
//     load would leave shared memory, not the tensor cores, as the limit.
//     Wider heads keep 16 rows a warp (8 warps), for the registers;
//   * the grid runs the Q tiles of one (batch, head) next to each other
//     (blockIdx.x), so the CTAs in flight share one or two heads' K/V rows,
//     which stay in the 50 MB L2;
//   * K/V tiles of TK keys (the caller's block_k, up to 128) arrive through
//     cp.async into two buffers: the copy of tile t+1 is in flight while
//     tile t is multiplied, and ragged rows and the head-dim padding are
//     zero-filled by the copy itself;
//   * K fragments come from ldmatrix.x4 and V fragments from
//     ldmatrix.x4.trans, a quarter and a half of attn_fwd_kernel's
//     shared-memory load instructions per product;
//   * inside a tile the scores are taken 64 keys at a time, so the score
//     fragment stays at 32 registers whatever block_k is.
// The TPU kernel uses exp with the scale folded into Q; here the scale
// carries log2(e) and the exponential is exp2, the same function, because
// exp2 is the card's native instruction. No TMA and no wgmma yet; its times
// are in PERF.md.

#include "common.cuh"

namespace {

using namespace rtt;

constexpr int SBM = 128;     // query rows per CTA
constexpr int MAX_TK = 128;  // keys per shared-memory tile, at most

// Rows [row0, row0 + rows) of one (batch, head) into a [rows][DP + PAD]
// tile with asynchronous copies by NT threads; rows >= n_valid and head-dim
// columns >= d arrive as zeros.
template <int DP, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long stride_s, int row0,
                                                int rows, int n_valid, int d,
                                                int t) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  for (int idx = t; idx < rows * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = row0 + r < n_valid && c < d;
    const bf16* p = ok ? src + (long long)(row0 + r) * stride_s + c : src;
    cp_async16(dst + r * (DP + PAD) + c, p, ok);
  }
}

// Scores of this warp's MI blocks of 16 rows against the 64 keys starting
// at Ks, scaled to log2 units, with keys >= kv_len masked to -inf. Each K
// fragment is loaded once and used by all MI row blocks.
template <int DP, int MI>
__device__ __forceinline__ void block_scores(float s[MI][BN / 8][4],
                                             const uint32_t qf[MI][DP / 16][4],
                                             const bf16* Ks, int lane, int n0,
                                             int kv_len, float scale_log2) {
  constexpr int LD = DP + PAD;
  const int tig = lane & 3;
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      s[mi][nb][0] = s[mi][nb][1] = s[mi][nb][2] = s[mi][nb][3] = 0.f;
    const bf16* row = Ks + (nb * 8 + (lane & 7)) * LD;
#pragma unroll
    for (int kp = 0; kp < DP / 32; ++kp) {  // two 16-deep steps a load
      uint32_t b[4];
      ldsm_x4(b, row + kp * 32 + (lane >> 3) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma16816(s[mi][nb], qf[mi][2 * kp], b[0], b[1]);
        mma16816(s[mi][nb], qf[mi][2 * kp + 1], b[2], b[3]);
      }
    }
    if (DP % 32) {  // an odd number of steps: the last one alone
      uint32_t b0, b1;
      ldsm_x2(b0, b1, row + (DP - 16) + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        mma16816(s[mi][nb], qf[mi][DP / 16 - 1], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool live = n0 + nb * 8 + tig * 2 + (e & 1) < kv_len;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        s[mi][nb][e] = live ? s[mi][nb][e] * scale_log2 : -INFINITY;
    }
  }
}

// o += p . V for this warp's rows; p given as score-layout fragments, V as
// 64 rows of a [.][DP + PAD] row-major tile. Each V fragment is loaded once
// and used by all MI row blocks.
template <int DP, int MI>
__device__ __forceinline__ void block_pv(float o[MI][DP / 8][4],
                                         const float p[MI][BN / 8][4],
                                         const bf16* Vs, int lane) {
  constexpr int LD = DP + PAD;
#pragma unroll
  for (int kt = 0; kt < BN / 16; ++kt) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      a[mi][0] = pack_bf16(p[mi][2 * kt][0], p[mi][2 * kt][1]);
      a[mi][1] = pack_bf16(p[mi][2 * kt][2], p[mi][2 * kt][3]);
      a[mi][2] = pack_bf16(p[mi][2 * kt + 1][0], p[mi][2 * kt + 1][1]);
      a[mi][3] = pack_bf16(p[mi][2 * kt + 1][2], p[mi][2 * kt + 1][3]);
    }
    const bf16* row = Vs + (kt * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {  // two 8-wide column blocks a load
      uint32_t b[4];
      ldsm_x4_trans(b, row + dp * 16);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma16816(o[mi][2 * dp], a[mi], b[0], b[1]);
        mma16816(o[mi][2 * dp + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// softmax(Q K^T * scale) V for one 128-row Q tile of one (batch, head), by
// 8 / MI warps that own MI blocks of 16 rows each. Dynamic shared memory:
// Q [128][DP+PAD], then two buffers each of K [tk][DP+PAD] and
// V [tk][DP+PAD]; tk is 64 or 128.
template <int DP, int MI>
__global__ void __launch_bounds__(256 / MI)
    attn_stream_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                       int sq, int skv, int d, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale_log2, int tk) {
  constexpr int LD = DP + PAD;
  constexpr int NT = 256 / MI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + SBM * LD;  // buffer s: K at KV + s*2*tk*LD, V after it

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * SBM;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  bf16* ob = o + b * os.b + h * os.h;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16 * MI;
  const int n_tiles = (skv + tk - 1) / tk;

  // group 0: Q and the first K/V tile
  load_tile_async<DP, NT>(Qs, qb, qs.s, q0, SBM, sq, d, threadIdx.x);
  load_tile_async<DP, NT>(KV, kb, ks.s, 0, tk, skv, d, threadIdx.x);
  load_tile_async<DP, NT>(KV + tk * LD, vb, vs.s, 0, tk, skv, d, threadIdx.x);
  cp_async_commit();

  uint32_t qf[MI][DP / 16][4];
  float acc[MI][DP / 8][4];
  float mx[MI][2], l[MI][2];  // running max and sum of rows g and g + 8
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int db = 0; db < DP / 8; ++db)
      acc[mi][db][0] = acc[mi][db][1] = acc[mi][db][2] = acc[mi][db][3] = 0.f;
    mx[mi][0] = mx[mi][1] = -INFINITY;
    l[mi][0] = l[mi][1] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    // the buffer tile t+1 goes into was read last at tile t-1, and every
    // warp passed the barrier that ended that tile
    if (t + 1 < n_tiles) {
      bf16* nk = KV + ((t + 1) & 1) * 2 * tk * LD;
      load_tile_async<DP, NT>(nk, kb, ks.s, (t + 1) * tk, tk, skv, d,
                              threadIdx.x);
      load_tile_async<DP, NT>(nk + tk * LD, vb, vs.s, (t + 1) * tk, tk, skv, d,
                              threadIdx.x);
      cp_async_commit();
      cp_async_wait<1>();  // all but the newest group: tile t has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      const bf16 (*Q2)[LD] = reinterpret_cast<const bf16 (*)[LD]>(Qs);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        load_q_frags<DP>(qf[mi], Q2, wr + mi * 16 + g, tig);
    }
    const bf16* Ks = KV + (t & 1) * 2 * tk * LD;
    const bf16* Vs = Ks + tk * LD;
    for (int sub = 0; sub < tk; sub += BN) {
      const int n0 = t * tk + sub;
      if (n0 >= skv) break;  // the same for every thread of the CTA
      float s[MI][BN / 8][4];
      block_scores<DP, MI>(s, qf, Ks + sub * LD, lane, n0, skv, scale_log2);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb) {
          m0 = fmaxf(m0, fmaxf(s[mi][nb][0], s[mi][nb][1]));
          m1 = fmaxf(m1, fmaxf(s[mi][nb][2], s[mi][nb][3]));
        }
        // a block that is entered holds at least one unmasked key, so the
        // new max is finite
        const float mn0 = fmaxf(mx[mi][0], quad_max(m0));
        const float mn1 = fmaxf(mx[mi][1], quad_max(m1));
        const float al0 = exp2f(mx[mi][0] - mn0);
        const float al1 = exp2f(mx[mi][1] - mn1);
        float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb) {
          s[mi][nb][0] = exp2f(s[mi][nb][0] - mn0);
          s[mi][nb][1] = exp2f(s[mi][nb][1] - mn0);
          s[mi][nb][2] = exp2f(s[mi][nb][2] - mn1);
          s[mi][nb][3] = exp2f(s[mi][nb][3] - mn1);
          ls0 += s[mi][nb][0] + s[mi][nb][1];
          ls1 += s[mi][nb][2] + s[mi][nb][3];
        }
        // per-thread partial sums; the quad is summed last
        l[mi][0] = l[mi][0] * al0 + ls0;
        l[mi][1] = l[mi][1] * al1 + ls1;
#pragma unroll
        for (int db = 0; db < DP / 8; ++db) {
          acc[mi][db][0] *= al0; acc[mi][db][1] *= al0;
          acc[mi][db][2] *= al1; acc[mi][db][3] *= al1;
        }
        mx[mi][0] = mn0;
        mx[mi][1] = mn1;
      }
      block_pv<DP, MI>(acc, s, Vs + sub * LD, lane);
    }
    __syncthreads();  // every warp is done with tile t's buffer
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    store_out<DP>(ob, os.s, acc[mi], q0 + wr + mi * 16 + g, sq, d, tig,
                  1.f / quad_sum(l[mi][0]), 1.f / quad_sum(l[mi][1]));
}

template <int DP>
cudaError_t launch_stream(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                          int B, int H, int sq, int skv, int d, Strides qs,
                          Strides ks, Strides vs, Strides os, float scale_log2,
                          int tk, cudaStream_t stream) {
  // 32 rows a warp while the fragments fit the registers
  constexpr int MI = DP <= 64 ? 2 : 1;
  if (tk != 64 && tk != MAX_TK) return cudaErrorInvalidValue;
  const int smem = (SBM + 4 * tk) * (DP + PAD) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      attn_stream_kernel<DP, MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + SBM - 1) / SBM, B * H);
  attn_stream_kernel<DP, MI><<<grid, 256 / MI, smem, stream>>>(
      q, k, v, o, H, sq, skv, d, qs, ks, vs, os, scale_log2, tk);
  return cudaGetLastError();
}

}  // namespace

// C interface (loaded with ctypes), as rtt_attn_fwd in attention.cu, plus
// tk, the keys per shared-memory tile: 64 or 128. Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int rtt_attn_stream_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int sq, int skv,
                                   int d, long long qsb, long long qsh,
                                   long long qss, long long ksb, long long ksh,
                                   long long kss, long long vsb, long long vsh,
                                   long long vss, long long osb, long long osh,
                                   long long oss, float scale_log2, int tk,
                                   void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  RTT_DISPATCH(launch_stream, (const bf16*)q, (const bf16*)k, (const bf16*)v,
               (bf16*)o, B, H, sq, skv, d, qs, ks, vs, os, scale_log2, tk,
               (cudaStream_t)stream)
}
