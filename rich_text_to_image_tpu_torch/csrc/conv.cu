// 3x3, stride-1, pad-1 convolution plus bias on Hopper (sm_90a), channels
// last, bf16 in and out, fp32 accumulation.
//
// Replaces the flat-offset Pallas kernel of the JAX package
// (rich_text_to_image_tpu/ops/conv.py, _kernel): x [B,H,W,C], w [3,3,C,O],
// b [O] -> [B,H,W,O]. The TPU kernel zero-pads and flattens the input in
// device memory so that each of the 9 taps is a contiguous slice, and
// throws two garbage columns per row away afterwards.
//
// What bounds it on an H100. 2*9*C*O FLOPs per output pixel against
// 2*(C + O) bytes of activation: at C = O = 320 that is ~2,900 FLOPs per
// byte, and more for the wider levels, so the tensor cores bound it; the
// weights (9*C*O bf16, 1.8-59 MB) are read once per 128-pixel tile from L2.
//
// What the design does about it. An implicit GEMM, M = B*H*W output pixels,
// N = O, K = 9*C, with no padded copy of the input, on Hopper's warpgroup
// product (wgmma.cuh):
//   * a CTA of two warpgroups owns TM = 128 or 256 pixels (64 or 128 rows a
//     warpgroup) x TN output channels and loops over the 9 taps and over
//     64-channel slices of C. TN = 160 divides every width of the SD-1.5
//     UNet (320, 640, 1280): no ragged N tile, and a step moves 14 KB out
//     of L2 per MFLOP at 128 x 160 (10 at 256 x 160) where a 128 x 64 tile
//     moved 24; 128 and 64 serve the other multiples of 64;
//   * both operands are read by wgmma from shared memory in the 128-byte
//     swizzled layout: the activations [pixel][64 channels] K-major, the
//     weight block [64 channels][TN] as it lies in device memory, MN-major,
//     in chunks of 64 outputs;
//   * a ring of four stages filled by cp.async (it zero-fills a pixel
//     outside the image, which is where the padding lives; each thread's
//     pixels are fixed, so their (h, w) are decoded once): the copy of step
//     i+2 is in flight while step i is multiplied, and the products of step
//     i run while the threads start those copies. cp.async rather than TMA:
//     the activation tile is a gather by pixel, which a tiled tensor map
//     does not describe, and the kernel then needs no tensor map on the
//     host at all, whose launches are what the UNet forward waits for;
//   * the bias is added to the fp32 sums, which are rounded to bf16 once;
//   * small images give few tiles with a long K (9*C up to 23,040). There
//     the steps are split over blockIdx.z: each CTA writes its fp32 partial
//     sums to a workspace [splits][M][O], and a second kernel adds the
//     partials in a fixed order (no atomics, so the result is the same
//     from run to run), then the bias, and rounds.
// A tile of 128 or 256 pixels may span image rows and batch rows (W = 8
// puts 16 rows in one tile): every pixel carries its own coordinates, so
// nothing wraps. Its times are in PERF.md.

#include "wgmma.cuh"

namespace {

using namespace rtt;

constexpr int CBK = 64;        // input channels per step: one swizzled row
constexpr int CTHREADS = 256;  // two warpgroups
constexpr int NSTAGE = 4;      // stages of the ring
constexpr int PD = NSTAGE - 2; // step i + PD is requested at step i

template <int TM, int TN>
struct ConvCfg {
  static constexpr int MI = TM / 128;            // 64-row blocks a warpgroup
  static constexpr int A_BYTES = TM * SWZ_ROW;
  static constexpr int NCH = (TN + 63) / 64;     // 64-output chunks
  static constexpr int B_BYTES = NCH * CBK * SWZ_ROW;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = 1024 + NSTAGE * STAGE;
  static constexpr int A_ROWS = TM * 8 / CTHREADS;  // pixels a thread copies
};

template <int TN>
__device__ __forceinline__ void conv_mma(float* acc, uint64_t da, uint64_t db) {
  if constexpr (TN == 160) wgmma_ss_n160<1>(acc, da, db, 1);
  else if constexpr (TN == 128) wgmma_ss_n128<1>(acc, da, db, 1);
  else wgmma_ss_n64<1>(acc, da, db, 1);
}

// SPLIT = false: all steps, bias added, bf16 out. SPLIT = true: the steps
// of split blockIdx.z, fp32 partial sums into ws[blockIdx.z][M][O].
template <int TM, int TN, bool SPLIT>
__global__ void __launch_bounds__(CTHREADS, 1)
    conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias, bf16* __restrict__ out,
                   float* __restrict__ ws, int B, int H, int W, int C, int O,
                   int steps_per_split) {
  using Cfg = ConvCfg<TM, TN>;
  constexpr int MI = Cfg::MI;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles start at 1024 bytes
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int M = B * H * W;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int t = threadIdx.x;
  const int wg = t / 128, warp = (t / 32) % 4, lane = t % 32;
  const int g = lane >> 2, tig = lane & 3;

  // this thread's share of the A tile: rows t/8 + 32*i, 16-byte chunk t%8
  const int a_chunk = t & 7;
  int a_hw[Cfg::A_ROWS];   // (h << 16) | w of the pixel
  int a_off[Cfg::A_ROWS];  // element offset of the pixel's channel 0
#pragma unroll
  for (int i = 0; i < Cfg::A_ROWS; ++i) {
    const int m = m0 + (t >> 3) + 32 * i;
    if (m < M) {
      const int hw = m % (H * W);
      a_hw[i] = ((hw / W) << 16) | (hw % W);
      a_off[i] = m * C;
    } else {
      a_hw[i] = (0x4000 << 16) | 0x4000;  // no tap brings it inside the image
      a_off[i] = 0;
    }
  }
  // its share of the weight block: rows of 64 channels x TN outputs
  const TileCopier<TN, CBK, CTHREADS> b_copy(TN, t);

  const int k_slices = C / CBK;
  const int step0 = SPLIT ? blockIdx.z * steps_per_split : 0;
  const int step1 = SPLIT ? min(9 * k_slices, step0 + steps_per_split)
                          : 9 * k_slices;

  auto load_step = [&](int step) {
    const int tap = step / k_slices, c0 = (step % k_slices) * CBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const uint32_t a_s = ring + ((step - step0) % NSTAGE) * Cfg::STAGE;
    const int shift = (dy * W + dx) * C + c0 + a_chunk * 8;
#pragma unroll
    for (int i = 0; i < Cfg::A_ROWS; ++i) {
      const int hh = (a_hw[i] >> 16) + dy, ww = (a_hw[i] & 0xFFFF) + dx;
      const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W;
      cp_async16_to(a_s + swz_offset((t >> 3) + 32 * i, a_chunk),
                    ok ? x + a_off[i] + shift : x, ok);
    }
    b_copy.copy(a_s + Cfg::A_BYTES, w + n0, O, tap * C + c0, 1 << 30);
  };

  float acc[MI][TN / 2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[mi][i] = 0.f;

  // One copy group is committed for every step index, empty past the last,
  // so that "all but the newest PD - 1 groups" always names this step.
#pragma unroll
  for (int s = 0; s < PD; ++s) {
    if (step0 + s < step1) load_step(step0 + s);
    cp_async_commit();
  }
  for (int step = step0; step < step1; ++step) {
    cp_async_wait<PD - 1>();
    fence_async_smem();
    // every thread's copies of this step are visible, and every warpgroup
    // has waited for its products of step - 2, whose stage the next copy
    // overwrites
    __syncthreads();
    if (step + PD < step1) load_step(step + PD);
    cp_async_commit();

    const uint32_t a_s = ring + ((step - step0) % NSTAGE) * Cfg::STAGE;
    // this warpgroup's rows: MI blocks of 64, one after the other
    const uint64_t da = desc_kmajor(a_s + wg * MI * 64 * SWZ_ROW);
    // the weight block: 16 channels (2048 bytes) a product, outputs 64..
    // in the next chunk
    const uint64_t db = desc_mnmajor(a_s + Cfg::A_BYTES, CBK * SWZ_ROW);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CBK / 16; ++kk)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        conv_mma<TN>(acc[mi], da + mi * (64 * SWZ_ROW >> 4) + kk * 2,
                     db + kk * (16 * SWZ_ROW >> 4));
    wgmma_commit();
    wgmma_wait<1>();  // the products of step - 1
  }
  wgmma_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    fence_regs<TN / 2>(acc[mi]);
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = n0 + j * 8 + tig * 2;
      const float b0 = SPLIT ? 0.f : __bfloat162float(bias[col]);
      const float b1 = SPLIT ? 0.f : __bfloat162float(bias[col + 1]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows g and g + 8
        const long long r =
            m0 + (wg * MI + mi) * 64 + warp * 16 + g + 8 * half;
        if (r >= M) continue;
        const float v0 = acc[mi][4 * j + 2 * half] + b0;
        const float v1 = acc[mi][4 * j + 2 * half + 1] + b1;
        if (SPLIT)
          *reinterpret_cast<float2*>(ws + ((long long)blockIdx.z * M + r) * O +
                                     col) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(out + r * O + col) = pack_bf16(v0, v1);
      }
    }
  }
}

// out = bf16(sum over splits of ws, in order, + bias); two channels a thread.
__global__ void conv3x3_reduce_kernel(const float* __restrict__ ws,
                                      const bf16* __restrict__ bias,
                                      bf16* __restrict__ out, long long MO,
                                      int O, int splits) {
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 2;
  if (e >= MO) return;
  float2 sum = *reinterpret_cast<const float2*>(ws + e);
  for (int z = 1; z < splits; ++z) {
    const float2 p = *reinterpret_cast<const float2*>(ws + z * MO + e);
    sum.x += p.x;
    sum.y += p.y;
  }
  const int col = (int)(e % O);
  *reinterpret_cast<uint32_t*>(out + e) =
      pack_bf16(sum.x + __bfloat162float(bias[col]),
                sum.y + __bfloat162float(bias[col + 1]));
}

template <int TM, int TN, bool SPLIT>
cudaError_t launch_conv(const bf16* x, const bf16* w, const bf16* bias,
                        bf16* out, float* ws, int splits, int per, int B,
                        int H, int W, int C, int O, cudaStream_t stream) {
  using Cfg = ConvCfg<TM, TN>;
  static bool configured = false;  // once a process: the port drives one card
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_kernel<TM, TN, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + TM - 1) / TM), O / TN, splits);
  conv3x3_kernel<TM, TN, SPLIT><<<grid, CTHREADS, Cfg::SMEM, stream>>>(
      x, w, bias, out, ws, B, H, W, C, O, per);
  return cudaGetLastError();
}

template <int TM, int TN>
cudaError_t launch_conv_tile(const bf16* x, const bf16* w, const bf16* bias,
                             bf16* out, float* ws, int splits, int per, int B,
                             int H, int W, int C, int O, cudaStream_t stream) {
  if (splits == 1)
    return launch_conv<TM, TN, false>(x, w, bias, out, nullptr, 1, per, B, H,
                                      W, C, O, stream);
  return launch_conv<TM, TN, true>(x, w, bias, nullptr, ws, splits, per, B, H,
                                   W, C, O, stream);
}

}  // namespace

// C interface (loaded with ctypes). x [B,H,W,C], w [9,C,O], bias [O] and
// out [B,H,W,O] are contiguous bf16; C is a multiple of 64. tile_m is 128 or
// 256 pixels a CTA, tile_n 160, 128 or 64 output channels, a divisor of O
// (conv_tile in ops/conv.py picks them). With splits > 1, ws is an fp32
// workspace of splits*B*H*W*O elements and the 9*C/64 steps are cut into
// that many ranges. The wrapper checks. Returns the first error of the
// launches (0 = success).
extern "C" int rtt_conv3x3_fwd(const void* x_, const void* w_,
                               const void* bias_, void* out_, void* ws_,
                               int splits, int tile_m, int tile_n, int B,
                               int H, int W, int C, int O, void* stream_) {
  const int n_steps = 9 * (C / CBK);
  if (C % CBK || tile_n <= 0 || O % tile_n || B <= 0 || H <= 0 || W <= 0 ||
      splits < 1 || splits > n_steps || (splits > 1 && ws_ == nullptr))
    return (int)cudaErrorInvalidValue;
  const int per = (n_steps + splits - 1) / splits;
  if ((long long)per * (splits - 1) >= n_steps)  // a split would be empty
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const bf16 *x = (const bf16*)x_, *w = (const bf16*)w_,
             *bias = (const bf16*)bias_;
  bf16* out = (bf16*)out_;
  float* ws = (float*)ws_;
  cudaError_t err = cudaErrorInvalidValue;
#define RTT_CONV_TILE(TM, TN)                                             \
  if (tile_m == TM && tile_n == TN)                                       \
    err = launch_conv_tile<TM, TN>(x, w, bias, out, ws, splits, per, B, H, \
                                   W, C, O, stream);
  RTT_CONV_TILE(128, 160)
  RTT_CONV_TILE(256, 160)
  RTT_CONV_TILE(128, 128)
  RTT_CONV_TILE(256, 128)
  RTT_CONV_TILE(128, 64)
#undef RTT_CONV_TILE
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long MO = (long long)B * H * W * O;
  conv3x3_reduce_kernel<<<(unsigned)((MO / 2 + 255) / 256), 256, 0, stream>>>(
      ws, bias, out, MO, O, splits);
  return (int)cudaGetLastError();
}
