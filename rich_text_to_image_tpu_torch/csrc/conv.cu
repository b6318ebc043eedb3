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
// N = O, K = 9*C, with no padded copy of the input:
//   * a CTA (8 warps, 4 along M by 2 along N, a 32x32 tile each) owns 128
//     pixels x 64 output channels, and loops over the 9 taps and over
//     64-channel slices of C;
//   * for each (tap, slice) its threads copy the 128 shifted input rows
//     [pixel (h+dy-1, w+dx-1)][64 channels] and the 64x64 weight block into
//     shared memory with cp.async; a pixel outside the image is zero-filled
//     by the copy itself, which is where the padding lives. Each thread's
//     pixels are fixed, so their (b, h, w) are decoded once;
//   * two buffers: the copy of step i+1 is in flight while step i is
//     multiplied with mma.sync m16n8k16; A fragments come from ldmatrix.x4,
//     B fragments from ldmatrix.x4.trans of the [k][n] weight block. Three
//     CTAs fit an SM (80 registers a thread, 54 KB of shared memory each).
//     A ring of three buffers with one barrier a step measured slower: each
//     step moves 24 KB per CTA out of L2 for 1 MFLOP, about 4 TB/s over the
//     card at the measured rate, so the tile, not the latency, is the limit;
//   * the bias is added to the fp32 sums, which are rounded to bf16 once;
//   * small images give few tiles (B*8*8/128 x O/64 = 20 at the 8^2 level
//     of SD-1.5, on 132 SMs) with a long K (9*C up to 23,040). There the
//     steps are split over blockIdx.z: each CTA writes its fp32 partial
//     sums to a workspace [splits][M][O], and a second kernel adds the
//     partials in a fixed order (no atomics, so the result is the same
//     from run to run), then the bias, and rounds.
// A tile of 128 pixels may span image rows and batch rows (W = 8 puts 16
// rows in one tile): every pixel carries its own coordinates, so nothing
// wraps. Its times are in PERF.md.

#include "common.cuh"

namespace {

using namespace rtt;

constexpr int CBM = 128;  // output pixels per CTA
constexpr int CBN = 64;   // output channels per CTA
constexpr int CBK = 64;   // input channels per step
constexpr int CTHREADS = 256;
constexpr int LDA = CBK + PAD;  // shared-memory row lengths, in elements
constexpr int LDB = CBN + PAD;
constexpr int A_ROWS_PER_THREAD = CBM * (CBK / 8) / CTHREADS;  // 4
constexpr int STAGE = CBM * LDA + CBK * LDB;  // elements per buffer
constexpr int NSTAGE = 2;                     // buffers in the ring

// SPLIT = false: all steps, bias added, bf16 out. SPLIT = true: the steps
// of split blockIdx.z, fp32 partial sums into ws[blockIdx.z][M][O].
template <bool SPLIT>
__global__ void __launch_bounds__(CTHREADS, 3)
    conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias, bf16* __restrict__ out,
                   float* __restrict__ ws, int B, int H, int W, int C, int O,
                   int steps_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int M = B * H * W;
  const int m0 = blockIdx.x * CBM;
  const int n0 = blockIdx.y * CBN;
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;

  // this thread's share of the A tile: rows t/8 + 32*i, 16-byte chunk t%8
  const int a_chunk = (t & 7) * 8;
  int a_h[A_ROWS_PER_THREAD], a_w[A_ROWS_PER_THREAD];
  long long a_pix[A_ROWS_PER_THREAD];  // pixel index b*H*W + h*W + w
#pragma unroll
  for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
    const int m = m0 + (t >> 3) + 32 * i;
    if (m < M) {
      const int hw = m % (H * W);
      a_h[i] = hw / W;
      a_w[i] = hw % W;
      a_pix[i] = m;
    } else {
      a_h[i] = -4;  // no tap brings it inside the image: always zero-filled
      a_w[i] = -4;
      a_pix[i] = 0;
    }
  }

  const int k_slices = C / CBK;
  const int step0 = SPLIT ? blockIdx.z * steps_per_split : 0;
  const int step1 = SPLIT ? min(9 * k_slices, step0 + steps_per_split)
                          : 9 * k_slices;

  auto load_step = [&](int step, int buf) {
    const int tap = step / k_slices, c0 = (step % k_slices) * CBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    bf16* As = smem + buf * STAGE;
    bf16* Bs = As + CBM * LDA;
#pragma unroll
    for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
      const int hh = a_h[i] + dy, ww = a_w[i] + dx;
      const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const bf16* p =
          ok ? x + (a_pix[i] + dy * W + dx) * C + c0 + a_chunk : x;
      cp_async16(As + ((t >> 3) + 32 * i) * LDA + a_chunk, p, ok);
    }
    const bf16* wb = w + ((long long)tap * C + c0) * O + n0;
#pragma unroll
    for (int i = 0; i < CBK * (CBN / 8) / CTHREADS; ++i) {  // 2
      const int idx = t + i * CTHREADS;
      const int r = idx >> 3, c = (idx & 7) * 8;
      cp_async16(Bs + r * LDB + c, wb + (long long)r * O + c, true);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  load_step(step0, 0);
  cp_async_commit();
  for (int step = step0; step < step1; ++step) {
    const int it = step - step0;
    // the buffer step+1 goes into was read last at step-1, and every warp
    // passed the barrier that ended that step
    if (step + 1 < step1) {
      load_step(step + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* As = smem + (it % NSTAGE) * STAGE;
    const bf16* Bs = As + CBM * LDA;
#pragma unroll
    for (int kk = 0; kk < CBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        // matrices: rows 0-7 / 8-15 at k 0-7, then rows 0-7 / 8-15 at k 8-15
        ldsm_x4(a[i], As + (wm + i * 16 + (lane & 15)) * LDA + kk * 16 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {  // two 8-wide column blocks a load
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, Bs + (kk * 16 + (lane & 15)) * LDB + wn + jp * 16 +
                               (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma16816(acc[i][2 * jp], a[i], bfr[0], bfr[1]);
          mma16816(acc[i][2 * jp + 1], a[i], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this step's buffer
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + j * 8 + tig * 2;
    const float b0 = SPLIT ? 0.f : __bfloat162float(bias[col]);
    const float b1 = SPLIT ? 0.f : __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows g and g + 8
        const long long r = m0 + wm + i * 16 + g + 8 * half;
        if (r >= M) continue;
        const float v0 = acc[i][j][2 * half] + b0;
        const float v1 = acc[i][j][2 * half + 1] + b1;
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

}  // namespace

// C interface (loaded with ctypes). x [B,H,W,C], w [9,C,O], bias [O] and
// out [B,H,W,O] are contiguous bf16; C and O are multiples of 64. With
// splits > 1, ws is an fp32 workspace of splits*B*H*W*O elements and the
// 9*C/64 steps are cut into that many ranges. The wrapper checks. Returns
// the first error of the launches (0 = success).
extern "C" int rtt_conv3x3_fwd(const void* x, const void* w, const void* bias,
                               void* out, void* ws, int splits, int B, int H,
                               int W, int C, int O, void* stream_) {
  const int n_steps = 9 * (C / CBK);
  if (C % CBK || O % CBN || B <= 0 || H <= 0 || W <= 0 || splits < 1 ||
      splits > n_steps || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  // above the 48 KB a block may declare statically
  const int smem = NSTAGE * STAGE * (int)sizeof(bf16);
  const long long M = (long long)B * H * W;
  dim3 grid((unsigned)((M + CBM - 1) / CBM), O / CBN, splits);
  if (splits == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    conv3x3_kernel<false><<<grid, CTHREADS, smem, stream>>>(
        (const bf16*)x, (const bf16*)w, (const bf16*)bias, (bf16*)out, nullptr,
        B, H, W, C, O, n_steps);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int per = (n_steps + splits - 1) / splits;
  if ((long long)per * (splits - 1) >= n_steps)  // a split would be empty
    return (int)cudaErrorInvalidValue;
  conv3x3_kernel<true><<<grid, CTHREADS, smem, stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)bias, nullptr, (float*)ws,
      B, H, W, C, O, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long MO = M * O;
  conv3x3_reduce_kernel<<<(unsigned)((MO / 2 + 255) / 256), 256, 0, stream>>>(
      (const float*)ws, (const bf16*)bias, (bf16*)out, MO, O, splits);
  return (int)cudaGetLastError();
}
