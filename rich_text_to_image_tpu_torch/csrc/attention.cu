// Self-attention kernels for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the four attention Pallas kernels of the JAX package
// (rich_text_to_image_tpu/ops/attention.py):
//   * attn_fwd_kernel   <- _full_kernel   (SD 64^2 self-attention, d=40)
//                       <- _full_kernel_t (SD 32^2 self-attention, d=80)
//                       <- _flash_kernel  (rows too long for the TPU's
//                          full-row layout: the 96^2 level of a 768^2 image,
//                          the 128^2 level of a 1024^2 one; d=40)
//   * attn_fwd_kernel with LSE, then attn_pavg_kernel
//                       <- _full_kernel_avgp (the capture layers: the output
//                          plus the head-averaged probabilities)
//
// What bounds them on an H100. At the paths' shapes attention does 4*S*S*d
// FLOPs for 2*(3*S*d) bf16 bytes per (batch, head): S=4096, d=40 is ~1,000
// FLOPs per byte, far above the card's ~295 FLOP/B ridge, so the tensor
// cores (989 TFLOP/s bf16) and the exponentials (one exp2 per score on the
// 16-wide-per-SM special-function unit) bound it, not device memory; at
// d=40 the exponentials take longer than the products. The capture adds a
// [B, Sq, Skv] fp32 write, which is bytes.
//
// What the design does about it. The TPU kernels keep the whole K/V row of
// one (batch, head) in VMEM (~16 MB), and the JAX dispatch sends rows that do
// not fit there to an online-softmax kernel. A Hopper block has at most
// 227 KB of shared memory and K+V of one (batch, head) at S=4096 is ~786 KB,
// so here every row streams: K/V pass through shared memory in tiles, with
// an online softmax in fp32 (exp2, log2(e) folded into the scale). The three
// JAX kernels that compute softmax(Q K^T) V are one function, so one kernel,
// attn_fwd_kernel, templated on the padded head dim (40 -> 48, 80 -> 80, 160
// for the 1280-channel level at sizes above 512^2; SDXL's 64 and FLUX.1's
// 128 as they are),
// serves them all; the wrapper keeps the JAX dispatch only to count
// launches per JAX kernel.
//   * both products are wgmma (wgmma.cuh). S = Q K^T reads K from shared
//     memory, K-major, 16 of the head dim a product, and Q from shared
//     memory too or, at d <= 48, from registers; O += P V takes P from
//     registers (the score sums re-packed to bf16, so probabilities never
//     touch memory) and V from shared memory as it lies in device memory,
//     [keys][head dim], as an MN-major operand: no transpose pass. With P
//     staged through shared memory instead the kernel was slower;
//   * a CTA is one to three warpgroups of 64 query rows that multiply, plus
//     one that copies. With more rows a CTA a K/V tile serves more of them
//     and, what counts most, more warps an SM take the softmax at once: one
//     warp alone starts an exp2 every ~16 clocks, half of what its quarter
//     of the SM's special-function units could take. ops/attention.py
//     (_fwd_tile) picks the rows from the number of waves the CTAs run in;
//   * K/V tiles arrive in a ring of three or four stages (what fits beside
//     the Q tile), written by the copying warpgroup with cp.async straight
//     to the 128-byte swizzled places the wgmma descriptors name; the copy
//     zero-fills the ragged tail, and the head-dim padding is cleared once.
//     A stage has two barriers in shared memory (mbarrier): `full`, which
//     the copying threads' copies complete, and `empty`, at which the
//     multiplying threads arrive when their products on the tile are done;
//     the warpgroups meet at no CTA-wide barrier after the start. The
//     copying warpgroup hands most of its registers to the others
//     (setmaxnreg). cp.async rather than TMA: a head's row is 80 bytes at
//     d = 40, which TMA would have to fetch as a 4-D box per launch-time
//     tensor map (three maps a launch, encoded on the host, whose launches
//     are what the UNet forward waits for), while cp.async needs nothing
//     from the host; each thread's chunk addresses are decoded once
//     (TileCopier), so a tile costs the copying warps a few instructions;
//   * the softmax of tile t+1 runs while the tensor cores do O += P(t) V(t):
//     a turn starts S(t+1) and PV(t), waits for the first, takes the softmax,
//     then waits for the second. The warpgroups take turns at starting
//     (named barriers), so that one's softmax runs beside the next one's
//     products;
//   * where the head dim leaves padding (d = 40 in 48), the first padding
//     column of every V tile holds ones, so the P V product also sums each
//     row's probabilities into that column of O: the softmax, which the
//     exponentials already bound, no longer adds them up;
//   * zero-filled keys past a ragged end score 0, far above real scores, so
//     the last tile masks them to -inf before the max.
// The capture layers need p/(l H) summed over the heads, [Sq, Skv] a batch
// row. The TPU kernel holds a whole row of scores in VMEM and sums the heads
// in one pass; here a [64 x Skv] fp32 row block does not fit shared memory,
// and a normalised p needs its row's sum first. So the capture is two
// launches, both deterministic, with no atomics and no per-head
// probabilities in device memory:
//   * attn_fwd_kernel with LSE also stores each row's log2-sum-exp, lse =
//     m + log2(l) in log2 units, fp32 [B, H, Sq];
//   * attn_pavg_kernel: a CTA owns (batch row, 64 or 128 query rows, 128
//     keys) and loops over the heads. For each head the copying warpgroup
//     brings the head's Q rows and K keys into a ring stage; each
//     multiplying warpgroup takes S = Q K^T by wgmma and adds
//     p = exp2(S c - lse) into fp32 registers. The sum over the heads is
//     written once, times 1/H, by the only CTA that owns those entries.
// Their times are in PERF.md.

#include "wgmma.cuh"

namespace {

using namespace rtt;

constexpr int SM_SMEM = 233472;  // shared memory of one SM, 1 KB a CTA reserved
constexpr int MIN_STAGES = 3;    // tiles t and t+1 are read while one lands

constexpr int ring_stages(int fixed_bytes, int stage_bytes) {
  // what is left of an SM after the reserve, the alignment slack, the
  // barriers and the tiles outside the ring, in stages, at most 4
  const int ns = (SM_SMEM - 3072 - fixed_bytes) / stage_bytes;
  return ns > 4 ? 4 : ns;
}

// Whether the ring of attn_fwd_kernel<DP, TK, NWG> holds MIN_STAGES tiles.
constexpr bool fwd_fits(int dp, int tk, int nwg) {
  return ring_stages(((dp + 63) / 64) * 64 * nwg * SWZ_ROW,
                     2 * ((dp + 63) / 64) * tk * SWZ_ROW) >= MIN_STAGES;
}

// Shapes of attn_fwd_kernel<DP, TK, NWG>: NWG warpgroups of 64 query rows
// that multiply and one that copies, K/V tiles of TK keys, the padded head
// dim DP in chunks of 64 columns.
template <int DP, int TK, int NWG>
struct FwdCfg {
  static constexpr int NCH = (DP + 63) / 64;  // 64-column chunks of the head
  static constexpr int BM = 64 * NWG;
  static constexpr int NT = 128 * (NWG + 1);  // the last warpgroup copies
  static constexpr int Q_BYTES = NCH * BM * SWZ_ROW;
  static constexpr int KV_BYTES = NCH * TK * SWZ_ROW;  // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int NS = ring_stages(Q_BYTES, STAGE);
  static constexpr int BAR_BYTES = 1024;  // full[NS], empty[NS]; keeps 1024s
  // registers a thread after the warpgroups trade them. The CTA is given
  // NT x (65536 / NT rounded down to 8): 384 x 168 or 512 x 128; the
  // copying warpgroup keeps what its unrolled copies need without spilling
  // and the others share the rest (2 x 208 + 88, 3 x 144 + 80, a thread
  // each times 128).
  static constexpr int REGS_COPY = NWG == 2 ? 88 : 80;
  static constexpr int REGS_MMA = NWG == 2 ? 208 : 144;
  static_assert(NWG == 1 || 128 * (NWG * REGS_MMA + REGS_COPY) <=
                                NT * (65536 / NT / 8 * 8),
                "more registers than the CTA was given");
  static constexpr int SMEM = 1024 + BAR_BYTES + Q_BYTES + NS * STAGE;
  static_assert(NS >= MIN_STAGES, "the ring does not fit");
};

template <int TK>
__device__ __forceinline__ void scores_mma(float* s, uint64_t dq, uint64_t dk,
                                           int scale_d) {
  if constexpr (TK == 64) wgmma_ss_n64<0>(s, dq, dk, scale_d);
  else wgmma_ss_n128<0>(s, dq, dk, scale_d);
}

template <int DP>
__device__ __forceinline__ void pv_mma(float* o, const uint32_t a[4],
                                       uint64_t dv) {
  if constexpr (DP == 48) wgmma_rs_n48<1>(o, a, dv, 1);
  else if constexpr (DP == 64) wgmma_rs_n64<1>(o, a, dv, 1);
  else if constexpr (DP == 80) wgmma_rs_n80<1>(o, a, dv, 1);
  else if constexpr (DP == 128) wgmma_rs_n128<1>(o, a, dv, 1);
  else wgmma_rs_n160<1>(o, a, dv, 1);
}

// One tile of the online softmax on the score sums s (this thread's two
// rows, g and g + 8, against keys n0 .. n0 + TK - 1): updates the running
// max m (log2 units) and, with sum_l, the sum l, leaves the factors al by
// which the earlier sums shrink, and turns s into the probabilities, in
// place.
template <int TK>
__device__ __forceinline__ void softmax_tile(float* s, float m[2], float l[2],
                                             float al[2], int n0, int skv,
                                             int tig, float scale_log2,
                                             bool sum_l) {
  if (n0 + TK > skv) {  // zero-filled keys past the row's end score 0
#pragma unroll
    for (int i = 0; i < TK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + i * 8 + tig * 2 + (e & 1);
        s[4 * i + e] = col < skv ? s[4 * i + e] : -INFINITY;
      }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < TK / 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  // every tile holds at least one unmasked key, so the new max is finite;
  // the scale is positive (the wrapper checks), so it commutes with max
  const float mn0 = fmaxf(m[0], quad_max(mx0) * scale_log2);
  const float mn1 = fmaxf(m[1], quad_max(mx1) * scale_log2);
  al[0] = fast_exp2(m[0] - mn0);
  al[1] = fast_exp2(m[1] - mn1);
#pragma unroll
  for (int i = 0; i < TK / 8; ++i) {
    s[4 * i] = fast_exp2(fmaf(s[4 * i], scale_log2, -mn0));
    s[4 * i + 1] = fast_exp2(fmaf(s[4 * i + 1], scale_log2, -mn0));
    s[4 * i + 2] = fast_exp2(fmaf(s[4 * i + 2], scale_log2, -mn1));
    s[4 * i + 3] = fast_exp2(fmaf(s[4 * i + 3], scale_log2, -mn1));
  }
  if (sum_l) {
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int i = 0; i < TK / 8; ++i) {
      ls0 += s[4 * i] + s[4 * i + 1];
      ls1 += s[4 * i + 2] + s[4 * i + 3];
    }
    l[0] = l[0] * al[0] + ls0;  // per-thread partial sums; the quad is summed last
    l[1] = l[1] * al[1] + ls1;
  }
  m[0] = mn0;
  m[1] = mn1;
}

// softmax(Q K^T * scale) V for one tile of 64 * NWG query rows of one
// (batch, head); warpgroup w < NWG owns rows 64 w .. 64 w + 63 of the tile,
// warpgroup NWG copies K and V. With LSE it also stores each row's
// log2-sum-exp of the scaled scores (log2 units) at lse[(b H + h) Sq + row].
template <int DP, int TK, int NWG, bool LSE>
__global__ void __launch_bounds__(FwdCfg<DP, TK, NWG>::NT, 1)
    attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int H, int sq, int skv, int d,
                    Strides qs, Strides ks, Strides vs, Strides os,
                    float scale_log2) {
  using C = FwdCfg<DP, TK, NWG>;
  constexpr int NS = C::NS;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles start at 1024 bytes
  const uint32_t bars = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = bars + C::BAR_BYTES;
  const uint32_t ring = q_s + C::Q_BYTES;  // stage s: K at ring + s*STAGE, V after
  // full[s]: the copies of the tile in stage s have landed (one arrival a
  // copying thread); empty[s]: every multiplying thread is done with it
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * C::BM;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  bf16* ob = o + b * os.b + h * os.h;

  const int t = threadIdx.x;
  const int wg = t / 128;
  const int n_tiles = (skv + TK - 1) / TK;
  // column d of V holds ones where the padding has room for it; the log2-
  // sum-exp keeps the fp32 sum, which the head average is normalised by
  const bool ones = !LSE && d < DP;

  // all threads: the barriers, Q, and the head-dim padding of every K and V
  // tile (no copy writes it later)
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 128);
      mbar_init(empty(s), 128 * NWG);
    }
    mbar_fence_init();
  }
  load_rows_swz<DP, C::BM, C::NT>(q_s, qb, qs.s, q0, sq, d, t);
  cp_async_commit();
  if (d < DP) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      zero_pad_swz<DP, TK, C::NT>(ring + s * C::STAGE, d, t, 0u);
      zero_pad_swz<DP, TK, C::NT>(ring + s * C::STAGE + C::KV_BYTES, d, t,
                                  ones ? BF16_ONE : 0u);
    }
  }
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();  // the last barrier all warps meet at

  if (wg == NWG) {
    // ---- the copying warpgroup: tile j into stage j % NS, once the
    // multiplying warpgroups have released what was there
    if constexpr (NWG >= 2) regs_release<C::REGS_COPY>();
    const TileCopier<DP, TK, 128> kv_copy(d, t - 128 * NWG);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % NS;
      if (j >= NS) mbar_wait(empty(s), (j / NS - 1) & 1);
      const uint32_t st = ring + s * C::STAGE;
      kv_copy.copy(st, kb, ks.s, j * TK, skv);
      kv_copy.copy(st + C::KV_BYTES, vb, vs.s, j * TK, skv);
      mbar_arrive_copies(full(s));
    }
    cp_async_wait<0>();  // no copy outlives the CTA's shared memory
    return;
  }

  // ---- the multiplying warpgroups
  if constexpr (NWG >= 2) regs_take<C::REGS_MMA>();
  const int warp = (t / 32) % 4, lane = t % 32;
  const int g = lane >> 2, tig = lane & 3;
  // Q rows of this warpgroup, chunk c at + c * BM rows
  const uint64_t dq = desc_kmajor(q_s + wg * 64 * SWZ_ROW);
  // at d <= 48 with 64-key tiles Q is the register operand of S = Q K^T
  // instead (this thread's A fragments: rows 16 warp + g and + 8, columns
  // 2 tig, + 1 and 8 + 2 tig, + 1 of each 16-deep step), so that the product
  // reads only K from shared memory (1-2% faster). Wider heads would take
  // more registers than the warpgroups have (the compiler then serializes
  // the products); 128-key tiles already hold 64 score registers
  constexpr bool Q_REGS = DP == 48 && TK == 64;
  uint32_t qa[Q_REGS ? DP / 16 : 1][4];
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wg * 64 + warp * 16 + g + (e & 1) * 8;
        const int col = kk * 16 + (e >> 1) * 8 + tig * 2;
        asm volatile("ld.shared.b32 %0, [%1];\n"
                     : "=r"(qa[kk][e])
                     : "r"(q_s + (col / 64) * (C::BM * SWZ_ROW) +
                           swz_offset(row, col % 64 / 8) + (col % 8) * 2));
      }
  }
  // waits for tile j (one past the row's end reads the last again: a
  // product under a condition would make the compiler serialize them all,
  // and nothing uses that product) and starts s = Q K(j)^T, 16 of the head
  // dim a product; the products are not waited for
  auto start_scores = [&](float* s, int tile) {
    const int j = min(tile, n_tiles - 1);
    mbar_wait(full(j % NS), (j / NS) & 1);
    fence_async_smem();
    const uint64_t dk = desc_kmajor(ring + (j % NS) * C::STAGE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t dkk = dk + (kk / 4) * (TK * SWZ_ROW >> 4) + (kk % 4) * 2;
      if constexpr (Q_REGS)
        wgmma_rs_n64<0>(s, qa[kk], dkk, kk > 0);
      else
        scores_mma<TK>(
            s, dq + (kk / 4) * (C::BM * SWZ_ROW >> 4) + (kk % 4) * 2, dkk,
            kk > 0);
    }
  };

  float acc[DP / 8][4];
#pragma unroll
  for (int db = 0; db < DP / 8; ++db)
    acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // Tile t's probabilities P(t) are ready when its turn starts. The turn
  // starts S(t+1) = Q K(t+1)^T and O += P(t) V(t), takes the softmax of
  // S(t+1) while the second product runs, and packs P(t+1) once it is done
  // (the products read P from registers). Nothing is in flight when a turn
  // ends: the compiler serializes products it cannot follow around a loop.
  // The warpgroups take turns at starting (named barrier 1 + w is warpgroup
  // w's): the tensor cores then run S and PV of one, then of the next, so
  // each is a part of a turn ahead of the next and its softmax, on the
  // special-function units, runs beside the others' products.
  float s[TK / 2];
  uint32_t pa[TK / 16][4];  // P as A operands, 16 keys each
  float al[2];              // what the softmax of the next tile shrinks O by
  auto pack_p = [&]() {
#pragma unroll
    for (int kt = 0; kt < TK / 16; ++kt) {
      pa[kt][0] = pack_bf16(s[8 * kt], s[8 * kt + 1]);
      pa[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
      pa[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
      pa[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
    }
  };
  start_scores(s, 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<TK / 2>(s);
  softmax_tile<TK>(s, m, l, al, 0, skv, tig, scale_log2, !ones);
  pack_p();
  if (NWG >= 2 && wg == NWG - 1) bar_arrive(1, 256);  // warpgroup 0 starts first

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (NWG >= 2) bar_sync(1 + wg, 256);  // this warpgroup's turn to start
    start_scores(s, tile + 1);
    wgmma_commit();
#pragma unroll
    for (int db = 0; db < DP / 8; ++db) {
      acc[db][0] *= al[0]; acc[db][1] *= al[0];
      acc[db][2] *= al[1]; acc[db][3] *= al[1];
    }
    // O += P V: V as it lies in device memory, [keys][head dim], 16 keys
    // (2048 bytes) a product, head-dim columns 64.. in the next chunk
    const uint64_t dv = desc_mnmajor(
        ring + (tile % NS) * C::STAGE + C::KV_BYTES, TK * SWZ_ROW);
    fence_regs<DP / 2>(&acc[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < TK / 16; ++kt)
      pv_mma<DP>(&acc[0][0], pa[kt], dv + kt * (16 * SWZ_ROW >> 4));
    wgmma_commit();
    if (NWG >= 2) bar_arrive(1 + (wg + 1) % NWG, 256);  // the next one's turn

    wgmma_wait<1>();  // S(tile + 1)
    fence_regs<TK / 2>(s);
    if (tile + 1 < n_tiles)
      softmax_tile<TK>(s, m, l, al, (tile + 1) * TK, skv, tig, scale_log2,
                       !ones);
    wgmma_wait<0>();  // PV(tile): this thread is done with the tile's stage
    fence_regs<DP / 2>(&acc[0][0]);
    // (the clamped S(n_tiles) of the last turn read the last tile, whose
    // stage no copy is waiting for)
    mbar_arrive(empty(tile % NS));
    pack_p();
  }

  float l0, l1;  // the rows' sums of probabilities
  if (ones) {    // column d of O, held by the quad's first thread
    float c0 = 0.f, c1 = 0.f;
#pragma unroll
    for (int db = 0; db < DP / 8; ++db)
      if (db * 8 == d) {
        c0 = acc[db][0];
        c1 = acc[db][2];
      }
    l0 = __shfl_sync(0xffffffffu, c0, lane & ~3);
    l1 = __shfl_sync(0xffffffffu, c1, lane & ~3);
  } else {
    l0 = quad_sum(l[0]);
    l1 = quad_sum(l[1]);
  }
  const int r0 = q0 + wg * 64 + warp * 16 + g;
  store_out<DP>(ob, os.s, acc, r0, sq, d, tig, 1.f / l0, 1.f / l1);
  if constexpr (LSE) {
    if (tig == 0) {
      float* lb = lse + (long long)blockIdx.y * sq;
      if (r0 < sq) lb[r0] = m[0] + log2f(l0);
      if (r0 + 8 < sq) lb[r0 + 8] = m[1] + log2f(l1);
    }
  }
}

// Shapes of attn_pavg_kernel<DP, NWG>: NWG warpgroups of 64 query rows that
// multiply and one that copies; a ring stage holds one head's Q rows and K
// keys.
template <int DP, int NWG>
struct PavgCfg {
  static constexpr int TK = 128;  // keys a CTA
  static constexpr int NCH = (DP + 63) / 64;
  static constexpr int BM = 64 * NWG;
  static constexpr int NT = 128 * (NWG + 1);
  static constexpr int Q_BYTES = NCH * BM * SWZ_ROW;
  static constexpr int K_BYTES = NCH * TK * SWZ_ROW;
  static constexpr int STAGE = Q_BYTES + K_BYTES;
  static constexpr int NS = ring_stages(0, STAGE);
  static constexpr int BAR_BYTES = 1024;
  // two multiplying warpgroups trade registers as attn_fwd_kernel's do
  static constexpr int REGS_COPY = 88;
  static constexpr int REGS_MMA = 208;
  static constexpr int SMEM = 1024 + BAR_BYTES + NS * STAGE;
  static_assert(NS >= 2, "two heads' tiles do not fit");
};

// Two neighbouring entries of a row of the head average: one 8-byte store
// where both lie inside the row and the row length keeps it aligned.
__device__ __forceinline__ void store_pavg(float* row, int col, int skv,
                                           bool pairs, float x, float y) {
  if (pairs && col + 1 < skv) {
    *reinterpret_cast<float2*>(row + col) = make_float2(x, y);
  } else {
    if (col < skv) row[col] = x;
    if (col + 1 < skv) row[col + 1] = y;
  }
}

// pavg[b, i, j] = (1/H) sum_h exp2(S_h[i, j] c - lse[b, h, i]) for the
// query rows q0 .. q0 + 64 NWG - 1 and keys k0 .. k0 + 127 of batch row b,
// S_h = Q_h K_h^T and c = scale * log2(e); warpgroup NWG copies.
template <int DP, int NWG>
__global__ void __launch_bounds__(PavgCfg<DP, NWG>::NT, 1)
    attn_pavg_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const float* __restrict__ lse, float* __restrict__ pavg,
                     int H, int sq, int skv, int d, Strides qs, Strides ks,
                     float scale_log2) {
  using C = PavgCfg<DP, NWG>;
  constexpr int NS = C::NS, TK = C::TK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t bars = (smem_addr(smem_raw) + 1023u) & ~1023u;
  // stage s: Q at ring + s * STAGE, K after it
  const uint32_t ring = bars + C::BAR_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (NS + s); };

  const int k0 = blockIdx.x * TK, q0 = blockIdx.y * C::BM, b = blockIdx.z;
  const int t = threadIdx.x;
  const int wg = t / 128;

  if (t == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 128);
      mbar_init(empty(s), 128 * NWG);
    }
    mbar_fence_init();
  }
  if (d < DP) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      zero_pad_swz<DP, C::BM, C::NT>(ring + s * C::STAGE, d, t, 0u);
      zero_pad_swz<DP, TK, C::NT>(ring + s * C::STAGE + C::Q_BYTES, d, t, 0u);
    }
  }
  fence_async_smem();
  __syncthreads();

  if (wg == NWG) {
    // ---- the copying warpgroup: head j's tiles into stage j % NS
    if constexpr (NWG >= 2) regs_release<C::REGS_COPY>();
    const TileCopier<DP, C::BM, 128> q_copy(d, t - 128 * NWG);
    const TileCopier<DP, TK, 128> k_copy(d, t - 128 * NWG);
    for (int j = 0; j < H; ++j) {
      const int s = j % NS;
      if (j >= NS) mbar_wait(empty(s), (j / NS - 1) & 1);
      const uint32_t st = ring + s * C::STAGE;
      q_copy.copy(st, q + b * qs.b + j * qs.h, qs.s, q0, sq);
      k_copy.copy(st + C::Q_BYTES, k + b * ks.b + j * ks.h, ks.s, k0, skv);
      mbar_arrive_copies(full(s));
    }
    cp_async_wait<0>();
    return;
  }

  // ---- the multiplying warpgroups
  if constexpr (NWG >= 2) regs_take<C::REGS_MMA>();
  const int warp = (t / 32) % 4, lane = t % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = q0 + wg * 64 + warp * 16 + g;  // this thread's rows, and + 8
  float s[TK / 2], acc[TK / 2];
#pragma unroll
  for (int i = 0; i < TK / 2; ++i) acc[i] = 0.f;

  for (int h = 0; h < H; ++h) {
    // -lse of the two rows (rows past the end: anything, never stored)
    const float* lh = lse + ((long long)b * H + h) * sq;
    const float n0 = r0 < sq ? -lh[r0] : 0.f;
    const float n1 = r0 + 8 < sq ? -lh[r0 + 8] : 0.f;
    const int st = h % NS;
    mbar_wait(full(st), (h / NS) & 1);
    fence_async_smem();
    const uint32_t base = ring + st * C::STAGE;
    const uint64_t dq = desc_kmajor(base + wg * 64 * SWZ_ROW);
    const uint64_t dk = desc_kmajor(base + C::Q_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n128<0>(s, dq + (kk / 4) * (C::BM * SWZ_ROW >> 4) + (kk % 4) * 2,
                       dk + (kk / 4) * (TK * SWZ_ROW >> 4) + (kk % 4) * 2,
                       kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<TK / 2>(s);
    mbar_arrive(empty(st));  // the stage is free for head h + NS
#pragma unroll
    for (int i = 0; i < TK / 8; ++i) {
      acc[4 * i] += fast_exp2(fmaf(s[4 * i], scale_log2, n0));
      acc[4 * i + 1] += fast_exp2(fmaf(s[4 * i + 1], scale_log2, n0));
      acc[4 * i + 2] += fast_exp2(fmaf(s[4 * i + 2], scale_log2, n1));
      acc[4 * i + 3] += fast_exp2(fmaf(s[4 * i + 3], scale_log2, n1));
    }
  }

  // each quad writes 8 neighbouring floats of a row: whole 32-byte sectors
  const float inv_h = 1.f / H;
  const bool pairs = (skv & 1) == 0;
  float* pb = pavg + (long long)b * sq * skv;
#pragma unroll
  for (int i = 0; i < TK / 8; ++i) {
    const int col = k0 + 8 * i + 2 * tig;
    if (r0 < sq)
      store_pavg(pb + (long long)r0 * skv, col, skv, pairs,
                 acc[4 * i] * inv_h, acc[4 * i + 1] * inv_h);
    if (r0 + 8 < sq)
      store_pavg(pb + (long long)(r0 + 8) * skv, col, skv, pairs,
                 acc[4 * i + 2] * inv_h, acc[4 * i + 3] * inv_h);
  }
}

template <int DP, int TK, int NWG, bool LSE>
cudaError_t launch_fwd_tile(const bf16* q, const bf16* k, const bf16* v,
                            bf16* o, float* lse, int B, int H, int sq, int skv,
                            int d, Strides qs, Strides ks, Strides vs,
                            Strides os, float scale_log2,
                            cudaStream_t stream) {
  using C = FwdCfg<DP, TK, NWG>;
  static bool configured = false;  // once a process: the port drives one card
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<DP, TK, NWG, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((sq + C::BM - 1) / C::BM, B * H);
  attn_fwd_kernel<DP, TK, NWG, LSE><<<grid, C::NT, C::SMEM, stream>>>(
      q, k, v, o, lse, H, sq, skv, d, qs, ks, vs, os, scale_log2);
  return cudaGetLastError();
}

// block_m: 64, 128 or 192 query rows a CTA (one to three multiplying
// warpgroups); block_k: the keys a tile that measured fastest for the padded
// head dim and block_m (_FWD_TILES in ops/attention.py names them; other
// pairs are not built). Three warpgroups above DP = 80 (128, 160) would
// not fit the registers. lse: null, or where the rows' log2-sum-exp go.
template <int DP>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                       float* lse, int B, int H, int sq, int skv, int d,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale_log2, int block_m, int block_k,
                       cudaStream_t stream) {
  constexpr int TK1 = DP == 80 ? 128 : 64;  // with one warpgroup
  constexpr int TK2 = DP == 48 ? 128 : 64;  // with two
#define RTT_FWD_TILE(TK, NWG)                                                 \
  if (block_m == 64 * NWG && block_k == TK)                                   \
    return lse ? launch_fwd_tile<DP, TK, NWG, true>(                          \
                     q, k, v, o, lse, B, H, sq, skv, d, qs, ks, vs, os,       \
                     scale_log2, stream)                                      \
               : launch_fwd_tile<DP, TK, NWG, false>(                         \
                     q, k, v, o, lse, B, H, sq, skv, d, qs, ks, vs, os,       \
                     scale_log2, stream);
#ifdef RTT_ALL_TILES
  // every pair whose ring fits, for scripts/port_tile_sweep.py only (its
  // own build): some of them make ptxas serialize the products (C75xx)
  RTT_FWD_TILE(64, 1)
  RTT_FWD_TILE(64, 2)
  if constexpr (fwd_fits(DP, 128, 1)) { RTT_FWD_TILE(128, 1) }
  if constexpr (fwd_fits(DP, 128, 2)) { RTT_FWD_TILE(128, 2) }
  if constexpr (DP <= 80) {
    RTT_FWD_TILE(64, 3)
    if constexpr (fwd_fits(DP, 128, 3)) { RTT_FWD_TILE(128, 3) }
  }
#endif
  RTT_FWD_TILE(TK1, 1)
  RTT_FWD_TILE(TK2, 2)
  if constexpr (DP <= 80) {
    RTT_FWD_TILE(64, 3)
  }
#undef RTT_FWD_TILE
  return cudaErrorInvalidValue;
}

template <int DP, int NWG>
cudaError_t launch_pavg_tile(const bf16* q, const bf16* k, const float* lse,
                             float* pavg, int B, int H, int sq, int skv, int d,
                             Strides qs, Strides ks, float scale_log2,
                             cudaStream_t stream) {
  using C = PavgCfg<DP, NWG>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_pavg_kernel<DP, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((skv + C::TK - 1) / C::TK, (sq + C::BM - 1) / C::BM, B);
  attn_pavg_kernel<DP, NWG><<<grid, C::NT, C::SMEM, stream>>>(
      q, k, lse, pavg, H, sq, skv, d, qs, ks, scale_log2);
  return cudaGetLastError();
}

// block_m: 64 or 128 query rows a CTA (_pavg_tile in ops/attention.py);
// two warpgroups above head dim 80 would spill their registers.
template <int DP>
cudaError_t launch_pavg(const bf16* q, const bf16* k, const float* lse,
                        float* pavg, int B, int H, int sq, int skv, int d,
                        Strides qs, Strides ks, float scale_log2, int block_m,
                        cudaStream_t stream) {
  if (block_m == 64)
    return launch_pavg_tile<DP, 1>(q, k, lse, pavg, B, H, sq, skv, d, qs, ks,
                                   scale_log2, stream);
  if constexpr (DP <= 80) {
    if (block_m == 128)
      return launch_pavg_tile<DP, 2>(q, k, lse, pavg, B, H, sq, skv, d, qs,
                                     ks, scale_log2, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface (loaded with ctypes). Tensors are bf16 with a contiguous last
// dim; strides are in elements for the batch, head and sequence dims. The
// head dim d must be a multiple of 8 and at most 160 (RTT_DISPATCH in
// common.cuh); the wrapper checks. lse is fp32 [B, H, Sq], contiguous, and
// pavg fp32 [B, Sq, Skv], contiguous.
// Each entry returns cudaGetLastError() after the launch (0 = success).
extern "C" int rtt_attn_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int sq, int skv,
                            int d, long long qsb, long long qsh, long long qss,
                            long long ksb, long long ksh, long long kss,
                            long long vsb, long long vsh, long long vss,
                            long long osb, long long osh, long long oss,
                            float scale_log2, int block_m, int block_k,
                            void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  RTT_DISPATCH(launch_fwd, (const bf16*)q, (const bf16*)k, (const bf16*)v,
               (bf16*)o, (float*)lse, B, H, sq, skv, d, qs, ks, vs, os,
               scale_log2, block_m, block_k, (cudaStream_t)stream)
}

extern "C" int rtt_attn_pavg(const void* q, const void* k, const void* lse,
                             void* pavg, int B, int H, int sq, int skv, int d,
                             long long qsb, long long qsh, long long qss,
                             long long ksb, long long ksh, long long kss,
                             float scale_log2, int block_m, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss};
  RTT_DISPATCH(launch_pavg, (const bf16*)q, (const bf16*)k, (const float*)lse,
               (float*)pavg, B, H, sq, skv, d, qs, ks, scale_log2, block_m,
               (cudaStream_t)stream)
}
