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
// full-row layout does not carry over: K/V stream through shared memory in
// tiles, with an online softmax in fp32 (exp2, log2(e) folded into the
// scale). K1 and K2 compute the same function: the TPU's transposed layout
// answered a 128-lane padding cost that Hopper does not have, so one kernel,
// attn_fwd_kernel, templated on the padded head dim (40 -> 48, 80 -> 80,
// 160 for the 1280-channel level at sizes above 512^2), serves both:
//   * both products are wgmma (wgmma.cuh). S = Q K^T reads Q and K from
//     shared memory, K-major, 16 of the head dim a product; O += P V takes P
//     from registers (the score sums re-packed to bf16, so probabilities
//     never touch memory) and V from shared memory as it lies in device
//     memory, [keys][head dim], as an MN-major operand: no transpose pass;
//   * a CTA is one to three warpgroups of 64 query rows that multiply, plus
//     one that copies. With more rows a CTA a K/V tile serves more of them
//     (a head's row leaves L2 a third as often at 192 rows as at 64) and,
//     what counts most, more warps an SM take the softmax at once: one
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
//   * zero-filled keys past a ragged end score 0, far above real scores, so
//     the last tile masks them to -inf before the max.
// attn_avgp_kernel (mma.sync, one warp a head) is deterministic, with no
// atomics: one CTA owns (batch, 16-row Q tile), and its 4 warps take 4 heads
// at a time, each with its own K/V tiles. Per head a first KV pass finds
// each row's max and sum; a second recomputes the scores, writes O, and puts
// p/(l*H) into the warp's slot in shared memory, whose 4 slots are summed in
// a fixed order and added to the pavg rows the CTA alone owns. Owning 16
// rows (not 64) gives 128 CTAs at B=2, S=1024, enough for the card.
// Their times are in PERF.md.

#include "wgmma.cuh"

namespace {

using namespace rtt;

constexpr int NWARPS = 4;     // warps per CTA, each owning 16 query rows
constexpr int NTHREADS = NWARPS * 32;

// The pieces of attn_avgp_kernel. Scores of this warp's 16 rows against the
// 64 keys in Ks, scaled to log2 units, with keys >= kv_len masked to -inf.
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

// Shapes of attn_fwd_kernel<DP, TK, NWG>: NWG warpgroups of 64 query rows
// that multiply and one that copies, K/V tiles of TK keys, the padded head
// dim DP in chunks of 64 columns.
constexpr int SM_SMEM = 233472;  // shared memory of one SM, 1 KB a CTA reserved
constexpr int MIN_STAGES = 3;    // tiles t and t+1 are read while one lands

constexpr int ring_stages(int q_bytes, int stage_bytes) {
  // what is left of an SM after the reserve, the alignment slack, the
  // barriers and the Q tile, in stages, at most 4
  const int ns = (SM_SMEM - 3072 - q_bytes) / stage_bytes;
  return ns > 4 ? 4 : ns;
}

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
  else if constexpr (DP == 80) wgmma_rs_n80<1>(o, a, dv, 1);
  else wgmma_rs_n160<1>(o, a, dv, 1);
}

// One tile of the online softmax on the score sums s (this thread's two
// rows, g and g + 8, against keys n0 .. n0 + TK - 1): updates the running
// max m (log2 units) and sum l, leaves the factors al by which the earlier
// sums shrink, and turns s into the probabilities, in place.
template <int TK>
__device__ __forceinline__ void softmax_tile(float* s, float m[2], float l[2],
                                             float al[2], int n0, int skv,
                                             int tig, float scale_log2) {
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
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int i = 0; i < TK / 8; ++i) {
    s[4 * i] = fast_exp2(fmaf(s[4 * i], scale_log2, -mn0));
    s[4 * i + 1] = fast_exp2(fmaf(s[4 * i + 1], scale_log2, -mn0));
    s[4 * i + 2] = fast_exp2(fmaf(s[4 * i + 2], scale_log2, -mn1));
    s[4 * i + 3] = fast_exp2(fmaf(s[4 * i + 3], scale_log2, -mn1));
    ls0 += s[4 * i] + s[4 * i + 1];
    ls1 += s[4 * i + 2] + s[4 * i + 3];
  }
  l[0] = l[0] * al[0] + ls0;  // per-thread partial sums; the quad is summed last
  l[1] = l[1] * al[1] + ls1;
  m[0] = mn0;
  m[1] = mn1;
}

// softmax(Q K^T * scale) V for one tile of 64 * NWG query rows of one
// (batch, head); warpgroup w < NWG owns rows 64 w .. 64 w + 63 of the tile,
// warpgroup NWG copies K and V.
template <int DP, int TK, int NWG>
__global__ void __launch_bounds__(FwdCfg<DP, TK, NWG>::NT, 1)
    attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                    int sq, int skv, int d, Strides qs, Strides ks, Strides vs,
                    Strides os, float scale_log2) {
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
    for (int s = 0; s < 2 * NS; ++s)
      zero_pad_swz<DP, TK, C::NT>(ring + s * C::KV_BYTES, d, t);
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
    for (int kk = 0; kk < DP / 16; ++kk)
      scores_mma<TK>(s,
                     dq + (kk / 4) * (C::BM * SWZ_ROW >> 4) + (kk % 4) * 2,
                     dk + (kk / 4) * (TK * SWZ_ROW >> 4) + (kk % 4) * 2,
                     kk > 0);
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
  softmax_tile<TK>(s, m, l, al, 0, skv, tig, scale_log2);
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
      softmax_tile<TK>(s, m, l, al, (tile + 1) * TK, skv, tig, scale_log2);
    wgmma_wait<0>();  // PV(tile): this thread is done with the tile's stage
    fence_regs<DP / 2>(&acc[0][0]);
    // (the clamped S(n_tiles) of the last turn read the last tile, whose
    // stage no copy is waiting for)
    mbar_arrive(empty(tile % NS));
    pack_p();
  }
  store_out<DP>(ob, os.s, acc, q0 + wg * 64 + warp * 16 + g, sq, d, tig,
                1.f / quad_sum(l[0]), 1.f / quad_sum(l[1]));
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

template <int DP, int TK, int NWG>
cudaError_t launch_fwd_tile(const bf16* q, const bf16* k, const bf16* v,
                            bf16* o, int B, int H, int sq, int skv, int d,
                            Strides qs, Strides ks, Strides vs, Strides os,
                            float scale_log2, cudaStream_t stream) {
  using C = FwdCfg<DP, TK, NWG>;
  static bool configured = false;  // once a process: the port drives one card
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<DP, TK, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((sq + C::BM - 1) / C::BM, B * H);
  attn_fwd_kernel<DP, TK, NWG><<<grid, C::NT, C::SMEM, stream>>>(
      q, k, v, o, H, sq, skv, d, qs, ks, vs, os, scale_log2);
  return cudaGetLastError();
}

// block_m: 64, 128 or 192 query rows a CTA (one to three multiplying
// warpgroups); block_k: the keys a tile that measured fastest for the padded
// head dim and block_m (_fwd_tile in ops/attention.py names them; other
// pairs are not built). Three warpgroups at DP = 160 would not fit the
// registers.
template <int DP>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                       int B, int H, int sq, int skv, int d, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale_log2,
                       int block_m, int block_k, cudaStream_t stream) {
  constexpr int TK1 = DP == 80 ? 128 : 64;  // with one warpgroup
  constexpr int TK2 = DP == 48 ? 128 : 64;  // with two
#define RTT_FWD_TILE(TK, NWG)                                               \
  if (block_m == 64 * NWG && block_k == TK)                                 \
    return launch_fwd_tile<DP, TK, NWG>(q, k, v, o, B, H, sq, skv, d, qs, ks, \
                                        vs, os, scale_log2, stream);
  RTT_FWD_TILE(TK1, 1)
  RTT_FWD_TILE(TK2, 2)
  if constexpr (DP <= 80) {
    RTT_FWD_TILE(64, 3)
  }
#undef RTT_FWD_TILE
  return cudaErrorInvalidValue;
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
                            float scale_log2, int block_m, int block_k,
                            void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  RTT_DISPATCH(launch_fwd, (const bf16*)q, (const bf16*)k, (const bf16*)v,
               (bf16*)o, B, H, sq, skv, d, qs, ks, vs, os, scale_log2, block_m,
               block_k, (cudaStream_t)stream)
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
