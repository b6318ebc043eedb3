// Hopper's warpgroup matrix product (wgmma, sm_90a only) and the
// shared-memory tiles it reads, for the package's kernels.
//
// A warpgroup (four consecutive warps, the first with warp index % 4 == 0)
// multiplies a 64-row A tile by a B tile of N columns, 16 deep a product,
// bf16 in, fp32 sums in registers. B always comes from shared memory and A
// from shared memory (wgmma_ss_*) or registers (wgmma_rs_*), and the
// product runs asynchronously: wgmma_fence() before the first product that
// touches registers the warpgroup has written, wgmma_commit() after a batch,
// wgmma_wait<N>() until at most N batches are in flight, and fence_regs()
// on the sums before ordinary code reads them.
//
// Shared-memory operands lie in the 128-byte swizzled layout: a tile is
// [rows][64 bf16] = 128 bytes a row, and the 16-byte chunk j of row r is
// stored at chunk j ^ (r % 8). The tile's base must be 1024-byte aligned
// (the swizzle is a function of the address bits). A matrix wider than 64
// is a sequence of such tiles ("chunks"), `rows * 128` bytes apart. The
// same bytes serve two readings:
//   * K-major (desc_kmajor): the rows are the M or N index and the 64
//     columns the depth; a product's 16-deep step is 32 bytes further along
//     the row (add 2 to the descriptor), the next chunk 64 deeper;
//   * MN-major (desc_mnmajor, with TRANS_B = 1): the rows are the depth and
//     the columns the N index, which is how V [keys][head dim] and a weight
//     block [channels][outputs] lie in device memory; a 16-deep step is 16
//     rows = 2048 bytes further (add 128), and N beyond 64 continues in the
//     next chunk, `lbo` bytes on.
// Register layouts (thread t of the warpgroup, warp w = t / 32, g = lane / 4,
// tig = lane % 4): the sums d[4i..4i+3] are columns 8i + 2 tig, + 1 of row
// 16 w + g and the same columns of row 16 w + g + 8; an A operand in
// registers is four packed bf16 pairs: (row, k = 2 tig), (row + 8, the same),
// (row, k = 8 + 2 tig), (row + 8, the same), which is the sums' layout of two
// neighbouring 8-column blocks rounded to bf16.
// The operand lists are written out because inline PTX takes no arrays.
//
// Around the products: copies into the swizzled tiles (load_rows_swz,
// TileCopier), barriers in shared memory between warps that copy and warps
// that multiply (mbar_*), named barriers for turns between warpgroups
// (bar_*), and the trade of registers between them (regs_*). The compiler
// follows asynchronous products only through straight code: one started
// under a condition, or sums touched by ordinary code while a product is in
// flight around a loop's end, make it serialize every product of the kernel
// (a C75xx note in the build log).
#pragma once

#include "common.cuh"

namespace rtt {

constexpr int SWZ_ROW = 128;    // bytes a swizzled row
constexpr int SWZ_ATOM = 1024;  // 8 rows: the unit the swizzle repeats in

// Byte offset of 16-byte chunk `j` (0..7) of row `r` inside a swizzled tile.
__device__ __forceinline__ uint32_t swz_offset(int r, int j) {
  return (uint32_t)(r * SWZ_ROW + ((j ^ (r & 7)) << 4));
}

// 16 bytes from device to shared memory without passing through registers;
// with valid == false nothing is read and the 16 bytes are zero-filled (src
// must still be an address inside the tensor).
__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src,
                                              bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(n)
               : "memory");
}

// Rows [row0, row0 + ROWS) of a [.][d] matrix (row stride `stride_s`
// elements) into the swizzled chunks at shared address `dst`
// (ceil(DP / 64) chunks of ROWS rows), with asynchronous copies by NT threads
// of which this is thread t; rows >= n_valid and columns >= d arrive as
// zeros, columns >= DP are not written (no product reads them).
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void load_rows_swz(uint32_t dst, const bf16* src,
                                              long long stride_s, int row0,
                                              int n_valid, int d, int t) {
  constexpr int CH = DP / 8;  // 16-byte chunks a row
  for (int idx = t; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, j = idx % CH;
    const bool ok = row0 + r < n_valid && j * 8 < d;
    const bf16* p = ok ? src + (long long)(row0 + r) * stride_s + j * 8 : src;
    cp_async16_to(dst + (j >> 3) * (ROWS * SWZ_ROW) + swz_offset(r, j & 7), p,
                  ok);
  }
}

constexpr uint32_t BF16_ONE = 0x3F80u;  // bf16 1.0 in a word's low half

// Zeros in the chunks of columns d .. DP of the tile of ROWS rows at
// `tile_s`, by NT threads of which this is thread t; with lead = BF16_ONE,
// column d itself holds ones.
template <int DP, int ROWS, int NT>
__device__ __forceinline__ void zero_pad_swz(uint32_t tile_s, int d, int t,
                                             uint32_t lead) {
  constexpr int CH = DP / 8;
  for (int idx = t; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, j = idx % CH;
    if (j * 8 >= d)
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %2, %2};\n" ::"r"(
                       tile_s + (j >> 3) * (ROWS * SWZ_ROW) +
                       swz_offset(r, j & 7)),
                   "r"(j * 8 == d ? lead : 0u), "r"(0)
                   : "memory");
  }
}

// The same copy for a kernel's main loop, where the rows of successive
// tiles go to the same places: each thread's chunks (row r, 16-byte chunk j)
// are decoded once, and a tile then costs an address, a comparison and a
// copy a chunk. Two matrices of one shape (K and V) share the decoding.
// Columns >= d are never copied: zero_pad_swz() clears them once.
template <int DP, int ROWS, int NT>
struct TileCopier {
  static constexpr int CH = DP / 8;  // 16-byte chunks a row
  static constexpr int ITERS = (ROWS * CH + NT - 1) / NT;
  static_assert(((DP + 63) / 64) * ROWS * SWZ_ROW <= 0x10000 && ROWS < 256,
                "a chunk is packed into 32 bits");
  // byte offset inside the tile | chunk j << 16 | row << 24; a row of ROWS
  // means nothing to copy
  uint32_t item[ITERS];

  __device__ __forceinline__ TileCopier(int d, int t) {
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int idx = t + i * NT;
      const int r = idx / CH, j = idx % CH;
      const bool live = idx < ROWS * CH && j * 8 < d;
      item[i] = ((j >> 3) * (ROWS * SWZ_ROW) + swz_offset(r, j & 7)) |
                (uint32_t)j << 16 | (uint32_t)(live ? r : ROWS) << 24;
    }
  }

  // Rows row0 .. row0 + ROWS - 1 of `src` into the tile at `tile_s`; rows
  // >= n_valid arrive as zeros.
  __device__ __forceinline__ void copy(uint32_t tile_s, const bf16* src,
                                       long long stride_s, int row0,
                                       int n_valid) const {
    const bf16* base = src + (long long)row0 * stride_s;
    const int left = n_valid - row0;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int r = item[i] >> 24, c = (item[i] >> 16 & 0xFF) * 8;
      if (r < ROWS) {
        const bool ok = r < left;
        cp_async16_to(tile_s + (item[i] & 0xFFFF),
                      ok ? base + r * stride_s + c : src, ok);
      }
    }
  }
};

__device__ __forceinline__ uint64_t desc_encode(uint32_t saddr, uint32_t lbo,
                                                uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);  // 128-byte swizzle
}

// Rows = M or N index, 8-row groups 1024 bytes apart; the leading offset is
// not used by this layout.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t saddr) {
  return desc_encode(saddr, 16, SWZ_ATOM);
}

// Rows = depth, 8-row groups 1024 bytes apart; columns 64.. in the chunk
// `lbo` bytes on.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t saddr,
                                                 uint32_t lbo = 16) {
  return desc_encode(saddr, lbo, SWZ_ATOM);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the asynchronous product's start or wait; emits no instruction.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Writes made to shared memory by ordinary stores or cp.async become
// visible to wgmma's reads (the asynchronous proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barriers in shared memory (mbarrier) between the warps that fill a ring
// of tiles and those that read it. A barrier completes a phase when `count`
// arrivals have come in; a waiter names the parity (0, 1, 0, ...) of the
// phase it waits for. mbar_arrive_copies() makes the calling thread's
// arrival wait for its earlier cp.async copies.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// After the inits, before any thread uses the barriers.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Waits for the phase of parity `parity`. A wait that outlasts any copy or
// product (seconds) stops the kernel with an error instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1 << 20)) __trap();
  }
}

// Named barriers (1..15; __syncthreads is barrier 0) for handing a turn from
// one warpgroup to another: the waiting warps bar_sync, the releasing warps
// bar_arrive and go on; `threads` counts both.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Moves registers between the warpgroups of a CTA (all four warps of a
// warpgroup execute it): the copying warpgroup gives up what the
// multiplying ones need.
template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x on the special-function unit, denormals flushed to zero.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (+)= A B for one warpgroup: wgmma_ss_nN takes A [64][16] and B [16][N]
// from shared memory (descriptors), wgmma_rs_nN takes A from registers;
// TRANS_B = 1 reads B MN-major; scale_d = 0 starts the sums at zero. Built
// for the widths the kernels use.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n160(float* d, uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, %83;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t a[4],
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n48(float* d, const uint32_t a[4],
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t a[4],
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t a[4],
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n160(float* d, const uint32_t a[4],
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, %86;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

}  // namespace rtt
