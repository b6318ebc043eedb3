#!/usr/bin/env python3
"""Where attn_fwd_kernel's time goes: named variants of
``csrc/attention.cu``, each a few textual edits made in a throw-away copy
(under $TMPDIR, removed on exit), built side by side and timed in turns
against the source as it is, on the card.

    python3 scripts/port_attn_variants.py [variant ...]

Run from the repository's root on a machine with a CUDA card and nvcc. Each
variant is built into a library of its own (all compilers at once) and
called through the same C entry as ``ops/attention.flash_attention``, at the
tile ``_fwd_tile`` picks (or the variant's own, ``TILES``), at the streaming
bucket's shapes and the 64^2, 32^2 and 48^2 levels'. A name ``a+b`` is
variant a with b's edits too. Some variants compute a wrong result on
purpose (they take work out to see what it cost); the line says how far
each is from the plain version. Times are CUDA events around 20 launches
queued behind a busy card (``chip_smoke._time_ms``), in the order base,
variants, base. With no argument every variant runs (~1 min).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = [(2, 8, 9216, 40), (4, 8, 9216, 40), (2, 8, 4096, 40),
          (2, 8, 1024, 80), (2, 8, 2304, 80)]

# name: [(text of attention.cu, its replacement), ...]
VARIANTS = {
    # the row sums added up by the softmax, as at d = 80 and 160, instead of
    # by the P V product through the ones column in V's padding
    "sum_alu": [("const bool ones = !LSE && d < DP;",
                 "const bool ones = false;")],
    # Q read from shared memory by S = Q K^T at every head dim
    "q_smem": [("constexpr bool Q_REGS = DP == 48 && TK == 64;",
                "constexpr bool Q_REGS = false;")],
    # Q from registers at every head dim with 64-key tiles (the compiler
    # serializes the products at d = 80 with three warpgroups and at
    # d = 160)
    "q_regs_all": [("constexpr bool Q_REGS = DP == 48 && TK == 64;",
                    "constexpr bool Q_REGS = TK == 64;")],
    # three warpgroups with tiles of 128 keys (S at N = 128)
    "rows192_keys128": [
        ("""  if constexpr (DP <= 80) {
    RTT_FWD_TILE(64, 3)
  }""", """  if constexpr (DP <= 80) {
    RTT_FWD_TILE(64, 3)
  }
  if constexpr (DP == 48) {
    RTT_FWD_TILE(128, 3)
  }"""),
    ],
    # P through shared memory: each warpgroup stores its P tile (64 rows x
    # 64 keys, the 128-byte swizzle, K-major) and P V reads both operands
    # from shared memory (d <= 48, 64-key tiles only)
    "pv_smem": [
        ("""template <int TK>
__device__ __forceinline__ void scores_mma(""", """template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n48(float* d, uint64_t desc_a,
    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\\n.reg .pred p;\\n"
      "setp.ne.b32 p, %26, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, %27;\\n}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TK>
__device__ __forceinline__ void scores_mma("""),
        ("""  static constexpr int SMEM = 1024 + BAR_BYTES + Q_BYTES + NS * STAGE;
  static_assert(NS >= MIN_STAGES, "the ring does not fit");""",
         """  static constexpr int P_BYTES = NWG * 64 * SWZ_ROW;
  static constexpr int SMEM = 1024 + BAR_BYTES + Q_BYTES + NS * STAGE + P_BYTES;
  static_assert(NS >= MIN_STAGES, "the ring does not fit");"""),
        ("""  auto pack_p = [&]() {
#pragma unroll
    for (int kt = 0; kt < TK / 16; ++kt) {
      pa[kt][0] = pack_bf16(s[8 * kt], s[8 * kt + 1]);
      pa[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
      pa[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
      pa[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
    }
  };""", """  const uint32_t p_s = ring + NS * C::STAGE + wg * 64 * SWZ_ROW;
  auto pack_p = [&]() {
    if constexpr (DP == 48 && TK == 64) {
      const int r = warp * 16 + g;
#pragma unroll
      for (int i = 0; i < TK / 8; ++i) {
        asm volatile("st.shared.b32 [%0], %1;\\n" ::"r"(
            p_s + swz_offset(r, i) + tig * 4), "r"(pack_bf16(s[4 * i], s[4 * i + 1])) : "memory");
        asm volatile("st.shared.b32 [%0], %1;\\n" ::"r"(
            p_s + swz_offset(r + 8, i) + tig * 4), "r"(pack_bf16(s[4 * i + 2], s[4 * i + 3])) : "memory");
      }
      fence_async_smem();
      bar_sync(8 + wg, 128);
    } else {
#pragma unroll
    for (int kt = 0; kt < TK / 16; ++kt) {
      pa[kt][0] = pack_bf16(s[8 * kt], s[8 * kt + 1]);
      pa[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
      pa[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
      pa[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
    }
    }
  };"""),
        ("""      pv_mma<DP>(&acc[0][0], pa[kt], dv + kt * (16 * SWZ_ROW >> 4));""",
         """      if constexpr (DP == 48 && TK == 64)
        wgmma_ss_n48<1>(&acc[0][0], desc_kmajor(p_s) + kt * 2,
                        dv + kt * (16 * SWZ_ROW >> 4), 1);
      else
        pv_mma<DP>(&acc[0][0], pa[kt], dv + kt * (16 * SWZ_ROW >> 4));"""),
    ],
    # P V of tile t issued before S of tile t+1, and both waited for before
    # the softmax: no product of the warpgroup is in flight during it
    "pv_first": [
        ("""    if (NWG >= 2) bar_sync(1 + wg, 256);  // this warpgroup's turn to start
    start_scores(s, tile + 1);
    wgmma_commit();
""", """    if (NWG >= 2) bar_sync(1 + wg, 256);  // this warpgroup's turn to start
"""),
        ("""    wgmma_commit();
    if (NWG >= 2) bar_arrive(1 + (wg + 1) % NWG, 256);  // the next one's turn

    wgmma_wait<1>();  // S(tile + 1)""", """    wgmma_commit();
    start_scores(s, tile + 1);
    wgmma_commit();
    if (NWG >= 2) bar_arrive(1 + (wg + 1) % NWG, 256);  // the next one's turn

    wgmma_wait<0>();"""),
    ],
    # the copying warpgroup signals each tile without copying it (wrong
    # result): what the copies from L2 cost
    "no_copy": [
        ("""      kv_copy.copy(st, kb, ks.s, j * TK, skv);
      kv_copy.copy(st + C::KV_BYTES, vb, vs.s, j * TK, skv);""", ""),
    ],
    # no P V product (wrong result)
    "no_pv": [
        ("pv_mma<DP>(&acc[0][0], pa[kt], dv + kt * (16 * SWZ_ROW >> 4));",
         ";"),
    ],
    # the warpgroups start their products when they are ready, not in turns
    "no_turns": [
        ("if (NWG >= 2) bar_sync(1 + wg, 256);", ";"),
        ("if (NWG >= 2) bar_arrive(1 + (wg + 1) % NWG, 256);", ";"),
        ("if (NWG >= 2 && wg == NWG - 1) bar_arrive(1, 256);", ";"),
    ],
    # no proxy fence after a tile's barrier (timing only: not safe)
    "no_fence": [
        ("    mbar_wait(full(j % NS), (j / NS) & 1);\n    fence_async_smem();",
         "    mbar_wait(full(j % NS), (j / NS) & 1);"),
    ],
    # the exponentials taken out (wrong result): what they cost
    "no_exp2": [
        ("s[4 * i] = fast_exp2(fmaf(s[4 * i], scale_log2, -mn0));",
         "s[4 * i] = fmaf(s[4 * i], scale_log2, -mn0);"),
        ("s[4 * i + 1] = fast_exp2(fmaf(s[4 * i + 1], scale_log2, -mn0));",
         "s[4 * i + 1] = fmaf(s[4 * i + 1], scale_log2, -mn0);"),
        ("s[4 * i + 2] = fast_exp2(fmaf(s[4 * i + 2], scale_log2, -mn1));",
         "s[4 * i + 2] = fmaf(s[4 * i + 2], scale_log2, -mn1);"),
        ("s[4 * i + 3] = fast_exp2(fmaf(s[4 * i + 3], scale_log2, -mn1));",
         "s[4 * i + 3] = fmaf(s[4 * i + 3], scale_log2, -mn1);"),
    ],
    # the whole softmax of the main loop taken out (wrong result): the
    # products, copies and barriers alone
    "no_softmax": [
        ("    if (tile + 1 < n_tiles)\n      softmax_tile<TK>(",
         "    if (tile + 1 < 0)\n      softmax_tile<TK>("),
    ],
}

# variants launched at another tile than _fwd_tile's (query rows, keys)
TILES = {"rows192_keys128": (192, 128)}


def _build(work: str, name: str, edits) -> tuple:
    from rich_text_to_image_tpu_torch.ops import build

    src_dir = os.path.join(work, name)
    shutil.copytree(build.CSRC, src_dir)
    path = os.path.join(src_dir, "attention.cu")
    with open(path, encoding="utf-8") as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: the edit does not apply: {old}")
        text = text.replace(old, new)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    lib = os.path.join(work, f"lib_{name}.so")
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return lib, proc


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_attn_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import _qkv, _smi, _time_ms
    from rich_text_to_image_tpu_torch.ops import attention as A

    names = argv or list(VARIANTS)
    print("device: " + _smi(), flush=True)
    work = tempfile.mkdtemp()
    try:
        # "a+b" is variant a with variant b's edits too
        procs = {n: _build(work, n, [e for part in n.split("+")
                                     if part != "base"
                                     for e in VARIANTS[part]])
                 for n in ["base", *names]}
        fns = {}
        for n, (lib, proc) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"variant {n} does not build:\n{err}")
            notes = [ln for ln in err.splitlines() if "C75" in ln]
            if notes:
                print(f"variant {n}: ptxas notes {notes}", flush=True)
            fn = ctypes.CDLL(lib).rtt_attn_fwd
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 12
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fns[n] = fn
        st = torch.cuda.current_stream().cuda_stream
        for b, h, s, d in SHAPES:
            q, k, v = _qkv(b, h, s, d, seed=s + d + b)
            scale = d ** -0.5
            want = A.flash_attention_stream_plain(q, k, v, scale)
            o_max = want.float().abs().max().item()
            out = A._out_like(q)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None, b, h, s, s, d, *A._strides(q), *A._strides(k),
                    *A._strides(v), *A._strides(out),
                    float(scale * A._LOG2E), *A._fwd_tile(b, h, s, d), st)
            res = {}
            for n in ["base", *names, "base"]:
                tile = [TILES[p] for p in n.split("+") if p in TILES]
                a = args[:-3] + tile[0] + args[-1:] if tile else args
                if fns[n](*a):
                    res.setdefault(n, []).append("not built at this shape")
                    continue
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs().max().item() / o_max
                ms = _time_ms(lambda: fns[n](*a), 20, plug=True)
                res.setdefault(n, []).append(f"{ms:.4f} ms (err {err:.1e})")
            print(f"attn_fwd_kernel {[b, h, s, d]} tile "
                  f"{A._fwd_tile(b, h, s, d)}: "
                  + "; ".join(f"{n} {', '.join(r)}" for n, r in res.items()),
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
