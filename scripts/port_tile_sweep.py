#!/usr/bin/env python3
"""Sweep of the tile shapes of the port's wgmma kernels on the card.

    python3 scripts/port_tile_sweep.py attention
    python3 scripts/port_tile_sweep.py pavg
    python3 scripts/port_tile_sweep.py conv [--full]

Run from the repository's root on a machine with a CUDA card and nvcc. For
every shape the paths give ``attn_fwd_kernel`` (the long rows of the
streaming bucket included), ``attn_pavg_kernel`` or ``conv3x3_kernel`` it
calls the kernel's C entry directly with each tile shape (and, for the
convolution, each split over K) the source builds, holds the result against
the plain PyTorch version, and prints the time of each beside the library
call's (``scaled_dot_product_attention``, ``F.conv2d``; none computes the
head average). For ``attn_fwd_kernel`` it builds the sources a second time
with ``-DRTT_ALL_TILES``, which adds every tile pair whose ring fits to the
ones the package builds. The rules that pick a tile in ``ops/attention._fwd_tile``,
``ops/attention._pavg_tile`` and ``ops/conv._plan`` were fitted to this
script's output; it prints the rule's choice beside the fastest one.
Times are CUDA events around 20 launches queued behind a busy card
(``chip_smoke._time_ms`` with its plug), so they are device times.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ATTN_SHAPES = [(2, 8, 4096, 40), (4, 8, 4096, 40), (6, 8, 4096, 40),
               (2, 8, 4000, 40), (2, 8, 1024, 80), (4, 8, 1024, 80),
               (6, 8, 1024, 80), (4, 8, 1000, 80), (2, 8, 2304, 80),
               (4, 8, 2304, 80), (2, 8, 576, 160), (4, 8, 576, 160),
               (2, 8, 520, 160), (2, 8, 1024, 64), (1, 8, 512, 80),
               (1, 8, 1024, 40),
               # the streaming bucket's long rows: 768^2 and 1024^2 samples
               (2, 8, 9216, 40), (4, 8, 9216, 40), (2, 8, 16384, 40),
               (1, 2, 16384, 40),
               # SDXL at 1024^2: the 64^2 and 32^2 levels, head dim 64, at
               # the plain pass's batch 2 and the rich passes' R+2, R+4
               (2, 10, 4096, 64), (4, 10, 4096, 64), (6, 10, 4096, 64),
               (2, 20, 1024, 64), (4, 20, 1024, 64), (6, 20, 1024, 64),
               (2, 20, 1000, 64),
               # FLUX.1 at 1024^2: the joint attention over [512 text ; 4096
               # image] tokens, head dim 128, at the plain pass's one row and
               # the rich pass's R + 1 = 2
               (1, 24, 4608, 128), (2, 24, 4608, 128)]
PAVG_SHAPES = [(2, 8, 1024, 80), (2, 8, 1000, 80), (2, 8, 2304, 80),
               (2, 8, 576, 160), (2, 8, 1024, 160), (4, 8, 1024, 80),
               (1, 8, 1024, 80), (2, 8, 4096, 40), (2, 20, 1024, 64),
               (2, 20, 1000, 64)]
# a second build of the sources with every (query rows, keys) pair of
# attn_fwd_kernel whose ring fits, beside the package's own
ALL_TILES = ("-DRTT_ALL_TILES",)


def sweep_attention() -> None:
    import torch
    import torch.nn.functional as F

    from chip_smoke import OUT_RTOL, _qkv, _time_ms
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.ops import build

    lib = build.library(ALL_TILES)
    st = torch.cuda.current_stream().cuda_stream
    for b, h, s, d in ATTN_SHAPES:
        q, k, v = _qkv(b, h, s, d, seed=s + d + b)
        scale = d ** -0.5
        want = (A.flash_attention_stream_plain(q, k, v, scale)
                if A._bucket(s, s, d) == "stream"
                else A.flash_attention_plain(q, k, v, scale))
        o_max = want.float().abs().max().item()
        sdpa = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 20, plug=True)
        res = {}
        for block_m in (64, 128, 192):
            for block_k in (64, 128):
                out = A._out_like(q)
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), None, b, h, s, s, d, *A._strides(q),
                        *A._strides(k), *A._strides(v), *A._strides(out),
                        float(scale * A._LOG2E), block_m, block_k, st)
                if lib.rtt_attn_fwd(*args):
                    continue  # a pair the source does not build
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs().max().item() / o_max
                if err > OUT_RTOL:
                    raise AssertionError(f"{(b, h, s, d)} tile {block_m}x"
                                         f"{block_k}: {err:.3e} of max|ref|")
                res[f"{block_m}x{block_k}"] = round(_time_ms(
                    lambda: lib.rtt_attn_fwd(*args), 20, plug=True), 4)
        rule = "%dx%d" % A._fwd_tile(b, h, s, d)
        print(f"attn_fwd_kernel {(b, h, s, d)}: sdpa {sdpa:.4f} ms; rule "
              f"{rule} {res[rule]}; fastest {min(res, key=res.get)} "
              f"{min(res.values())}; all {json.dumps(res)}", flush=True)


def sweep_pavg() -> None:
    import torch

    from chip_smoke import PAVG_RTOL, _qkv, _time_ms
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.ops import build

    lib = build.library()
    st = torch.cuda.current_stream().cuda_stream
    for b, h, s, d in PAVG_SHAPES:
        q, k, v = _qkv(b, h, s, d, seed=s + d + b)
        scale = d ** -0.5
        _, lse = A.flash_attention_lse_plain(q, k, v, scale)
        want = A.avg_probs_from_lse_plain(q, k, lse, scale)
        res = {}
        for block_m in (64, 128) if d <= 80 else (64,):
            out = torch.empty((b, s, s), dtype=torch.float32, device="cuda")
            args = (q.data_ptr(), k.data_ptr(), lse.data_ptr(),
                    out.data_ptr(), b, h, s, s, d, *A._strides(q),
                    *A._strides(k), float(scale * A._LOG2E), block_m, st)
            if lib.rtt_attn_pavg(*args):
                raise AssertionError(f"{(b, h, s, d)}: {block_m} rows failed")
            torch.cuda.synchronize()
            err = ((out - want).abs().max() / want.abs().max()).item()
            if err > PAVG_RTOL:
                raise AssertionError(f"{(b, h, s, d)} {block_m} rows: "
                                     f"{err:.3e} of max|ref|")
            res[block_m] = round(_time_ms(lambda: lib.rtt_attn_pavg(*args),
                                          20, plug=True), 4)
        rule = A._pavg_tile(b, s, s, d)
        print(f"attn_pavg_kernel {(b, h, s, d)}: rule {rule} rows "
              f"{res[rule]}; fastest {min(res, key=res.get)} "
              f"{min(res.values())}; all {json.dumps(res)}", flush=True)


def sweep_conv(full: bool) -> None:
    import torch
    import torch.nn.functional as F

    from chip_smoke import (OUT_RTOL, SD15_CONV_SHAPES, _conv_inputs,
                            _time_ms)
    from rich_text_to_image_tpu_torch.ops import build
    from rich_text_to_image_tpu_torch.ops import conv as CV

    lib = build.library()
    st = torch.cuda.current_stream().cuda_stream
    cases = [(b, r, r, c, o) for b in (2, 4) for r, c, o in SD15_CONV_SHAPES]
    cases += [(3, 8, 24, 64, 192), (1, 9, 13, 640, 128),
              (1, 24, 24, 320, 320), (2, 16, 16, 640, 128)]
    if not full:
        cases = cases[::4]
    for b, hh, ww, c, o in cases:
        x, w, bias = _conv_inputs(b, hh, ww, c, o, seed=hh + c + o + b)
        want = CV.conv3x3_plain(x, w, bias)
        ref_max = want.float().abs().max().item()
        x_cf = x.permute(0, 3, 1, 2)
        w_cf = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib_ms = _time_ms(lambda: F.conv2d(x_cf, w_cf, bias, padding=1), 20,
                          plug=True)
        m, steps = b * hh * ww, 9 * c // 64
        res = {}
        for tile_n in [n for n in (160, 128, 64) if o % n == 0]:
            for tile_m in (128, 256):
                for splits in range(1, CV.MAX_SPLITS + 1):
                    if -(-steps // splits) * (splits - 1) >= steps:
                        continue  # a range would be empty
                    out = torch.empty((b, hh, ww, o), dtype=x.dtype,
                                      device=x.device)
                    ws = (torch.empty((splits, m, o), dtype=torch.float32,
                                      device=x.device) if splits > 1 else None)
                    args = (x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                            out.data_ptr(),
                            ws.data_ptr() if ws is not None else None,
                            splits, tile_m, tile_n, b, hh, ww, c, o, st)
                    if lib.rtt_conv3x3_fwd(*args):
                        continue  # a tile the source does not build
                    torch.cuda.synchronize()
                    err = ((out.float() - want.float()).abs().max().item()
                           / ref_max)
                    if err > OUT_RTOL:
                        raise AssertionError(
                            f"{(b, hh, ww, c, o)} tile {tile_m}x{tile_n}/"
                            f"{splits}: {err:.3e} of max|ref|")
                    res[f"{tile_m}x{tile_n}/{splits}"] = round(_time_ms(
                        lambda: lib.rtt_conv3x3_fwd(*args), 20, plug=True), 4)
        rule = "%dx%d/%d" % CV._plan(m, c, o)
        print(f"conv3x3_kernel {(b, hh, ww, c, o)}: conv2d {lib_ms:.4f} ms; "
              f"rule {rule} {res[rule]}; fastest {min(res, key=res.get)} "
              f"{min(res.values())}; all {json.dumps(res)}", flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("port_tile_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import _smi

    print("device: " + _smi(), flush=True)
    if argv[:1] == ["attention"]:
        sweep_attention()
    elif argv[:1] == ["pavg"]:
        sweep_pavg()
    elif argv[:1] == ["conv"]:
        sweep_conv("--full" in argv)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
