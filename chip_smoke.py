#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``). It exits non-zero, printing no result, when there
is no CUDA device or the port's package is not beside it. Phases, in order:

  1. the card's name and power limit (``nvidia-smi``);
  2. build: compiles the sources under ``rich_text_to_image_tpu_torch/csrc``
     with nvcc for sm_90a, one compiler per source, all at once;
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the shapes the paths below give it plus ragged and odd
     ones, with its time, the plain version's, the least time the card
     could take, and a library call's as a yardstick
     (``scaled_dot_product_attention``, ``F.conv2d``);
  4. UNet: one full-width SD-1.5 CFG forward (bfloat16, random weights, 64^2
     latent) with capture of the five 32^2 layers, through the kernels and
     again with the plain attention, compared;
  5. end to end: the port's CLI flow (plain pass, token maps, rich pass with
     a footnote, a coloured span and a font-size span) at 512^2 with 12
     PNDM steps, asserting that every kernel of the path was launched;
  6. convolution gate: the same UNet forward with the convolution kernel on
     against off, then a 4-step 512^2 sample with it on;
  7. 768^2: the CLI flow at 768x768, where the 96^2 level takes the
     streaming kernel and the 24^2 level runs at head dim 160;
  8. injection: the 512^2 flow with self-attention and background injection
     through the in-batch reference flow (rich batch R+4);
  9. breakdown: the per-call times of what the passes repeat (the UNet at
     batch 2 and R+2 = 4, one colour-guided step, the final decode);
 10. profile: one UNet forward at batch 2 and 4 under ``torch.profiler``,
     its device kernel count and the device's idle share.

``--kernels-only`` stops after phase 3. The line before the last lists the
kernels as JSON; the last line is ``{"ok": true, "device": {...}}``. Any
failure raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# published peaks of one H100 SXM (dense bf16 tensor rate, HBM3 bandwidth)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

OUT_RTOL = 2e-2  # bf16 output, relative to max|o_ref|: the plain version's
#                  own bf16 rounding (of p and of o) is ~0.4% of it against
#                  fp64; an unmasked ragged tail moves it by ~90% (_qkv)
PAVG_RTOL = 1e-3  # head-averaged probs, relative to their max
SCORE_STD = 2.0  # peaked rows, as in a trained UNet, not unit-normal's
SCORE_SHIFT = 10.0  # every real key's score lowered by this; see _qkv
UNET_RTOL = 5e-2  # full bf16 UNet, kernel vs plain attention, rel. to max|ref|

STEPS = 12  # > agg_start_step=10, or the cross sums stay zero
RICH_TEXT = json.dumps({"ops": [
    {"insert": "A close-up 4k dslr photo of a "},
    {"attributes": {"link": "A cat wearing sunglasses and a bandana around "
                            "its neck."}, "insert": "cat"},
    {"insert": " riding a "},
    {"attributes": {"color": "#ff0000"}, "insert": "scooter"},
    {"insert": ". There are "},
    {"attributes": {"size": "60px"}, "insert": "palm trees"},
    {"insert": " in the background."},
]})
REGIONS = 2  # R: the footnote span and the coloured span get region prompts

STEPS_768 = 11  # 12 UNet calls a pass; the cross sums start at step 10
STEPS_SHORT = 4  # the gate-on and injection samples: 5 UNet calls a pass

ATTN_SRC = "rich_text_to_image_tpu_torch/csrc/attention.cu"
KERNELS = {
    # name: (TPU kernel it replaces, source, main-path shape)
    "K1_attn_fwd_64x64": ("rich_text_to_image_tpu/ops/attention.py:47",
                          ATTN_SRC, (2, 8, 4096, 40)),
    "K2_attn_fwd_32x32": ("rich_text_to_image_tpu/ops/attention.py:83",
                          ATTN_SRC, (2, 8, 1024, 80)),
    "K3_attn_avgp_32x32": ("rich_text_to_image_tpu/ops/attention.py:181",
                           ATTN_SRC, (2, 8, 1024, 80)),
    "K4_attn_stream_96x96": (
        "rich_text_to_image_tpu/ops/attention.py:302",
        "rich_text_to_image_tpu_torch/csrc/attention_stream.cu",
        (2, 8, 9216, 40)),
    "K5_conv3x3": ("rich_text_to_image_tpu/ops/conv.py:50",
                   "rich_text_to_image_tpu_torch/csrc/conv.cu",
                   (2, 64, 64, 320, 320)),  # B, H, W, C, O
}

# every distinct (H = W, C, O) that a 3x3 stride-1 convolution of the SD-1.5
# UNet sees at a 64^2 latent: resnet conv1/conv2 and the upsamplers
SD15_CONV_SHAPES = [
    (64, 320, 320), (64, 960, 320), (64, 640, 320), (64, 640, 640),
    (32, 320, 640), (32, 640, 640), (32, 1920, 640), (32, 1280, 640),
    (32, 960, 640), (32, 1280, 1280),
    (16, 640, 1280), (16, 1280, 1280), (16, 2560, 1280), (16, 1920, 1280),
    (8, 1280, 1280), (8, 2560, 1280),
]


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _qkv(b, h, s, d, seed):
    """q, k, v as the UNet hands them over: [B,H,S,D] views of [B,S,H*D].

    The scores q.k*d^-0.5 have a spread of SCORE_STD, so each row attends
    to few keys and a wrong key moves the output by about its own size.
    The first channel lowers every real key's score by SCORE_SHIFT, which
    softmax does not see; but a kernel that forgot to mask the zero-filled
    keys past a ragged end would give them score 0, far above the real
    ones, and its output would collapse towards 0."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = [torch.randn((b, s, h * d), generator=g, device="cuda",
                           dtype=torch.bfloat16).view(b, s, h, d).transpose(1, 2)
               for _ in range(3)]
    q.mul_(SCORE_STD)
    q[..., 0] = 8.0
    k[..., 0] = -SCORE_SHIFT * d ** 0.5 / 8.0
    return q, k, v


def _bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _bound_ms(b, h, s, d, pavg: bool):
    return _bound(4 * b * h * s * s * d,
                  4 * b * h * s * d * 2 + (b * s * s * 4 if pavg else 0))


# (row of the kernels line, wrapper, B, H, S, d, expected launch bucket,
# keyword arguments). The batches are the paths' own: 2 in the plain pass
# (the only one that captures, so K3 sees no other), R+2 in the rich pass and
# R+4 in the rich pass with injection (512^2 only). Besides: ragged S, the
# 1280-channel level's head dim 160, a head dim that runs at a wider
# instantiation (64 at 80), and the streaming kernel with named blocks.
_RICH, _INJ = REGIONS + 2, REGIONS + 4
ATTN_CASES = [
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 4096, 40, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", _RICH, 8, 4096, 40, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", _INJ, 8, 4096, 40, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 4000, 40, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 576, 160, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", _RICH, 8, 576, 160, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 1024, 160, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 2304, 80, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", _RICH, 8, 2304, 80, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 1024, 64, "full", {}),
    ("K2_attn_fwd_32x32", "fwd", 2, 8, 1024, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", _RICH, 8, 1024, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", _INJ, 8, 1024, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", 2, 8, 1000, 80, "full_t", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 1024, 80, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 1000, 80, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 2304, 80, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 576, 160, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 1024, 160, "avgp", {}),
    ("K4_attn_stream_96x96", "fwd", 2, 8, 9216, 40, "stream", {}),
    ("K4_attn_stream_96x96", "fwd", _RICH, 8, 9216, 40, "stream", {}),
    ("K4_attn_stream_96x96", "fwd", 2, 8, 9000, 40, "stream", {}),
    ("K4_attn_stream_96x96", "fwd", 1, 2, 16384, 40, "stream", {}),
    ("K4_attn_stream_96x96", "fwd", 2, 8, 1024, 80, "stream",
     {"block_q": 128, "block_k": 128}),
    ("K4_attn_stream_96x96", "fwd", 2, 8, 1000, 160, "stream",
     {"block_q": 128, "block_k": 64}),
]


def attention_kernel_phase(cases=ATTN_CASES) -> dict:
    """Every attention kernel against its plain version; returns {kernel:
    row of the kernels line}, taken at the kernel's main-path shape."""
    import torch
    import torch.nn.functional as F

    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.ops import build

    rows = {}
    for name, kind, b, h, s, d, bucket, kw in cases:
        q, k, v = _qkv(b, h, s, d, seed=s + d + b)
        scale = d ** -0.5
        avgp = kind == "avgp"
        if avgp:
            kern = lambda: A.flash_attention_avg_probs(q, k, v, scale)
            plain = lambda: A.flash_attention_avg_probs_plain(q, k, v, scale)
        elif bucket == "stream":
            kern = lambda: A.flash_attention(q, k, v, scale, **kw)
            plain = lambda: A.flash_attention_stream_plain(
                q, k, v, scale, kw.get("block_k", 512))
        else:
            kern = lambda: A.flash_attention(q, k, v, scale)
            plain = lambda: A.flash_attention_plain(q, k, v, scale)
        A.reset_launches()
        got, want = kern(), plain()
        torch.cuda.synchronize()
        took = [n for n, c in A.LAUNCHES.items() if c]
        if took != [bucket]:
            raise AssertionError(f"{name} B={b} S={s} d={d} {kw}: launched "
                                 f"{took}, expected {bucket}")
        if avgp:
            (o, p), (o_ref, p_ref) = got, want
            p_err = ((p - p_ref).abs().max() / p_ref.abs().max()).item()
        else:
            (o, o_ref), p_err = (got, want), 0.0
        err = (o.float() - o_ref.float()).abs().max().item()
        o_max = o_ref.float().abs().max().item()
        ok = err <= OUT_RTOL * o_max and p_err <= PAVG_RTOL
        ms = _time_ms(kern, 20)
        plain_ms = _time_ms(plain, 3)
        sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 20)
        bound, bound_by = _bound_ms(b, h, s, d, avgp)
        line = (f"kernel {name} B={b} H={h} S={s} d={d} {kw or ''} -> "
                f"{bucket}: max|d out|={err:.3e} "
                f"= {err / o_max:.3e} of max|o_ref| {o_max:.3f} "
                f"(tol {OUT_RTOL} of it)"
                + (f" pavg rel={p_err:.3e} (tol {PAVG_RTOL})" if avgp else "")
                + f" ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f}"
                f" ({bound_by}) sdpa_ms={sdpa_ms:.4f}")
        print(line, flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{line}")
        if (b, h, s, d) == KERNELS[name][2] and not kw:
            rows[name] = {
                "name": name, "route": "cuda", "source": KERNELS[name][1],
                "replaces": KERNELS[name][0], "launches": None,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                # no single library call also returns the head-averaged
                # probabilities: SDPA computes only the output
                "library_ms": None if avgp else sdpa_ms,
                "shape": list(KERNELS[name][2]),
            }
    # the streaming kernel beside the full-row kernel at the same shape
    q, k, v = _qkv(2, 8, 9216, 40, seed=1)
    lib = build.library()
    out = A._out_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 2, 8,
            9216, 9216, 40, *A._strides(q), *A._strides(k), *A._strides(v),
            *A._strides(out), float(40 ** -0.5 * A._LOG2E))
    st = torch.cuda.current_stream().cuda_stream
    t = {"attn_fwd_kernel": _time_ms(lambda: lib.rtt_attn_fwd(*args, st), 20)}
    for tk in (64, 128):
        t[f"attn_stream_kernel tk={tk}"] = _time_ms(
            lambda: lib.rtt_attn_stream_fwd(*args, tk, st), 20)
    print("kernel K4 against K1's kernel at [2,8,9216,40], ms: "
          + json.dumps(t), flush=True)
    return rows


def _conv_inputs(b, hh, ww, c, o, seed):
    """x [B,H,W,C], w [3,3,C,O], bias [O] in bf16 for which a wrong border
    or a wrong tap shows: x has mean 1, and tap t's weights have mean
    a_t / C with a = (1,-2,3,-4,5,-6,7,-8,9), so tap t adds about a_t to
    every output it reaches. An interior output is near 5 plus the bias; an
    edge or corner output lacks three or five taps and differs by 2 to 12;
    swapped taps move the edges likewise."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, hh, ww, c), generator=g, device="cuda") * 0.5 + 1.0
    a = torch.tensor([1., -2., 3., -4., 5., -6., 7., -8., 9.], device="cuda")
    w = (torch.randn((9, c, o), generator=g, device="cuda") / (9 * c) ** 0.5
         + a[:, None, None] / c)
    bias = torch.randn((o,), generator=g, device="cuda")
    bf = torch.bfloat16
    return x.to(bf), w.view(3, 3, c, o).to(bf).contiguous(), bias.to(bf)


def conv_kernel_phase() -> tuple:
    """The convolution kernel against its plain version at every distinct
    shape of the SD-1.5 UNet at the plain pass's B=2 and the rich pass's
    B=R+2 (the split over K depends on the batch), and at two odd ones;
    returns (its row of the kernels line, {(H, C, O): (kernel ms, F.conv2d
    ms)} at B=2)."""
    import torch
    import torch.nn.functional as F

    from rich_text_to_image_tpu_torch.ops import conv as CV

    row, times = None, {}
    cases = [(b, r, r, c, o) for b in (2, REGIONS + 2)
             for r, c, o in SD15_CONV_SHAPES]
    cases.append((3, 8, 24, 64, 192))   # W != H, odd batch, one split
    cases.append((1, 9, 13, 640, 128))  # a ragged 117-pixel tile, 8 splits
    for b, hh, ww, c, o in cases:
        x, w, bias = _conv_inputs(b, hh, ww, c, o, seed=hh + c + o + b)
        CV.reset_launches()
        got = CV.conv3x3(x, w, bias)
        want = CV.conv3x3_plain(x, w, bias)
        torch.cuda.synchronize()
        if CV.LAUNCHES["conv3x3"] != 1:
            raise AssertionError("conv3x3 did not launch its kernel")
        err = (got.float() - want.float()).abs().max().item()
        ref_max = want.float().abs().max().item()
        # channels-first views of channels-last memory, as cuDNN likes them
        x_cf = x.permute(0, 3, 1, 2)
        w_cf = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = lambda: F.conv2d(x_cf, w_cf, bias, padding=1)
        lib_err = (lib().permute(0, 2, 3, 1).float()
                   - want.float()).abs().max().item()
        ms = _time_ms(lambda: CV.conv3x3(x, w, bias), 20)
        plain_ms = _time_ms(lambda: CV.conv3x3_plain(x, w, bias), 3)
        lib_ms = _time_ms(lib, 20)
        m = b * hh * ww
        bound, bound_by = _bound(2.0 * m * 9 * c * o,
                                 2.0 * (m * (c + o) + 9 * c * o + o))
        line = (f"kernel K5_conv3x3 B={b} H={hh} W={ww} C={c} O={o} "
                f"splits={CV.k_splits(b * hh * ww, c, o)}: "
                f"max|d out|={err:.3e} = {err / ref_max:.3e} of max|ref| "
                f"{ref_max:.3f} (tol {OUT_RTOL} of it; F.conv2d is at "
                f"{lib_err / ref_max:.3e}) ms={ms:.4f} plain_ms="
                f"{plain_ms:.4f} bound_ms={bound:.4f} ({bound_by}) "
                f"conv2d_ms={lib_ms:.4f}")
        print(line, flush=True)
        if not err <= OUT_RTOL * ref_max:
            raise AssertionError(f"K5_conv3x3 disagrees with its plain "
                                 f"version: {line}")
        if b == 2:
            times[(hh, c, o)] = (ms, lib_ms)
        if (b, hh, ww, c, o) == KERNELS["K5_conv3x3"][2]:
            row = {
                "name": "K5_conv3x3", "route": "cuda",
                "source": KERNELS["K5_conv3x3"][1],
                "replaces": KERNELS["K5_conv3x3"][0], "launches": None,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": lib_ms, "shape": [b, hh, ww, c, o],
            }
    # what the UNet pays around the kernel: the NCHW -> channels-last copy of
    # an activation that is not channels-last yet, and the weight repack
    # (made once per weight)
    x = torch.randn((2, 320, 64, 64), device="cuda", dtype=torch.bfloat16)
    wt = torch.randn((320, 320, 3, 3), device="cuda", dtype=torch.bfloat16)
    t = {"to_channels_last_ms [2,320,64,64]": _time_ms(
             lambda: x.permute(0, 2, 3, 1).contiguous(), 20),
         "pack_weight_ms [320,320,3,3]": _time_ms(
             lambda: CV.pack_weight(wt), 20)}
    print("kernel K5 layout costs: " + json.dumps(t), flush=True)
    return {"K5_conv3x3": row}, times


def unet_phase(pipe) -> None:
    """One full-width CFG forward with capture, kernels vs plain attention."""
    import torch

    from rich_text_to_image_tpu_torch.models.unet import CaptureSpec
    from rich_text_to_image_tpu_torch.ops import attention as A

    _, self_layers, cross_by_res = pipe._capture_layout((64, 64))
    spec = CaptureSpec(self_probs=frozenset(self_layers),
                       cross_probs=frozenset(
                           n for ns in cross_by_res.values() for n in ns))
    g = torch.Generator(device="cuda").manual_seed(1)
    lat = torch.randn((1, 64, 64, 4), generator=g, device="cuda")
    x = torch.cat([lat, lat])
    ctx = pipe.get_text_embeds(["a cat riding a scooter"], [""])
    with torch.no_grad():
        A.reset_launches()
        eps_k, aux_k = pipe.unet(x, 500, ctx, capture=spec)
        torch.cuda.synchronize()
        launched = dict(A.LAUNCHES)
        with A.plain_attention():
            eps_p, aux_p = pipe.unet(x, 500, ctx, capture=spec)
        torch.cuda.synchronize()
    if not (launched["full"] == 5 and launched["avgp"] == 5):
        raise AssertionError(f"UNet forward did not go through the kernels: "
                             f"{launched}")
    e_err = ((eps_k.float() - eps_p.float()).abs().max()
             / eps_p.float().abs().max()).item()
    p_err = max(((aux_k["self_probs"][n] - aux_p["self_probs"][n]).abs().max()
                 / aux_p["self_probs"][n].abs().max()).item()
                for n in self_layers)
    fin = bool(torch.isfinite(eps_k).all())
    print(f"unet: eps {tuple(eps_k.shape)} rel max|d|={e_err:.3e}, self_probs "
          f"rel max|d|={p_err:.3e} (tol {UNET_RTOL}), finite={fin}, "
          f"launches {launched}", flush=True)
    if not fin or e_err > UNET_RTOL or p_err > UNET_RTOL:
        raise AssertionError("UNet through the kernels disagrees with the "
                             "plain attention")


def sample_phase(tag: str, pipe, out_dir: str, size: int, steps: int,
                 extra=(), agg_start: int | None = None) -> tuple:
    """The port's CLI flow at size x size; returns (launch counts of the
    run, stage seconds, plain image, rich image, the share of the latent
    that the token maps gave to the span regions). ``agg_start`` moves the
    step from which the plain pass sums its cross-attention maps (10 by
    default), so that a run of fewer steps still has maps to segment."""
    import numpy as np

    from rich_text_to_image_tpu_torch.cli.sample import (check_args,
                                                         make_parser,
                                                         run_sample)
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.ops import conv as CV

    args = make_parser().parse_args(
        ["--run_dir", out_dir, "--sample_steps", str(steps), "--seed", "6",
         "--height", str(size), "--width", str(size),
         "--rich_text_json", RICH_TEXT, *extra])
    check_args(args)
    param = {"text_input": json.loads(RICH_TEXT), "height": size,
             "width": size, "guidance_weight": args.guidance_weight,
             "steps": steps, "noise_index": args.seed, "negative_prompt": ""}
    default_start = pipe.agg_start_step
    if agg_start is not None:
        pipe.agg_start_step = agg_start
    A.reset_launches()
    CV.reset_launches()
    try:
        plain_img, rich_img, seconds = run_sample(pipe, args, param,
                                                  save=True)
    finally:
        pipe.agg_start_step = default_start
    launches = {**A.LAUNCHES, **CV.LAUNCHES}
    for name, img in (("plain", plain_img), ("rich", rich_img)):
        f = img.astype(np.float64)
        if img.shape != (1, size, size, 3) or not np.isfinite(f).all() or (
                f.std() == 0):
            raise AssertionError(f"{tag}: {name} image is wrong: {img.shape}, "
                                 f"std {f.std()}")
    share = float(sum(m.sum() for m in pipe.masks[:-1])
                  / sum(m.sum() for m in pipe.masks))
    print(f"{tag}: {size}x{size}, {steps} steps, stage seconds "
          + json.dumps(seconds) + f", launches {launches}, span regions "
          f"hold {share:.3f} of the latent, images in {out_dir}", flush=True)
    return launches, seconds, plain_img, rich_img, share


def _expect(tag: str, launches: dict, want: dict) -> None:
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{tag}: launch counts {got}, expected {want} "
                             f"(all: {launches})")


def conv_phase(pipe, out_dir: str, times: dict) -> int:
    """The full-width UNet forward with the convolution kernel on against
    the same forward with it off, then a short 512^2 sample with it on;
    returns the sample's conv3x3 launches. ``times`` are the kernel phase's
    per-shape times, summed here over one forward's convolutions."""
    import torch

    from rich_text_to_image_tpu_torch.models.unet import Conv3x3
    from rich_text_to_image_tpu_torch.ops import conv as CV

    cfg = pipe.unet_cfg
    levels, per = len(cfg.block_out_channels), cfg.layers_per_block
    # two convolutions a resnet (per down level `per`, two in the middle,
    # per up level `per` + 1) and one per upsampler; conv_in (C = 4),
    # conv_out (O = 4) and the stride-2 downsamplers stay with F.conv2d
    per_forward = 2 * (per * levels + 2 + (per + 1) * levels) + levels - 1
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append(
            (inp[0].shape[2], mod.in_channels, mod.out_channels))
        if CV.conv3x3_supported(
            (1, *inp[0].shape[2:], mod.in_channels),
            (3, 3, mod.in_channels, mod.out_channels)) else None)
        for m in pipe.unet.modules() if isinstance(m, Conv3x3)]
    g = torch.Generator(device="cuda").manual_seed(4)
    lat = torch.randn((1, 64, 64, 4), generator=g, device="cuda")
    x = torch.cat([lat, lat])
    ctx = pipe.get_text_embeds(["a cat riding a scooter"], [""])
    try:
        with torch.no_grad():
            eps_off, _ = pipe.unet(x, 500, ctx)
            for hk in hooks:
                hk.remove()
            CV.enable_kernel_conv(True)
            CV.reset_launches()
            eps_on, _ = pipe.unet(x, 500, ctx)
            torch.cuda.synchronize()
            n = CV.LAUNCHES["conv3x3"]
            t_on = _time_ms(lambda: pipe.unet(x, 500, ctx), 5)
            CV.enable_kernel_conv(False)
            t_off = _time_ms(lambda: pipe.unet(x, 500, ctx), 5)
            CV.enable_kernel_conv(True)
        if set(seen) != set(SD15_CONV_SHAPES) or len(seen) != per_forward:
            raise AssertionError(
                "the UNet's convolution shapes are not the kernel phase's: "
                f"{sorted(set(seen) ^ set(SD15_CONV_SHAPES))}, {len(seen)}")
        print(f"conv: one forward's {len(seen)} convolutions at B=2, summed "
              f"from the kernel phase: kernel "
              f"{sum(times[k][0] for k in seen):.3f} ms, F.conv2d "
              f"{sum(times[k][1] for k in seen):.3f} ms", flush=True)
        err = ((eps_on.float() - eps_off.float()).abs().max()
               / eps_off.float().abs().max()).item()
        fin = bool(torch.isfinite(eps_on).all())
        print(f"conv: unet eps rel max|d|={err:.3e} gate on vs off (tol "
              f"{UNET_RTOL}), finite={fin}, conv3x3 launches {n} (expected "
              f"{per_forward}), unet B=2 ms on={t_on:.3f} off={t_off:.3f}",
              flush=True)
        if not fin or err > UNET_RTOL or n != per_forward:
            raise AssertionError("UNet through the convolution kernel is "
                                 "wrong")
        launches, _, _, _, _ = sample_phase("conv-e2e", pipe, out_dir, 512,
                                            STEPS_SHORT, agg_start=1)
    finally:
        CV.enable_kernel_conv(False)
    calls = pipe.scheduler.plan(STEPS_SHORT).num_steps
    _expect("conv-e2e", launches, {"conv3x3": 2 * calls * per_forward})
    return launches["conv3x3"]


def breakdown_phase(pipe) -> dict:
    """Per-call times, with CUDA events, of what the two passes repeat at
    512^2: the UNet forward at the plain (B=2) and rich (B=R+2) batch, one
    colour-guided step (fp32 VAE decode of the x0 prediction and its
    gradient) and the final decode."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(2)
    lat = torch.randn((1, 64, 64, 4), generator=g, device="cuda")
    noise = torch.randn((1, 64, 64, 4), generator=g, device="cuda")
    ctx = pipe.get_text_embeds(["a cat", "a scooter", "a palm"], [""])
    color = dict(
        masks_px=(torch.rand((1, 512, 512), generator=g, device="cuda")
                  > 0.5).float(),
        target_rgb=torch.tensor([[1.0, 0.0, 0.0]], device="cuda"),
        all=torch.ones((1, 64, 64, 1), device="cuda"), weight=0.5)
    out = {}
    with torch.no_grad():
        for b in (2, REGIONS + 2):
            x = torch.cat([lat] * b)
            out[f"unet_b{b}_ms"] = _time_ms(
                lambda: pipe.unet(x, 500, ctx[:b]), 5)
        out["decode_ms"] = _time_ms(lambda: pipe.decode_latents(lat), 3)
    out["guided_step_ms"] = _time_ms(
        lambda: pipe._guided(lat, noise, 0.5, color), 3)
    n = pipe.scheduler.plan(STEPS).num_steps
    print(f"breakdown: {json.dumps(out)}; with {n} UNet calls a pass, the "
          f"parts give plain_pass ~ {n * out['unet_b2_ms'] / 1e3:.3f} s + "
          f"decode, rich_pass ~ "
          f"{n * (out[f'unet_b{REGIONS + 2}_ms'] + out['guided_step_ms']) / 1e3:.3f}"
          " s + "
          "decode", flush=True)
    return out


def profile_phase(pipe, unet_ms: dict) -> None:
    """One UNet forward at B=2 and B=R+2 under ``torch.profiler``: the number
    of kernels it launches, their summed device time, and the device's idle
    share of the forward's un-profiled time from the breakdown phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(3)
    lat = torch.randn((1, 64, 64, 4), generator=g, device="cuda")
    ctx = pipe.get_text_embeds(["a cat", "a scooter", "a palm"], [""])
    for b in (2, REGIONS + 2):
        x = torch.cat([lat] * b)
        with torch.no_grad():
            pipe.unet(x, 500, ctx[:b])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                pipe.unet(x, 500, ctx[:b])
                torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy_us, end = 0.0, float("-inf")
        for s, e in spans:  # union of the kernels' intervals
            busy_us += max(0.0, e - max(s, end))
            end = max(end, e)
        wall = unet_ms[f"unet_b{b}_ms"]
        idle = (f"{1 - busy_us / 1e3 / wall:.3f}" if spans else "not measured")
        print(f"profile: unet B={b}: {len(spans)} device kernels, busy "
              f"{busy_us / 1e3:.3f} ms of {wall:.3f} ms un-profiled, idle "
              f"share {idle}", flush=True)


def main(kernels_only: bool = False) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "rich_text_to_image_tpu_torch")):
        print("chip_smoke: run it from the repository's root (the port's "
              "package is not beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    print("device: " + _smi(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from rich_text_to_image_tpu_torch.ops import build
    from rich_text_to_image_tpu_torch.pipelines.region_sd import RegionDiffusion

    t0 = time.time()
    build.library()
    print(f"build: {time.time() - t0:.1f} s (nvcc {build.build_seconds} s)",
          flush=True)
    print(build.ptxas_log.strip(), flush=True)

    rows = attention_kernel_phase()
    conv_row, conv_times = conv_kernel_phase()
    rows.update(conv_row)
    if kernels_only:
        print(_smi(), flush=True)
        return 0

    t0 = time.time()
    pipe = RegionDiffusion.random_init(seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: full-width SD-1.5 pipeline, random weights, "
          f"{time.time() - t0:.1f} s", flush=True)
    unet_phase(pipe)
    out = os.path.join(root, "results", "chip_smoke")

    # 512^2: per UNet call 5 launches at 64^2 and 5 at 32^2, the
    # latter through the capture kernel at the plain pass's last step
    calls = pipe.scheduler.plan(STEPS).num_steps
    launches, _, _, _, _ = sample_phase("e2e", pipe, out, 512, STEPS)
    _expect("e2e", launches, {"full": 2 * calls * 5, "avgp": 5,
                              "full_t": 2 * calls * 5 - 5, "stream": 0,
                              "conv3x3": 0})
    rows["K1_attn_fwd_64x64"]["launches"] = launches["full"]
    rows["K2_attn_fwd_32x32"]["launches"] = launches["full_t"]
    rows["K3_attn_avgp_32x32"]["launches"] = launches["avgp"]

    rows["K5_conv3x3"]["launches"] = conv_phase(
        pipe, os.path.join(out, "conv"), conv_times)

    # 768^2: 5 streaming launches a call at 96^2; at 48^2 (d = 80, S = 2304)
    # and 24^2 (d = 160, S = 576) the full-row bucket, the 48^2 ones through
    # the capture kernel at the plain pass's last step
    calls = pipe.scheduler.plan(STEPS_768).num_steps
    launches, _, _, _, _ = sample_phase("e2e-768", pipe,
                                     os.path.join(out, "768"), 768, STEPS_768)
    _expect("e2e-768", launches, {"stream": 2 * calls * 5, "avgp": 5,
                                  "full": 2 * calls * 10 - 5, "full_t": 0})
    rows["K4_attn_stream_96x96"]["launches"] = launches["stream"]

    # injection: the rich batch grows from R+2 to R+4 rows, the counts per
    # call stay, and the image must differ from the run without injection
    calls = pipe.scheduler.plan(STEPS_SHORT).num_steps
    _, _, _, rich_off, _ = sample_phase(
        "inject-off", pipe, os.path.join(out, "inject_off"), 512,
        STEPS_SHORT, agg_start=1)
    seen_batch = []
    hook = pipe.unet.register_forward_pre_hook(
        lambda mod, inp: seen_batch.append(inp[0].shape[0]))
    launches, _, _, rich_on, share = sample_phase(
        "inject", pipe, os.path.join(out, "inject"), 512, STEPS_SHORT,
        ["--inject_selfattn", "0.3", "--inject_background", "0.3",
         "--no_ref_precompute"], agg_start=1)
    hook.remove()
    _expect("inject", launches, {"full": 2 * calls * 5, "avgp": 5,
                                 "full_t": 2 * calls * 5 - 5})
    if seen_batch != [2] * calls + [REGIONS + 4] * calls:
        raise AssertionError(f"inject: UNet batches {seen_batch}, expected "
                             f"{calls} of 2 then {calls} of R+4 = "
                             f"{REGIONS + 4}")
    moved = float(np.abs(rich_on.astype(np.int32)
                         - rich_off.astype(np.int32)).mean())
    print(f"inject: rich batch R+4 = {REGIONS + 4} in {calls} calls; mean "
          f"|image "
          f"difference| against the run without injection {moved:.3f} of "
          "255", flush=True)
    if moved == 0.0 or share == 0.0:
        # the injected rows are the span rows: with empty span regions they
        # would not reach the image
        raise AssertionError("injection did not change the image")

    profile_phase(pipe, breakdown_phase(pipe))

    print(_smi(), flush=True)
    if any(r["launches"] in (None, 0) for r in rows.values()):
        raise AssertionError(f"a kernel was launched on no path: {rows}")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(kernels_only="--kernels-only" in sys.argv[1:]))
