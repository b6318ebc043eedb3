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
     (``scaled_dot_product_attention``, ``F.conv2d``); then the host time
     a launch of the attention and convolution wrappers;
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
  9. refer-precompute: the same request through the CLI's default flow
     (the plain pass keeps the refer cache, the rich batch is R+2), its
     image against the in-batch one;
 10. schedulers: the 512^2 flow under DDIM and DPM-Solver++, and the plain
     pass under Euler (whose rich pass the CLI refuses);
 11. turbo: the 512^2 flow with encoder reuse 2, guidance at half size and
     the bfloat16 guidance decode, against the exact run;
 12. the evaluation paths at 512^2, 4 PNDM steps: ``batch:``
     (``text_to_images``, 4 prompts, 8 rows a forward, also with encoder
     reuse), ``colorbench:`` (``evaluation.benchmark_color.run`` with 4
     colours batched, 14 then 12 rows a forward, against the same colours
     one at a time), ``stylebench:`` (``benchmark_style.run``, 6 style
     pairs batched at 24 rows, against one at a time; random CLIP
     scorer), ``p2p:`` (prompt-to-prompt, 3 and 1 rows a step; refine,
     then LocalBlend) and ``colorbench-p2p:`` (the colour suite's
     prompt-to-prompt baseline), each asserting its UNet batches and its
     launches;
 13. breakdown: the per-call times of what the passes repeat (the UNet at
     batch 2 and R+2 = 4, one colour-guided step exact, pooled by 2 and in
     bfloat16, the final decode);
 14. profile: one UNet forward at batch 2 and 4 under ``torch.profiler``,
     its device kernel count and the device's idle share;
 15. SDXL: a full-width SDXL pipeline (random weights drawn on the card);
     one CFG forward at a 128^2 latent through the kernels (head dim 64)
     against the plain attention, with the capture of the 60 32^2 layers
     summed; the CLI flow with ``--model SDXL`` at 1024^2 under Euler
     (plain pass, token maps, rich pass with colour guidance), asserting
     its exact launches, the rich batch, the watermark and the peak device
     memory; the same request with injection through the refer cache; the
     per-call times and the profile of the SDXL forward.

``--kernels-only`` stops after phase 3. The line before the last lists the
kernels as JSON; the last line is ``{"ok": true, "device": {...}}``. Any
failure raises.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

# published peaks of one H100 SXM (dense bf16 tensor rate, HBM3 bandwidth);
# the special-function units give 16 exp2 a clock on each of 132 SMs
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SMS = 132
EXP2_PER_CLOCK_PER_SM = 16

OUT_RTOL = 2e-2  # bf16 output, relative to max|o_ref|: the plain version's
#                  own bf16 rounding (of p and of o) is ~0.4% of it against
#                  fp64; an unmasked ragged tail moves it by ~90% (_qkv)
PAVG_RTOL = 1e-3  # head-averaged probs, relative to their max
LSE_ATOL = 1e-3  # the capture's log2-sum-exp, log2 units (0.07% in p): both
#                  sides sum fp32 exponentials of the same fp32 scores
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
STEPS_SHORT = 4  # the gate-on, injection, scheduler and turbo samples
# the refer-precompute flow's image against the in-batch flow's, mean |image
# difference| in uint8 steps: 1.64 measured on the H100 (bf16 at batches 2
# and R+2 against R+4; about what the injection itself moves the image at
# 4 steps, 1.65), held with room for the card's run-to-run spread
REFPRE_MAX_DIFF = 4.0

# the inject:, refpre: and inject-nobg: paths take fixed region masks, so
# that the background holds a share of the latent (with random weights the
# token maps give it all to the spans): the footnote span the left third,
# the coloured span the middle one, the background the right one
FIXED_MASK_THIRDS = 3

# the evaluation paths' batched images against the same items run one at a
# time, mean |image difference| in uint8 steps: bf16 products at batches 14
# and 12 (colour) or 24 (style) against 5 or 4 rows, as REFPRE_MAX_DIFF
# holds batches R+2 against R+4; the max is printed beside it
EVAL_MAX_DIFF = 4.0
EVAL_PROMPTS = ["a cat wearing sunglasses", "a red scooter on a street",
                "palm trees on a beach", "a bowl of fruit on a table"]
# the UNet batches the evaluation paths give attn_fwd_kernel: 2N in
# text_to_images (N = 4), 2+3K then 3K in the colour bench (K = 4 colours;
# R+4 = 5 when it runs one colour at a time), K(R+2) in the style bench
# (K = 6 pairs, R = 2), 3 and 1 in prompt-to-prompt
EVAL_BATCHES = (8, 14, 12, 24, 5, 3, 1)

SDXL_SIZE = 1024  # the SDXL CLI's default, a 128^2 latent
# the SDXL attn1 layers at 1024^2 (models/config.py SDXL_UNET): 10 at the
# 64^2 level, 60 at 32^2 (the segmentation level, all captured)
SDXL_SELF_64, SDXL_SELF_32 = 10, 60

ATTN_SRC = "rich_text_to_image_tpu_torch/csrc/attention.cu"
KERNELS = {
    # name: (TPU kernel it replaces, source, main-path shape)
    "K1_attn_fwd_64x64": ("rich_text_to_image_tpu/ops/attention.py:47",
                          ATTN_SRC, (2, 8, 4096, 40)),
    "K2_attn_fwd_32x32": ("rich_text_to_image_tpu/ops/attention.py:83",
                          ATTN_SRC, (2, 8, 1024, 80)),
    "K3_attn_avgp_32x32": ("rich_text_to_image_tpu/ops/attention.py:181",
                           ATTN_SRC, (2, 8, 1024, 80)),
    "K4_attn_stream_96x96": ("rich_text_to_image_tpu/ops/attention.py:302",
                             ATTN_SRC, (2, 8, 9216, 40)),
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


def _max_sm_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def _host_us(fn, launches: int = 300) -> float:
    """Host microseconds a call of ``fn``, which launches without waiting:
    the host clock over ``launches`` calls with no synchronisation inside
    (the queue of launches is drained before and after, and 300 launches
    do not fill it: a full queue would make the host wait for the card)."""
    import torch

    for _ in range(10):
        fn()
    reps = []
    for _ in range(3):  # the median of three: the host is shared
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        reps.append((time.perf_counter() - t0) / launches * 1e6)
    torch.cuda.synchronize()
    return sorted(reps)[1]


_PLUG = []


def _plug() -> None:
    """Keeps the card busy for ~3 ms (two 8192^2 bf16 matrix products), so
    that launches queued behind it run back to back: the events around them
    then read device time, not the host's time to launch."""
    import torch

    if not _PLUG:
        _PLUG.append(torch.randn((8192, 8192), device="cuda",
                                 dtype=torch.bfloat16))
    for _ in range(2):
        torch.mm(_PLUG[0], _PLUG[0])


def _time_ms(fn, iters: int, plug: bool = False) -> float:
    """Milliseconds a call of ``fn`` between two CUDA events over ``iters``
    calls. With ``plug`` the calls are queued while the card is busy, which
    leaves the host's launch time out: for a kernel shorter than its
    wrapper's host time (~30 us) the plain reading is the host's."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if plug:
        _plug()
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


def _bound(flops: float, nbytes: float, exp2s: float = 0.0,
           sm_hz: float = 1.0):
    """(least ms, what sets it): the largest of the tensor-core operations
    at their peak rate, the bytes at the memory's rate, and the exponentials
    at the special-function units' rate (operations too, of another unit)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    t_exp = exp2s / (EXP2_PER_CLOCK_PER_SM * SMS * sm_hz)
    t = max(t_ops, t_bytes, t_exp)
    return t * 1e3, ("bytes" if t == t_bytes else "operations"), (
        "exp2" if t == t_exp else "bytes" if t == t_bytes else "tensor")


def _bound_ms(b, h, s, d, pavg: bool, sm_hz: float):
    """Attention: 4*S*S*d tensor operations, q, k, v read and o written
    once (plus the head average), and one exp2 a score, a (batch, head)."""
    return _bound(4 * b * h * s * s * d,
                  4 * b * h * s * d * 2 + (b * s * s * 4 if pavg else 0),
                  b * h * s * s, sm_hz)


# (row of the kernels line, wrapper, B, H, S, d, expected launch bucket,
# keyword arguments). The batches are the paths' own: 2 in the plain pass
# (the only one that captures, so K3 sees no other), R+2 in the rich pass and
# R+4 in the rich pass with injection (512^2 only). Besides: ragged S, the
# 1280-channel level's head dim 160, a head dim that runs at a wider
# instantiation (56 at 64), the streaming bucket at the 128^2 level of a
# 1024^2 sample and with named blocks, and for attn_fwd_kernel's tiles of
# 64, 128 and 192 rows: S that is no multiple of the tile, and batch 1
# shapes small enough for the 64-row tile. SDXL at 1024^2 (head dim 64 at
# every level: 10 heads at 64^2, 20 at 32^2) adds its plain pass's batch 2,
# its rich pass's R+2 and a ragged S.
_RICH, _INJ = REGIONS + 2, REGIONS + 4
ATTN_CASES = [
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 4096, 40, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", _RICH, 8, 4096, 40, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", _INJ, 8, 4096, 40, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 4000, 40, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 576, 160, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", _RICH, 8, 576, 160, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 520, 160, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 1, 8, 1000, 40, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 1024, 160, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 2304, 80, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", _RICH, 8, 2304, 80, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 1024, 64, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 8, 1024, 56, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 10, 4096, 64, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", _RICH, 10, 4096, 64, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 20, 1024, 64, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", _RICH, 20, 1024, 64, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 20, 1000, 64, "full", {}),
    ("K2_attn_fwd_32x32", "fwd", 2, 8, 1024, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", _RICH, 8, 1024, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", _INJ, 8, 1024, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", 2, 8, 1000, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", _RICH, 8, 1000, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", 1, 8, 520, 80, "full_t", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 1024, 80, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 1000, 80, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 2304, 80, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 576, 160, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 1024, 160, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 20, 1024, 64, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 20, 1000, 64, "avgp", {}),
] + [
    (name, "fwd", b, 8, s, d, bucket, {})
    for b in EVAL_BATCHES
    for name, s, d, bucket in (("K1_attn_fwd_64x64", 4096, 40, "full"),
                               ("K2_attn_fwd_32x32", 1024, 80, "full_t"))
] + [
    ("K4_attn_stream_96x96", "fwd", 2, 8, 9216, 40, "stream", {}),
    ("K4_attn_stream_96x96", "fwd", _RICH, 8, 9216, 40, "stream", {}),
    ("K4_attn_stream_96x96", "fwd", 2, 8, 9000, 40, "stream", {}),
    ("K4_attn_stream_96x96", "fwd", 2, 8, 16384, 40, "stream", {}),
    ("K4_attn_stream_96x96", "fwd", 1, 2, 16384, 40, "stream", {}),
    ("K4_attn_stream_96x96", "fwd", 2, 8, 1024, 80, "stream",
     {"block_q": 128, "block_k": 128}),
    ("K4_attn_stream_96x96", "fwd", 2, 8, 1000, 160, "stream",
     {"block_q": 128, "block_k": 64}),
]


def _capture_pieces(q, k, v, scale, line: str) -> str:
    """The capture's two launches, each against its plain version on the
    same inputs: ``flash_attention_lse`` (output and log2-sum-exp), and
    ``avg_probs_from_lse`` given the plain version's log2-sum-exp. Returns
    what to add to the case's line; raises on a disagreement."""
    import torch

    from rich_text_to_image_tpu_torch.ops import attention as A

    (o, lse), (o_ref, lse_ref) = (A.flash_attention_lse(q, k, v, scale),
                                  A.flash_attention_lse_plain(q, k, v, scale))
    p = A.avg_probs_from_lse(q, k, lse_ref, scale)
    p_ref = A.avg_probs_from_lse_plain(q, k, lse_ref, scale)
    torch.cuda.synchronize()
    o_err = ((o.float() - o_ref.float()).abs().max()
             / o_ref.float().abs().max()).item()
    lse_err = (lse - lse_ref).abs().max().item()
    p_err = ((p - p_ref).abs().max() / p_ref.abs().max()).item()
    ms_lse = _time_ms(lambda: A.flash_attention_lse(q, k, v, scale), 20,
                      plug=True)
    ms_p = _time_ms(lambda: A.avg_probs_from_lse(q, k, lse, scale), 20,
                    plug=True)
    add = (f"; pieces: lse out rel={o_err:.3e} lse max|d|={lse_err:.3e} "
           f"(tol {LSE_ATOL} log2 units) ms={ms_lse:.4f}, pavg from lse "
           f"rel={p_err:.3e} ms={ms_p:.4f} rows/CTA="
           f"{A._pavg_tile(q.shape[0], q.shape[2], k.shape[2], q.shape[3])}")
    if not (o_err <= OUT_RTOL and lse_err <= LSE_ATOL
            and p_err <= PAVG_RTOL):
        raise AssertionError(f"a piece of the capture disagrees with its "
                             f"plain version: {line}{add}")
    return add


def attention_kernel_phase(cases=ATTN_CASES) -> dict:
    """Every attention kernel against its plain version; returns {kernel:
    row of the kernels line}, taken at the kernel's main-path shape."""
    import torch
    import torch.nn.functional as F

    from rich_text_to_image_tpu_torch.ops import attention as A

    rows, k4_tiles, sdxl, evals = {}, {}, {}, {}
    sm_hz = _max_sm_hz()
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
        ms = _time_ms(kern, 20, plug=True)
        plain_ms = _time_ms(plain, 3, plug=True)
        sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 20, plug=True)
        bound, bound_by, unit = _bound_ms(b, h, s, d, avgp, sm_hz)
        tile = A._fwd_tile(b, h, s, d, A._stream_tile(kw.get(
            "block_k", 512)) if bucket == "stream" else 128)
        if bucket == "stream" and not kw:
            k4_tiles[f"[{b},{h},{s},{d}]"] = tile
        line = (f"kernel {name} B={b} H={h} S={s} d={d} {kw or ''} -> "
                f"{bucket} tile={tile}: max|d out|={err:.3e} "
                f"= {err / o_max:.3e} of max|o_ref| {o_max:.3f} "
                f"(tol {OUT_RTOL} of it)"
                + (f" pavg rel={p_err:.3e} (tol {PAVG_RTOL})" if avgp else "")
                + f" ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f}"
                f" ({bound_by}: {unit} at {sm_hz / 1e6:.0f} MHz) "
                f"sdpa_ms={sdpa_ms:.4f}")
        if avgp and ok:
            line += _capture_pieces(q, k, v, scale, line)
        print(line, flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{line}")
        entry = {"shape": [b, h, s, d], "launches": None, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": bound_by,
                 "library_ms": None if avgp else sdpa_ms}
        if d == 64 and not kw and (h, s) in ((10, 4096), (20, 1024)):
            sdxl.setdefault(name, []).append(entry)
        if b in EVAL_BATCHES and (h, s, d) in ((8, 4096, 40), (8, 1024, 80)):
            evals.setdefault(name, []).append(entry)
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
    print("kernel K4 tiles (query rows a CTA, keys a tile) picked by "
          "ops/attention._fwd_tile: " + json.dumps(k4_tiles), flush=True)
    for name, entries in sdxl.items():
        rows[name]["sdxl_d64"] = entries
    for name, entries in evals.items():
        rows[name]["eval_batches"] = entries
    _capture_accumulated(SDXL_SELF_32)
    q, k, v = _qkv(2, 8, 4096, 40, seed=2)
    print("kernel K1 wrapper host us a launch at [2,8,4096,40]: "
          f"{_host_us(lambda: A.flash_attention(q, k, v, 40 ** -0.5)):.2f}",
          flush=True)
    return rows


def _capture_accumulated(layers: int) -> None:
    """The SDXL plain pass sums the capture's head average over its 60
    32^2 layers (and over the steps): ``layers`` launches at [2,20,1024,64]
    on inputs of their own, summed, against the sum of the plain
    versions, within PAVG_RTOL of its max."""
    import torch

    from rich_text_to_image_tpu_torch.ops import attention as A

    got = want = None
    for i in range(layers):
        q, k, v = _qkv(2, 20, 1024, 64, seed=1000 + i)
        p = A.flash_attention_avg_probs(q, k, v, 0.125)[1]
        p_ref = A.flash_attention_avg_probs_plain(q, k, v, 0.125)[1]
        got = p if got is None else got + p
        want = p_ref if want is None else want + p_ref
    torch.cuda.synchronize()
    err = ((got - want).abs().max() / want.abs().max()).item()
    print(f"kernel K3_attn_avgp_32x32 summed over {layers} launches at "
          f"[2,20,1024,64] (the SDXL capture of one step): rel max|d|="
          f"{err:.3e} (tol {PAVG_RTOL})", flush=True)
    if not err <= PAVG_RTOL:
        raise AssertionError("the summed capture disagrees with the plain "
                             "versions' sum")


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
    cases.append((3, 8, 24, 64, 192))   # W != H, odd batch, the 64-wide tile
    cases.append((1, 9, 13, 640, 128))  # a ragged 117-pixel tile, 128 wide
    cases.append((1, 24, 24, 320, 320))   # M = 576: a ragged last M tile
    cases.append((2, 16, 16, 640, 128))   # O takes the 128-wide tile
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
        ms = _time_ms(lambda: CV.conv3x3(x, w, bias), 20, plug=True)
        plain_ms = _time_ms(lambda: CV.conv3x3_plain(x, w, bias), 3,
                            plug=True)
        lib_ms = _time_ms(lib, 20, plug=True)
        m = b * hh * ww
        bound, bound_by, _ = _bound(2.0 * m * 9 * c * o,
                                    2.0 * (m * (c + o) + 9 * c * o + o))
        line = (f"kernel K5_conv3x3 B={b} H={hh} W={ww} C={c} O={o} "
                f"tile={CV.conv_tile(m, c, o)} "
                f"splits={CV.k_splits(m, c, o)}: "
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
    x, w, bias = _conv_inputs(2, 64, 64, 320, 320, seed=5)
    print("kernel K5 wrapper host us a launch at [2,64,64,320]->320: "
          f"{_host_us(lambda: CV.conv3x3(x, w, bias)):.2f}", flush=True)
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


@contextlib.contextmanager
def _agg_start(pipe, step: int):
    """While open, the plain pass sums its cross maps from ``step`` on (a
    4-step run would have none from the default step 10)."""
    default, pipe.agg_start_step = pipe.agg_start_step, step
    try:
        yield
    finally:
        pipe.agg_start_step = default


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
    A.reset_launches()
    CV.reset_launches()
    with _agg_start(pipe, pipe.agg_start_step if agg_start is None
                    else agg_start):
        plain_img, rich_img, seconds = run_sample(pipe, args, param,
                                                  save=True)
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
    colour-guided step (VAE decode of the x0 prediction and its gradient:
    exact in fp32, with the latent and masks pooled by 2, in bf16, and
    both) and the final decode."""
    import numpy as np
    import torch

    g = torch.Generator(device="cuda").manual_seed(2)
    lat = torch.randn((1, 64, 64, 4), generator=g, device="cuda")
    noise = torch.randn((1, 64, 64, 4), generator=g, device="cuda")
    ctx = pipe.get_text_embeds(["a cat", "a scooter", "a palm"], [""])
    fmt = {"color_obj_atten": [(np.random.default_rng(2).random(
               (512, 512)) > 0.5).astype(np.float32)],
           "target_RGB": [[1.0, 0.0, 0.0]],
           "color_obj_atten_all": np.ones((64, 64), np.float32)}
    out = {}
    with torch.no_grad():
        for b in (2, REGIONS + 2):
            x = torch.cat([lat] * b)
            out[f"unet_b{b}_ms"] = _time_ms(
                lambda: pipe.unet(x, 500, ctx[:b]), 5)
        out["decode_ms"] = _time_ms(lambda: pipe.decode_latents(lat), 3)
    for tag, ds, bf16 in (("", 1, False), ("_gds2", 2, False),
                          ("_bf16", 1, True), ("_gds2_bf16", 2, True)):
        color = pipe._color_inputs(fmt, 512, 512, 64, 64, ds, bf16, 0.5)
        out[f"guided_step{tag}_ms"] = _time_ms(
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


def _image_diff(a, b) -> float:
    """Mean |a - b| of two uint8 images, in uint8 steps."""
    import numpy as np

    return float(np.abs(a.astype(np.int32) - b.astype(np.int32)).mean())


def _batches(pipe, fn):
    """(what ``fn`` returns, the UNet batch of each forward it ran)."""
    seen = []
    hook = pipe.unet.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].shape[0]))
    try:
        return fn(), seen
    finally:
        hook.remove()


@contextlib.contextmanager
def _fixed_masks(pipe):
    """While open, the rich pass of ``pipe`` takes fixed region masks in
    place of the token maps': equal vertical bands, one a region prompt
    (the spans, then the base prompt's, which is the background, on the
    right)."""
    import numpy as np

    orig = pipe.prompt_to_img

    def run(prompts, *a, height, width, **kw):
        f = pipe.vae_scale_factor
        h, w, n = height // f, width // f, len(prompts)
        masks = np.zeros((n, 1, h, w), np.float32)
        edges = np.linspace(0, w, n + 1).astype(int)
        for i in range(n):
            masks[i, :, :, edges[i]:edges[i + 1]] = 1.0
        pipe.masks = list(masks)
        return orig(prompts, *a, height=height, width=width, **kw)

    pipe.prompt_to_img = run
    try:
        yield
    finally:
        del pipe.prompt_to_img


def _background_diff(a, b, n_regions: int) -> float:
    """Mean |a - b| over the background band of ``_fixed_masks`` (the last
    of ``n_regions`` vertical bands), in uint8 steps."""
    return _band_diffs(a, b, n_regions)[0]


def _band_diffs(a, b, n_regions: int) -> tuple:
    """Mean |a - b| over the background band of ``_fixed_masks`` and over
    the span bands left of it, in uint8 steps."""
    w = a.shape[2]
    x0 = w - w // n_regions
    return (_image_diff(a[:, :, x0:], b[:, :, x0:]),
            _image_diff(a[:, :, :x0], b[:, :, :x0]))


def refpre_phase(pipe, out_dir: str, in_batch_img, no_inject_img) -> None:
    """The injection request of the ``inject:`` phase through the CLI's
    default flow: the plain pass keeps the refer cache, the rich pass runs
    R+2 rows a step and injects from it. Fails if the rich pass fell back
    to the in-batch flow (R+4 rows), if a launch count differs from the
    in-batch flow's, if the image is further than ``REFPRE_MAX_DIFF`` from
    the in-batch one (same seed and text), or if it equals the image of the
    run without injection (the same R+2 rows but for the injection), or
    if its background band equals that of ``refpre-nobg``, the same flow
    with ``--inject_selfattn 0.3`` alone (the refer latent composited
    under the fixed background mask is all that differs)."""
    calls = pipe.scheduler.plan(STEPS_SHORT).num_steps
    with _fixed_masks(pipe):
        _, _, _, no_bg_img, _ = sample_phase(
            "refpre-nobg", pipe, os.path.join(out_dir, "nobg"), 512,
            STEPS_SHORT, ["--inject_selfattn", "0.3"], agg_start=1)
        (launches, _, _, rich, _), seen = _batches(pipe, lambda: sample_phase(
            "refpre", pipe, out_dir, 512, STEPS_SHORT,
            ["--inject_selfattn", "0.3", "--inject_background", "0.3"],
            agg_start=1))
    _expect("refpre", launches, {"full": 2 * calls * 5, "avgp": 5,
                                 "full_t": 2 * calls * 5 - 5})
    if seen != [2] * calls + [REGIONS + 2] * calls:
        raise AssertionError(f"refpre: UNet batches {seen}, expected "
                             f"{calls} of 2 then {calls} of R+2 = "
                             f"{REGIONS + 2} (no fallback to the in-batch "
                             "flow)")
    cache = pipe.ref_cache
    if cache is None:
        raise AssertionError("refpre: the plain pass kept no refer cache")
    tensors = [cache["traj"], *cache["resnet"].values(),
               *(t for qk in cache["qk"].values() for t in qk)]
    total = sum(t.numel() * t.element_size() for t in tensors)
    diff = _image_diff(rich, in_batch_img)
    moved = _image_diff(rich, no_inject_img)
    bg_moved, span_moved = _band_diffs(rich, no_bg_img, REGIONS + 1)
    print(f"refpre: rich batch R+2 = {REGIONS + 2} in {calls} calls; refer "
          f"cache {len(cache['steps'])} slots (steps {list(cache['steps'])})"
          f", {pipe._ref_qk_bytes_per_slot((64, 64))} bytes a slot, "
          f"{total} bytes in all with the trajectory; mean |image "
          f"difference| against the in-batch flow {diff:.4f} of 255 (bound "
          f"{REFPRE_MAX_DIFF}), against the run without injection "
          f"{moved:.4f}; against refpre-nobg (the same flow without "
          f"background injection) in the background band {bg_moved:.4f}, in "
          f"the span bands {span_moved:.4f}", flush=True)
    if diff > REFPRE_MAX_DIFF:
        raise AssertionError("refpre: the image is too far from the "
                             "in-batch flow's")
    if moved == 0.0:
        raise AssertionError("refpre: the injection did not change the "
                             "image")
    if bg_moved == 0.0:
        raise AssertionError("refpre: the background injection did not "
                             "change the background")


def scheduler_phases(pipe, out_dir: str, pndm_imgs) -> None:
    """The 512^2 flow under DDIM and DPM-Solver++ (one UNet call a step, PNDM
    one more), images against PNDM's of the same seed and text; then the
    plain pass under Euler, whose rich pass the CLI refuses."""
    import numpy as np

    from rich_text_to_image_tpu_torch.cli.sample import (check_args,
                                                         make_parser,
                                                         make_scheduler)
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.utils import richtext

    default = pipe.scheduler
    try:
        for name in ("ddim", "dpm"):
            pipe.scheduler = make_scheduler(name)
            calls = pipe.scheduler.plan(STEPS_SHORT).num_steps
            if calls != STEPS_SHORT:
                raise AssertionError(f"sched-{name}: {calls} UNet calls a "
                                     f"pass for {STEPS_SHORT} steps")
            launches, _, plain, rich, _ = sample_phase(
                f"sched-{name}", pipe, os.path.join(out_dir, name), 512,
                STEPS_SHORT, ["--scheduler", name], agg_start=1)
            _expect(f"sched-{name}", launches, {
                "full": 2 * calls * 5, "avgp": 5,
                "full_t": 2 * calls * 5 - 5})
            d = [_image_diff(a, b) for a, b in zip((plain, rich), pndm_imgs)]
            print(f"sched-{name}: {calls} UNet calls a pass (PNDM "
                  f"{STEPS_SHORT + 1}); mean |image difference| against "
                  f"PNDM's: plain {d[0]:.3f}, rich {d[1]:.3f} of 255",
                  flush=True)
            if min(d) == 0.0:
                raise AssertionError(f"sched-{name}: the image is PNDM's")
        pipe.scheduler = make_scheduler("euler")
        calls = pipe.scheduler.plan(STEPS_SHORT).num_steps
        A.reset_launches()
        base = richtext.parse_json(json.loads(RICH_TEXT)).base_text_prompt
        img, _ = pipe.produce_attn_maps(
            [base], [""], height=512, width=512,
            num_inference_steps=STEPS_SHORT, guidance_scale=8.5, seed=6)
        launches = dict(A.LAUNCHES)
    finally:
        pipe.scheduler = default
    _expect("sched-euler", launches, {"full": calls * 5, "avgp": 5,
                                      "full_t": calls * 5 - 5})
    f = img.astype(np.float64)
    if img.shape != (1, 512, 512, 3) or not np.isfinite(f).all() or (
            f.std() == 0):
        raise AssertionError(f"sched-euler: the image is wrong: {img.shape}")
    try:
        check_args(make_parser().parse_args(["--scheduler", "euler"]))
    except SystemExit as e:
        refusal = str(e)
    else:
        raise AssertionError("sched-euler: check_args took --scheduler euler")
    print(f"sched-euler: plain pass, {calls} UNet calls, image mean "
          f"{f.mean():.3f} std {f.std():.3f} of 255, launches {launches}; "
          f"the CLI refuses the rich pass: {refusal[:60]}...", flush=True)


def turbo_phase(pipe, out_dir: str, exact_img) -> None:
    """The 512^2 flow with ``--encoder_reuse 2 --guidance_downsample 2
    --bf16_guidance``: on the rich pass's non-key steps the two down-block
    self-attention layers at 64^2 and at 32^2 do not run (3 launches of
    each instead of 5). The image against the exact run's."""
    from rich_text_to_image_tpu_torch.pipelines.base import encoder_key_gates

    calls = pipe.scheduler.plan(STEPS_SHORT).num_steps
    keys = int(encoder_key_gates(calls, 2, "early").sum())
    launches, _, _, rich, _ = sample_phase(
        "turbo", pipe, out_dir, 512, STEPS_SHORT,
        ["--encoder_reuse", "2", "--guidance_downsample", "2",
         "--bf16_guidance"], agg_start=1)
    rich_calls = 5 * keys + 3 * (calls - keys)
    _expect("turbo", launches, {"full": 5 * calls + rich_calls, "avgp": 5,
                                "full_t": 5 * calls - 5 + rich_calls})
    print(f"turbo: {keys} key steps of {calls}; rich pass K1/K2 launches "
          f"{rich_calls} each (exact {5 * calls}); mean |image difference| "
          f"against the exact run {_image_diff(rich, exact_img):.3f} of 255",
          flush=True)


def _count_eval(acc: dict) -> dict:
    """Adds the attention launches since the last reset to ``acc`` (the
    evaluation phases' totals); returns this run's by shape."""
    from rich_text_to_image_tpu_torch.ops import attention as A

    for k in ("full", "full_t", "avgp", "stream"):
        acc[k] = acc.get(k, 0) + A.LAUNCHES[k]
    for k, n in A.LAUNCHES_BY_SHAPE.items():
        acc["by_shape"][k] = acc["by_shape"].get(k, 0) + n
    return dict(A.LAUNCHES_BY_SHAPE)


def _expect_by_shape(tag: str, got: dict, seen: list, captures: int = 0):
    """The SD-1.5 512^2 launches of the UNet forwards of batches ``seen``:
    5 K1 at 64^2 and 5 K2 at 32^2 each, but for ``captures`` plain-pass
    capture steps at batch 2, whose 5 32^2 layers take K3."""
    want: dict = {}
    for b in seen:
        for key in (("full", b, 8, 4096, 4096, 48),
                    ("full_t", b, 8, 1024, 1024, 80)):
            want[key] = want.get(key, 0) + 5
    if captures:
        want[("full_t", 2, 8, 1024, 1024, 80)] -= 5 * captures
        want[("avgp", 2, 8, 1024, 1024, 80)] = 5 * captures
    _expect_shapes(tag, got, want)


def _expect_shapes(tag: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{tag}: launches by (bucket, B, H, Sq, Skv, "
                             f"head dim) {got}, expected {want}")


def _check_images(tag: str, imgs, n: int, size: int = 512) -> None:
    """n finite, non-constant, distinct uint8 images of size^2."""
    import numpy as np

    f = imgs.astype(np.float64)
    if imgs.shape != (n, size, size, 3) or not np.isfinite(f).all() or min(
            f[i].std() for i in range(n)) == 0:
        raise AssertionError(f"{tag}: images are wrong: {imgs.shape}")
    for i in range(n):
        for j in range(i):
            if _image_diff(imgs[i], imgs[j]) == 0.0:
                raise AssertionError(f"{tag}: images {j} and {i} are equal")


def _runs(seen: list) -> str:
    """A list of UNet batches, run-length coded: "2 x5, 14 x2, 12 x3"."""
    out = []
    for b in seen:
        if out and out[-1][0] == b:
            out[-1][1] += 1
        else:
            out.append([b, 1])
    return ", ".join(f"{b} x{n}" for b, n in out)


def _timed(fn):
    """(what ``fn`` returns, its seconds on the host clock, the card
    drained before and after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def batch_phase(pipe, out_dir: str, acc: dict) -> None:
    """``text_to_images`` with 4 prompts: one CFG loop of 8 rows, each
    forward's 5 K1 and 5 K2 launches at B = 8, no capture; then with
    encoder reuse 2, where the non-key steps skip the two down-block
    self-attention layers at 64^2 and at 32^2."""
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.pipelines.base import encoder_key_gates
    from rich_text_to_image_tpu_torch.utils.png import write_png

    n = len(EVAL_PROMPTS)
    calls = pipe.scheduler.plan(STEPS_SHORT).num_steps
    os.makedirs(out_dir, exist_ok=True)
    rates = {}
    for stride in (1, 2):
        A.reset_launches()
        (imgs, seen), secs = _timed(lambda: _batches(
            pipe, lambda: pipe.text_to_images(
                EVAL_PROMPTS, height=512, width=512,
                num_inference_steps=STEPS_SHORT, guidance_scale=8.5, seed=6,
                encoder_reuse=stride)))
        got = _count_eval(acc)
        if stride == 1 and seen != [2 * n] * calls:
            raise AssertionError(f"batch: UNet batches {seen}")
        keys = int(encoder_key_gates(calls, stride, "early").sum())
        per = 5 * keys + 3 * (calls - keys)
        _expect_shapes(f"batch: encoder reuse {stride}", got, {
            ("full", 2 * n, 8, 4096, 4096, 48): per,
            ("full_t", 2 * n, 8, 1024, 1024, 80): per})
        _check_images("batch", imgs, n)
        for i, img in enumerate(imgs):
            write_png(os.path.join(out_dir, f"er{stride}_{i}.png"), img)
        rates[stride] = n / secs * 60
        print(f"batch: text_to_images, {n} prompts, 512x512, {calls} UNet "
              f"calls of B = {2 * n}, encoder reuse {stride} ({keys} key "
              f"steps): K1 {per} and K2 {per} launches, all at B = {2 * n}, "
              f"no K3; {secs:.3f} s, {rates[stride]:.2f} images a minute",
              flush=True)


def _eval_run(pipe, mod, argv: list, acc: dict, **kw):
    """``mod.run`` on ``pipe`` with ``argv`` from plain-pass step 1: (its
    summary, the UNet batches, launches by shape, seconds, peak device
    bytes)."""
    import torch

    from rich_text_to_image_tpu_torch.ops import attention as A

    args = mod.make_parser().parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    with _agg_start(pipe, 1):
        (summary, seen), secs = _timed(lambda: _batches(
            pipe, lambda: mod.run(args, model=pipe, **kw)))
    return (summary, seen, _count_eval(acc), secs,
            torch.cuda.max_memory_allocated())


def _saved_diffs(tag: str, dir_a: str, dir_b: str) -> tuple:
    """Each PNG of ``dir_a`` against its namesake in ``dir_b``: (mean |diff|
    of each, max |diff| of each), uint8 steps; fails above EVAL_MAX_DIFF."""
    import numpy as np

    from rich_text_to_image_tpu_torch.utils.png import read_png

    names = sorted(f for f in os.listdir(dir_a) if f.endswith(".png"))
    if not names or names != sorted(
            f for f in os.listdir(dir_b) if f.endswith(".png")):
        raise AssertionError(f"{tag}: the two runs saved other images")
    means, maxes = [], []
    for f in names:
        a, b = (read_png(os.path.join(d, f)).astype(np.int32)
                for d in (dir_a, dir_b))
        means.append(float(np.abs(a - b).mean()))
        maxes.append(int(np.abs(a - b).max()))
    if max(means) > EVAL_MAX_DIFF:
        raise AssertionError(f"{tag}: batched images too far from the "
                             f"sequential ones: {means}")
    return means, maxes


def colorbench_phase(pipe, out_dir: str, acc: dict) -> None:
    """The colour suite on 4 colours of its first prompt, batched (one
    forward of 2+3K = 14 rows a step up to the reference rows' last use,
    then 3K = 12) and one colour at a time (R+4 = 5 rows a step, the
    in-batch injection flow); the saved images of the two against each
    other."""
    from rich_text_to_image_tpu_torch.evaluation import benchmark_color as BC

    k = 4
    plan = pipe.scheduler.plan(STEPS_SHORT)
    S = plan.num_steps
    inject = [i for i, t in enumerate(plan.timesteps) if t > 0.8 * 1000]
    last = max(inject[-1] if inject else -1, int(0.3 * S))
    want = {k: [2] * S + [2 + 3 * k] * (last + 1) + [3 * k] * (S - last - 1),
            1: [2] * S + [5] * (S * k)}
    runs = {}
    for bc in (k, 1):
        path = os.path.join(out_dir, f"batch_colors_{bc}")
        summary, seen, got, secs, peak = _eval_run(
            pipe, BC, ["--steps", str(STEPS_SHORT), "--num_seeds", "1",
                       "--limit", str(k), "--batch_colors", str(bc),
                       "--save_img", "--save_path", path], acc)
        if seen != want[bc]:
            raise AssertionError(f"colorbench: --batch_colors {bc}: UNet "
                                 f"batches {seen}, expected {want[bc]}")
        _expect_by_shape("colorbench", got, seen, captures=1)
        if summary["ours_min"]["n"] != k:
            raise AssertionError(f"colorbench: {summary}")
        runs[bc] = path
        dist = {key: round(v["mean"], 4) for key, v in summary.items()
                if key != "config" and v["n"]}
        print(f"colorbench: --batch_colors {bc}: UNet batches {_runs(seen)}; "
              f"{secs:.3f} s, {k / secs * 60:.2f} items a minute (plain pass "
              f"and token maps included); distances {json.dumps(dist)}; "
              f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)",
              flush=True)
    means, maxes = _saved_diffs("colorbench", runs[k], runs[1])
    print(f"colorbench: batched against one at a time, mean |image "
          f"difference| {[round(m, 4) for m in means]} (bound "
          f"{EVAL_MAX_DIFF}), max {maxes} uint8 steps", flush=True)


def stylebench_phase(pipe, out_dir: str, acc: dict) -> None:
    """The style suite on 6 style pairs of its first scene, batched (K(R+2)
    = 24 rows a step) and one pair at a time (R+2 = 4 rows), random CLIP
    scorer; the saved images of the two against each other."""
    from rich_text_to_image_tpu_torch.evaluation import benchmark_style as BS

    k, regions = 6, 2
    S = pipe.scheduler.plan(STEPS_SHORT).num_steps
    want = {k: [2] * S + [k * (regions + 2)] * S,
            1: [2] * S + [regions + 2] * (S * k)}
    runs = {}
    for bp in (k, 1):
        path = os.path.join(out_dir, f"batch_pairs_{bp}")
        summary, seen, got, secs, peak = _eval_run(
            pipe, BS, ["--steps", str(STEPS_SHORT), "--num_seeds", "1",
                       "--limit", str(k), "--batch_pairs", str(bp),
                       "--save_img", "--save_path", path], acc)
        if seen != want[bp]:
            raise AssertionError(f"stylebench: --batch_pairs {bp}: UNet "
                                 f"batches {seen}, expected {want[bp]}")
        _expect_by_shape("stylebench", got, seen, captures=1)
        if (summary["ours"]["n"] != 2 * k
                or summary["clip_scores_random_weights"] is not True):
            raise AssertionError(f"stylebench: {summary}")
        runs[bp] = path
        print(f"stylebench: --batch_pairs {bp}: UNet batches {_runs(seen)}; "
              f"{secs:.3f} s, {k / secs * 60:.2f} items a minute (plain "
              f"pass, token maps, scorer init and scoring included); CLIP "
              f"score {summary['ours']['mean']:.4f} (random scorer, "
              f"flagged); peak device memory {peak} bytes", flush=True)
    means, maxes = _saved_diffs("stylebench", runs[k], runs[1])
    print(f"stylebench: batched against one at a time, mean |image "
          f"difference| {[round(m, 4) for m in means]} (bound "
          f"{EVAL_MAX_DIFF}), max {maxes} uint8 steps", flush=True)


def p2p_phase(pipe, out_dir: str, acc: dict) -> None:
    """Prompt-to-prompt (refine, then with LocalBlend): a forward of 3 rows
    (capturing (Q, K) and the full cross maps) and one of 1 row (injected)
    a step; the edited image must differ from the base one. Then LocalBlend
    with a threshold above 1, whose empty mask pulls the edited latent back
    to the base one after every step: the two images must be equal (within
    0.01 mean uint8 steps: the two rows of one decode)."""
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.pipelines.prompt_to_prompt import (
        PromptToPromptPipeline)
    from rich_text_to_image_tpu_torch.utils.png import write_png

    S = pipe.scheduler.plan(STEPS_SHORT).num_steps
    p2p = PromptToPromptPipeline(pipe)
    os.makedirs(out_dir, exist_ok=True)
    blend = {"blend_words": ("cat", "cat")}
    for tag, kw in (("refine", {}), ("blend", blend),
                    ("blend-empty", dict(blend, blend_threshold=1.5))):
        A.reset_launches()
        (imgs, seen), secs = _timed(lambda: _batches(
            pipe, lambda: p2p.generate(
                "a cat riding a scooter", "a red cat riding a scooter",
                num_inference_steps=STEPS_SHORT, guidance_scale=8.5,
                height=512, width=512, seed=6, **kw)))
        got = _count_eval(acc)
        if seen != [3, 1] * S:
            raise AssertionError(f"p2p: {tag}: UNet batches {seen}")
        _expect_by_shape(f"p2p {tag}", got, seen)
        if tag == "blend-empty":
            if _image_diff(imgs[0], imgs[1]) > 0.01:
                raise AssertionError("p2p: LocalBlend's empty mask left the "
                                     "edited image apart from the base one")
        else:
            _check_images(f"p2p {tag}", imgs, 2)
        for name, img in zip(("base", "edited"), imgs):
            write_png(os.path.join(out_dir, f"{tag}_{name}.png"), img)
        print(f"p2p: {tag}: UNet batches 3 and 1 in each of {S} steps; K1 "
              f"and K2 {5 * S} launches each at B = 3 and at B = 1; edited "
              f"against base mean |image difference| "
              f"{_image_diff(imgs[0], imgs[1]):.3f} of 255; {secs:.3f} s",
              flush=True)


def colorbench_p2p_phase(pipe, out_dir: str, acc: dict) -> None:
    """The colour suite with its prompt-to-prompt baseline, one item."""
    from rich_text_to_image_tpu_torch.evaluation import benchmark_color as BC

    S = pipe.scheduler.plan(STEPS_SHORT).num_steps
    summary, seen, got, secs, _ = _eval_run(
        pipe, BC, ["--steps", str(STEPS_SHORT), "--num_seeds", "1",
                   "--limit", "1", "--with_p2p", "--save_path", out_dir],
        acc)
    if seen != [2] * S + [5] * S + [3, 1] * S:
        raise AssertionError(f"colorbench-p2p: UNet batches {seen}")
    _expect_by_shape("colorbench-p2p", got, seen, captures=1)
    if summary["p2p_min"]["n"] != 1:
        raise AssertionError(f"colorbench-p2p: {summary}")
    print(f"colorbench-p2p: one item with the prompt-to-prompt baseline, "
          f"UNet batches {_runs(seen)}; distances ours "
          f"{summary['ours_min']['mean']:.4f} / "
          f"{summary['ours_avg']['mean']:.4f}, p2p "
          f"{summary['p2p_min']['mean']:.4f} / "
          f"{summary['p2p_avg']['mean']:.4f} (min / avg); {secs:.3f} s",
          flush=True)


def _xl_inputs(xl, b: int, seed: int):
    """A [b,128,128,4] latent batch, b text and pooled rows and the time
    ids of a 1024^2 SDXL forward."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    lat = torch.randn((1, 128, 128, 4), generator=g, device="cuda")
    emb, pooled = xl.encode_prompt(["a cat", "a scooter", "a palm"][:b - 1],
                                   "")
    return (torch.cat([lat] * b), emb, pooled,
            xl._time_ids(SDXL_SIZE, SDXL_SIZE))


def sdxl_unet_phase(xl) -> None:
    """One full-width SDXL CFG forward at a 128^2 latent through the
    kernels (10 K1 launches at 64^2, the 60 32^2 layers through the
    capture) against the plain attention: eps, each layer's head average
    and their sum over the 60 layers (what the plain pass accumulates),
    each within UNET_RTOL of its max."""
    import torch

    from rich_text_to_image_tpu_torch.models.unet import CaptureSpec
    from rich_text_to_image_tpu_torch.ops import attention as A

    _, self_layers, cross_by_res = xl._capture_layout((128, 128))
    spec = CaptureSpec(self_probs=frozenset(self_layers),
                       cross_probs=frozenset(
                           n for ns in cross_by_res.values() for n in ns))
    x, emb, pooled, tid = _xl_inputs(xl, 2, 1)
    with torch.no_grad():
        A.reset_launches()
        eps_k, aux_k = xl._fwd(x, 500, emb, pooled, tid, capture=spec)
        torch.cuda.synchronize()
        launched = A.launches_by_dim()
        with A.plain_attention():
            eps_p, aux_p = xl._fwd(x, 500, emb, pooled, tid, capture=spec)
        torch.cuda.synchronize()
    want = {("full", 64): SDXL_SELF_64, ("avgp", 64): SDXL_SELF_32}
    if len(self_layers) != SDXL_SELF_32 or launched != want:
        raise AssertionError(f"sdxl-unet: launches {launched}, expected "
                             f"{want} ({len(self_layers)} capture layers)")

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    e_err = rel(eps_k, eps_p)
    p_err = max(rel(aux_k["self_probs"][n], aux_p["self_probs"][n])
                for n in self_layers)
    s_err = rel(sum(aux_k["self_probs"][n] for n in self_layers),
                sum(aux_p["self_probs"][n] for n in self_layers))
    fin = bool(torch.isfinite(eps_k).all())
    print(f"sdxl-unet: eps {tuple(eps_k.shape)} rel max|d|={e_err:.3e}, "
          f"self_probs rel max|d| {p_err:.3e} (worst of {len(self_layers)} "
          f"layers), their sum {s_err:.3e} (tol {UNET_RTOL}), finite={fin}, "
          f"launches {launched}", flush=True)
    if not fin or max(e_err, p_err, s_err) > UNET_RTOL:
        raise AssertionError("the SDXL UNet through the kernels disagrees "
                             "with the plain attention")


def _sdxl_counts(calls: int) -> dict:
    """Launches of a CLI run at 1024^2 with ``calls`` UNet calls a pass and
    the plain pass capturing from step 1: every self-attention a forward
    takes K1 at head dim 64, but the 32^2 ones of a capture step, which
    take the capture (K3)."""
    cap = calls - 1
    per = SDXL_SELF_64 + SDXL_SELF_32
    return {"full": 2 * calls * per - cap * SDXL_SELF_32,
            "avgp": cap * SDXL_SELF_32, "full_t": 0, "stream": 0,
            "conv3x3": 0}


def _sdxl_shape_launches(name: str, shape: tuple, calls: int) -> int:
    """Launches of a kernel at one shape that ``sdxl_phase``'s run should
    count: the plain pass at batch 2 (the 32^2 layers only on step 0, the
    capture taking them after), the rich pass at R+2."""
    b, _, s, _ = shape
    if name.startswith("K3"):
        return (calls - 1) * SDXL_SELF_32 if b == 2 else 0
    if s == 4096:
        return calls * SDXL_SELF_64 if b in (2, REGIONS + 2) else 0
    if b == 2:
        return SDXL_SELF_32
    return calls * SDXL_SELF_32 if b == REGIONS + 2 else 0


def sdxl_phase(xl, out_dir: str, tag: str = "sdxl", extra=()) -> tuple:
    """The port's CLI flow with ``--model SDXL`` at 1024^2 under Euler
    (its default), 4 steps, the plain pass capturing from step 1. Asserts
    the exact launches (K1 and K3 at head dim 64 only, no K2 or K4), the
    UNet batches (2 in the plain pass, R+2 in the rich one), finite
    non-constant images that carry the watermark; returns (launches, the
    launches by shape, the rich image, seconds, peak device bytes)."""
    import numpy as np
    import torch

    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.utils.watermark import (
        WATERMARK_BITS, decode_watermark)

    calls = xl.scheduler.plan(STEPS_SHORT).num_steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (launches, seconds, plain, rich, share), seen = _batches(
        xl, lambda: sample_phase(tag, xl, out_dir, SDXL_SIZE, STEPS_SHORT,
                                 ["--model", "SDXL", *extra], agg_start=1))
    peak = torch.cuda.max_memory_allocated()
    by_shape = dict(A.LAUNCHES_BY_SHAPE)
    by_dim = A.launches_by_dim()
    want = _sdxl_counts(calls)
    _expect(tag, launches, want)
    if by_dim != {("full", 64): want["full"], ("avgp", 64): want["avgp"]}:
        raise AssertionError(f"{tag}: launches by head dim {by_dim}")
    if seen != [2] * calls + [REGIONS + 2] * calls:
        raise AssertionError(f"{tag}: UNet batches {seen}, expected {calls} "
                             f"of 2 then {calls} of R+2 = {REGIONS + 2}")
    marks = [decode_watermark(img[0]) for img in (plain, rich)]
    print(f"{tag}: {calls} UNet calls a pass (Euler), K1 launches at head "
          f"dim 64 {want['full']}, K3 {want['avgp']} ({SDXL_SELF_32} on each "
          f"of {calls - 1} capture steps), no K2 or K4; rich batch R+2 = "
          f"{REGIONS + 2}; watermark bits recovered: "
          f"{[m[0] == WATERMARK_BITS for m in marks]} (vote margins "
          f"{[round(m[1], 3) for m in marks]}); peak device memory "
          f"{peak} bytes ({peak / 2**30:.2f} GiB) on {_smi()}", flush=True)
    if marks[1][0] != WATERMARK_BITS:
        raise AssertionError(f"{tag}: the watermark is not in the image")
    if not np.isfinite(rich.astype(np.float64)).all():
        raise AssertionError(f"{tag}: the image is not finite")
    return launches, by_shape, rich, seconds, peak


def sdxl_refpre_phase(xl, out_dir: str, no_inject_img) -> None:
    """The ``sdxl:`` request with ``--inject_selfattn 0.3
    --inject_background 0.3``: the plain pass keeps the refer cache and the
    rich pass runs R+2 rows (a fallback to the in-batch flow's R+4 fails
    the batch check in ``sdxl_phase``); the slot's bytes against the JAX
    package's ~0.42 GB a slot at 1024^2 (region_sdxl.py:394-396)."""
    _, _, rich, _, _ = sdxl_phase(
        xl, out_dir, "sdxl-refpre",
        ["--inject_selfattn", "0.3", "--inject_background", "0.3"])
    cache = xl.ref_cache
    if cache is None:
        raise AssertionError("sdxl-refpre: the plain pass kept no cache")
    slot = xl._ref_qk_bytes_per_slot((128, 128))
    tensors = [cache["traj"], *cache["resnet"].values(),
               *(t for qk in cache["qk"].values() for t in qk)]
    total = sum(t.numel() * t.element_size() for t in tensors)
    moved = _image_diff(rich, no_inject_img)
    print(f"sdxl-refpre: refer cache {len(cache['steps'])} slot(s) (steps "
          f"{list(cache['steps'])}), {slot} bytes a slot ({slot / 1e9:.3f} "
          f"GB; the JAX package's comment: ~0.42 GB), {total} bytes with the "
          f"trajectory; {len(cache['qk'])} self-attention layers; mean "
          f"|image difference| against the run without injection "
          f"{moved:.4f} of 255", flush=True)
    if moved == 0.0:
        raise AssertionError("sdxl-refpre: the injection did not change the "
                             "image")


def sdxl_breakdown_phase(xl) -> None:
    """Per-call times at 1024^2 (CUDA events): the UNet at B=2 and R+2,
    one colour-guided step exact (fp32 decode and its gradient, TF32 off)
    with its peak device memory, and pooled by 2, the final decode; then
    one B=2 forward under ``torch.profiler``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with torch.no_grad():
        for b in (2, REGIONS + 2):
            x, emb, pooled, tid = _xl_inputs(xl, b, 2)
            out[f"unet_b{b}_ms"] = _time_ms(
                lambda: xl._fwd(x, 500, emb, pooled, tid), 3)
        lat = x[:1]
        out["decode_ms"] = _time_ms(lambda: xl.decode_latents(lat), 2)
    noise = torch.randn_like(lat)
    fmt = {"color_obj_atten": [(np.random.default_rng(2).random(
               (SDXL_SIZE, SDXL_SIZE)) > 0.5).astype(np.float32)],
           "target_RGB": [[1.0, 0.0, 0.0]],
           "color_obj_atten_all": np.ones((128, 128), np.float32)}
    for tag, ds in (("", 1), ("_gds2", 2)):
        color = xl._color_inputs(fmt, SDXL_SIZE, SDXL_SIZE, 128, 128, ds,
                                 False, 0.5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[f"guided_step{tag}_ms"] = _time_ms(
            lambda: xl._guided(lat, noise, 0.5, color), 2)
        out[f"guided_step{tag}_peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"sdxl-breakdown: {json.dumps(out)} on {_smi()}", flush=True)
    x, emb, pooled, tid = _xl_inputs(xl, 2, 3)
    with torch.no_grad():
        xl._fwd(x, 500, emb, pooled, tid)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            xl._fwd(x, 500, emb, pooled, tid)
            torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s0, e0 in spans:
        busy_us += max(0.0, e0 - max(s0, end))
        end = max(end, e0)
    wall = out["unet_b2_ms"]
    idle = f"{1 - busy_us / 1e3 / wall:.3f}" if spans else "not measured"
    print(f"profile: sdxl unet B=2: {len(spans)} device kernels, busy "
          f"{busy_us / 1e3:.3f} ms of {wall:.3f} ms un-profiled, idle share "
          f"{idle}", flush=True)


def main(kernels_only: bool = False) -> int:
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
    # the injection paths take fixed masks whose background band holds a
    # third of the latent, so that background injection reaches the image
    calls = pipe.scheduler.plan(STEPS_SHORT).num_steps
    _, _, plain_off, rich_off, _ = sample_phase(
        "inject-off", pipe, os.path.join(out, "inject_off"), 512,
        STEPS_SHORT, agg_start=1)
    with _fixed_masks(pipe):
        _, _, _, fixed_off, _ = sample_phase(
            "inject-off-fixed", pipe, os.path.join(out, "inject_off_fixed"),
            512, STEPS_SHORT, agg_start=1)
        _, _, _, rich_nobg, _ = sample_phase(
            "inject-nobg", pipe, os.path.join(out, "inject_nobg"), 512,
            STEPS_SHORT, ["--inject_selfattn", "0.3", "--no_ref_precompute"],
            agg_start=1)
        (launches, _, _, rich_on, share), seen_batch = _batches(
            pipe, lambda: sample_phase(
                "inject", pipe, os.path.join(out, "inject"), 512,
                STEPS_SHORT,
                ["--inject_selfattn", "0.3", "--inject_background", "0.3",
                 "--no_ref_precompute"], agg_start=1))
        bg_share = float(pipe.masks[-1].sum()
                         / sum(m.sum() for m in pipe.masks))
    _expect("inject", launches, {"full": 2 * calls * 5, "avgp": 5,
                                 "full_t": 2 * calls * 5 - 5})
    if seen_batch != [2] * calls + [REGIONS + 4] * calls:
        raise AssertionError(f"inject: UNet batches {seen_batch}, expected "
                             f"{calls} of 2 then {calls} of R+4 = "
                             f"{REGIONS + 4}")
    moved = _image_diff(rich_on, fixed_off)
    bg_moved = _background_diff(rich_on, rich_nobg, REGIONS + 1)
    print(f"inject: rich batch R+4 = {REGIONS + 4} in {calls} calls; fixed "
          f"masks, background share {bg_share:.3f}; mean |image difference| "
          f"against the run without injection {moved:.3f} of 255, in the "
          f"background band against the run without background injection "
          f"{bg_moved:.3f}", flush=True)
    if moved == 0.0 or share == 0.0:
        # the injected rows are the span rows: with empty span regions they
        # would not reach the image
        raise AssertionError("injection did not change the image")
    if bg_share == 0.0 or bg_moved == 0.0:
        raise AssertionError("background injection did not change the "
                             "background")

    refpre_phase(pipe, os.path.join(out, "refpre"), rich_on, fixed_off)
    scheduler_phases(pipe, os.path.join(out, "sched"), (plain_off, rich_off))
    turbo_phase(pipe, os.path.join(out, "turbo"), rich_off)

    # the evaluation paths: their UNet batches and launches, counted apart
    acc = {"by_shape": {}}
    batch_phase(pipe, os.path.join(out, "batch"), acc)
    colorbench_phase(pipe, os.path.join(out, "colorbench"), acc)
    stylebench_phase(pipe, os.path.join(out, "stylebench"), acc)
    p2p_phase(pipe, os.path.join(out, "p2p"), acc)
    colorbench_p2p_phase(pipe, os.path.join(out, "colorbench_p2p"), acc)
    for name, bucket, s_len, d in (("K1_attn_fwd_64x64", "full", 4096, 48),
                                   ("K2_attn_fwd_32x32", "full_t", 1024, 80)):
        rows[name]["eval_launches"] = acc[bucket]
        for entry in rows[name]["eval_batches"]:
            entry["launches"] = acc["by_shape"].get(
                (bucket, entry["shape"][0], 8, s_len, s_len, d), 0)
            if not entry["launches"]:
                raise AssertionError(f"{name}: no evaluation path launched "
                                     f"it at {entry['shape']}")
    print("eval: launches by (bucket, B, H, Sq, Skv, head dim) "
          + json.dumps({",".join(map(str, k)): n
                        for k, n in sorted(acc["by_shape"].items())}),
          flush=True)

    profile_phase(pipe, breakdown_phase(pipe))

    # SDXL at 1024^2: the SD pipeline gives its memory back first
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    from rich_text_to_image_tpu_torch.pipelines.region_sdxl import (
        RegionDiffusionXL)

    t0 = time.time()
    xl = RegionDiffusionXL.random_init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (xl.unet, xl.vae, xl.text_encoder,
                                       xl.text_encoder_2)
                   for p in m.parameters())
    print(f"init: full-width SDXL pipeline, {n_params} parameters drawn on "
          f"the card, {time.time() - t0:.1f} s", flush=True)
    sdxl_unet_phase(xl)
    launches, by_shape, rich_xl, _, _ = sdxl_phase(
        xl, os.path.join(out, "sdxl"))
    rows["K1_attn_fwd_64x64"]["sdxl_launches"] = launches["full"]
    rows["K3_attn_avgp_32x32"]["sdxl_launches"] = launches["avgp"]
    # each SDXL shape's launches as the sdxl: run counted them, held
    # against what its layers and batches give
    calls = xl.scheduler.plan(STEPS_SHORT).num_steps
    for name, bucket in (("K1_attn_fwd_64x64", "full"),
                         ("K3_attn_avgp_32x32", "avgp")):
        for entry in rows[name].get("sdxl_d64", []):
            b, h, s, d = entry["shape"]
            entry["launches"] = by_shape.get((bucket, b, h, s, s, d), 0)
            want = _sdxl_shape_launches(name, (b, h, s, d), calls)
            if entry["launches"] != want:
                raise AssertionError(
                    f"sdxl: {name} launched {entry['launches']} times at "
                    f"{entry['shape']}, expected {want}: {by_shape}")
    print("sdxl: launches by (bucket, B, H, Sq, Skv, head dim) "
          + json.dumps({",".join(map(str, k)): n
                        for k, n in sorted(by_shape.items())}), flush=True)
    sdxl_refpre_phase(xl, os.path.join(out, "sdxl_refpre"), rich_xl)
    sdxl_breakdown_phase(xl)

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
