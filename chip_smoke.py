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

 16. this slice's entry points and model paths, each on a line of its own:
     ``grad-guard:`` (after phase 3: every kernel wrapper raises under
     autograd), ``dual:`` (after phase 4: a full-width UNet with
     ``dual_cross_attention``, both streams through the kernels, against
     the plain attention), and before phase 13 ``ckpt:`` (``save_pipeline``
     of the SD pipeline), ``lora:`` (a seeded LoRA merged into the UNet and
     the text encoder: scale 0 gives the base image exactly, scale 1 moves
     it, ``load_params`` of the checkpoint gives it back) and ``demo:``
     (``cli.gradio_app.run_generate`` of an example at the demo's SD
     defaults, 12 steps: its R+2 batches, launches by shape, figures,
     stage seconds and a device trace of its rich pass); after the SDXL
     paths ``demo-xl:`` (the same at the SDXL defaults, 1024^2, 4 Euler
     steps). The kernels line adds each one's launches by shape
     (``phase_launches``).
 17. the ninth slice's modules, before phase 13: ``mesh1:`` (the 512^2
     4-step refer-precompute request with ``--mesh 1`` in a world of one,
     nccl, equal to the run without a mesh to the bit), ``train:`` (three
     AdamW steps of the training step on SD-1.5 at full width: finite,
     falling, no hand-written launch), ``mesh2:`` (two ranks spawned on the
     one card in a gloo group: the same request at dp = 2, each rank's
     batches halved, and at tp = 2, each rank launching the single-rank
     run's kernels, images within EVAL_MAX_DIFF; the colour bench's batched
     item at dp = 2; one full-width SDXL UNet forward at tp = 2 on each
     rank's own heads against the rank's whole UNet; one training step at
     dp = 2 against one rank's loss), ``bpe:`` (the native merge loop
     loaded and equal to Python's) and ``flops:`` (the FLOP counts and the
     SD-1.5 forward's mfu).
 18. the trained colour fixture, before phase 13: ``fixture-eval:`` (the
     port's colour-fixture evaluation on the committed, JAX-trained
     fixture: gradient cosines, the colour benchmark at 41 steps in the
     exact, pooled and bf16 guidance configurations, steering asserted)
     and ``fixture-train:`` (the port's trainer, 1500 VAE + 4000 UNet
     steps at batch 64, then the fixture gates and the exact evaluation on
     the fresh pair); neither launches a hand-written kernel.
 19. the throughput program, last: ``bench:`` (``rich_text_to_image_tpu_
     torch/bench.py``'s ``_run`` for SD-1.5 at 512^2 and SDXL at 1024^2,
     turbo then exact, 50 steps uncut, each model built by the CLI's
     ``build_model``: a warm-up and the best of 3 or 2 timed runs, images
     a minute and MFU, stage seconds, peak memory, refer-cache slots and
     one run's launches by shape against the step structure; the
     ``_emit`` records). The kernel phase holds every shape it launches.

``--kernels-only`` stops after phase 3 (and the grad guard). The line before the last lists the
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
# the multi-device phases: the 512^2 4-step request through the CLI's default
# refer-precompute flow, on a mesh of one rank (nccl) and of two ranks that
# share the card (gloo), whose images may move within EVAL_MAX_DIFF (the
# card's matrix products depend on the batch)
MESH_ARGV = ["--inject_selfattn", "0.3", "--inject_background", "0.3"]
MESH2_TIMEOUT = 600  # seconds the two ranks may take, build and init in
# the training step: SD-1.5 at full width, B = 2 at a 64^2 latent, AdamW at
# the JAX make_train_step's default lr: at 1e-3 (the JAX test's, at TINY
# widths) and at 1e-4 Adam's first steps raised the full-width loss on one
# batch and draw in trial runs on the H100
TRAIN_LR, TRAIN_B, TRAIN_STEPS = 1e-5, 2, 3
TRAIN_LOSS_RTOL = 2e-2  # the dp = 2 step's loss against one rank's (bf16)
# the demo's request: an example of cli/examples.py with a footnote, a
# coloured span and a font size; its 3 span regions make the rich batch
# R+2 = 5 (the refer-precompute flow, which the demo's default background
# injection takes)
DEMO_EXAMPLE = "everything"
DEMO_RICH = 5
# the dual-guided UNet's context: 77 text tokens, then 257 image tokens
# (Versatile Diffusion's two conditions; random here)
DUAL_CONTEXT = (77, 257)
# a rank-4 LoRA on every attention projection: W' = W + up @ down, with
# down ~ N(0, 1/in) and up ~ N(0, LORA_UP_STD^2 / rank), about 30% of the
# random weights' own spread
LORA_RANK = 4
LORA_UP_STD = 0.3
# the SDXL attn1 layers at 1024^2 (models/config.py SDXL_UNET): 10 at the
# 64^2 level, 60 at 32^2 (the segmentation level, all captured); of them
# 4 and 20 in the down path, which encoder reuse skips off its key steps
SDXL_SELF_64, SDXL_SELF_32 = 10, 60
SDXL_DOWN_64, SDXL_DOWN_32 = 4, 20
# the throughput program (rich_text_to_image_tpu_torch/bench.py) samples
# the CLI's default rich text, one footnote span: its rich batch is R+2 = 3
BENCH_RICH = 3
# the (kernel, B, H, S, d) the throughput program launches: SD-1.5's plain
# and rich batches at 64^2 and 32^2, its capture; SDXL's at head dim 64
BENCH_SHAPES = {
    *(("K1_attn_fwd_64x64", b, h, s, d) for b in (2, BENCH_RICH)
      for h, s, d in ((8, 4096, 40), (10, 4096, 64), (20, 1024, 64))),
    *(("K2_attn_fwd_32x32", b, 8, 1024, 80) for b in (2, BENCH_RICH)),
    ("K3_attn_avgp_32x32", 2, 8, 1024, 80),
    ("K3_attn_avgp_32x32", 2, 20, 1024, 64),
}

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
    # FLUX.1's joint attention, [512 text ; 4,096 image] tokens, 24 heads of
    # 128: the plain pass's row and the rich pass's R + 1 = 2
    ("K1_attn_fwd_64x64", "fwd", 1, 24, 4608, 128, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 24, 4608, 128, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 1, 4, 1000, 120, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", DEMO_RICH, 10, 4096, 64, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", DEMO_RICH, 20, 1024, 64, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", BENCH_RICH, 10, 4096, 64, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", BENCH_RICH, 20, 1024, 64, "full", {}),
    ("K2_attn_fwd_32x32", "fwd", 2, 8, 1024, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", _RICH, 8, 1024, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", _INJ, 8, 1024, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", 2, 8, 1000, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", _RICH, 8, 1000, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", 1, 8, 520, 80, "full_t", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 1024, 80, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 1000, 80, "avgp", {}),
    # a dp = 2 rank's plain-pass capture (mesh2:)
    ("K3_attn_avgp_32x32", "avgp", 1, 8, 1024, 80, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 1, 8, 1000, 80, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 2304, 80, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 576, 160, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 8, 1024, 160, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 20, 1024, 64, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 2, 20, 1000, 64, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 1, 24, 4608, 128, "avgp", {}),
    ("K3_attn_avgp_32x32", "avgp", 1, 4, 1000, 120, "avgp", {}),
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
# tp = 2, the attention on each rank's own heads (parallel/mesh.heads_local):
# SD-1.5's 8 heads halve to 4 (mesh2:'s plain pass at batch 2, its rich
# pass at R+2; the 768^2 streaming level), SDXL's 10 and 20 to 5 and 10
TP_CASES = [
    ("K1_attn_fwd_64x64", "fwd", 2, 4, 4096, 40, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", _RICH, 4, 4096, 40, "full", {}),
    ("K2_attn_fwd_32x32", "fwd", 2, 4, 1024, 80, "full_t", {}),
    ("K2_attn_fwd_32x32", "fwd", _RICH, 4, 1024, 80, "full_t", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 5, 4096, 64, "full", {}),
    ("K1_attn_fwd_64x64", "fwd", 2, 10, 1024, 64, "full", {}),
    ("K4_attn_stream_96x96", "fwd", 2, 4, 9216, 40, "stream", {}),
]
ATTN_CASES += TP_CASES


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

    rows, k4_tiles, sdxl, evals, demo, tp2 = {}, {}, {}, {}, {}, {}
    bench = {}
    sm_hz = _max_sm_hz()
    for case in cases:
        name, kind, b, h, s, d, bucket, kw = case
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
        if (d == 64 and not kw and (h, s) in ((10, 4096), (20, 1024))
                and b != BENCH_RICH):
            (demo if b == DEMO_RICH else sdxl).setdefault(name, []).append(
                entry)
        if (name, b, h, s, d) in BENCH_SHAPES and not kw:
            bench.setdefault(name, []).append(dict(entry))
        if b in EVAL_BATCHES and (h, s, d) in ((8, 4096, 40), (8, 1024, 80)):
            evals.setdefault(name, []).append(entry)
        if case in TP_CASES:
            tp2.setdefault(name, []).append(dict(entry, tile=list(tile)))
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
    for name, entries in demo.items():
        rows[name]["demo_d64"] = entries
    for name, entries in bench.items():
        rows[name]["bench_shapes"] = entries
    _tp2_tiles(tp2)
    for name, entries in tp2.items():
        rows[name]["tp2_local"] = entries
    _capture_accumulated(SDXL_SELF_32)
    q, k, v = _qkv(2, 8, 4096, 40, seed=2)
    print("kernel K1 wrapper host us a launch at [2,8,4096,40]: "
          f"{_host_us(lambda: A.flash_attention(q, k, v, 40 ** -0.5)):.2f}",
          flush=True)
    return rows


def _tp2_tiles(tp2: dict) -> None:
    """The tile ``_fwd_tile`` picks at each local-head shape (fitted at the
    paths' 8, 10 and 20 heads; at 4, 5 and 10 a shape has half the CTAs):
    the pick must be a built tile; printed with its CTAs and waves."""
    from rich_text_to_image_tpu_torch.ops import attention as A

    out = {}
    for entries in tp2.values():
        for e in entries:
            b, h, s, d = e["shape"]
            m, tk = e["tile"]
            if A._FWD_TILES[A._padded(d)].get(m) != tk:
                raise AssertionError(f"_fwd_tile picked ({m}, {tk}) at "
                                     f"{e['shape']}: no such built tile")
            ctas = -(-s // m) * b * h
            out[f"[{b},{h},{s},{d}]"] = {"tile": [m, tk], "ctas": ctas,
                                         "waves": -(-ctas // A._SMS)}
    print("kernel tp2 tiles (query rows a CTA, keys a tile; CTAs, waves of "
          f"{A._SMS}) picked by ops/attention._fwd_tile at the local heads: "
          + json.dumps(out), flush=True)


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


def unet_phase(pipe) -> float:
    """One full-width CFG forward with capture, kernels vs plain attention;
    returns the forward's ms without capture."""
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
    with torch.no_grad():
        fwd_ms = _time_ms(lambda: pipe.unet(x, 500, ctx), 10)
    print(f"unet: eps {tuple(eps_k.shape)} rel max|d|={e_err:.3e}, self_probs "
          f"rel max|d|={p_err:.3e} (tol {UNET_RTOL}), finite={fin}, "
          f"launches {launched}; forward without capture {fwd_ms:.3f} ms",
          flush=True)
    if not fin or e_err > UNET_RTOL or p_err > UNET_RTOL:
        raise AssertionError("UNet through the kernels disagrees with the "
                             "plain attention")
    return fwd_ms


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


def _device_busy(fn) -> tuple:
    """(device kernels, their busy ms: the union of their intervals) of one
    call of ``fn`` under ``torch.profiler``, after one call un-profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    return len(spans), busy_us / 1e3


def _profile_line(what: str, fn, wall_ms: float) -> None:
    """The ``profile:`` line of one call of ``fn``: its device kernels,
    their busy time, and the device's idle share of ``wall_ms``, the call's
    un-profiled time."""
    n, busy = _device_busy(fn)
    idle = f"{1 - busy / wall_ms:.3f}" if n else "not measured"
    print(f"profile: {what}: {n} device kernels, busy {busy:.3f} ms of "
          f"{wall_ms:.3f} ms un-profiled, idle share {idle}", flush=True)


def profile_phase(pipe, unet_ms: dict) -> None:
    """One UNet forward at B=2 and B=R+2 under ``torch.profiler``: the number
    of kernels it launches, their summed device time, and the device's idle
    share of the forward's un-profiled time from the breakdown phase."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(3)
    lat = torch.randn((1, 64, 64, 4), generator=g, device="cuda")
    ctx = pipe.get_text_embeds(["a cat", "a scooter", "a palm"], [""])
    for b in (2, REGIONS + 2):
        x = torch.cat([lat] * b)
        with torch.no_grad():
            _profile_line(f"unet B={b}", lambda: pipe.unet(x, 500, ctx[:b]),
                          unet_ms[f"unet_b{b}_ms"])


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
    _expect_shapes(tag, got, _sd_launches(seen, captures))


def _sd_launches(seen: list, captures: int = 0, capture_b: int = 2) -> dict:
    """The SD-1.5 512^2 launches of the UNet forwards of batches ``seen``:
    5 K1 at 64^2 and 5 K2 at 32^2 each, but for ``captures`` plain-pass
    capture steps at batch ``capture_b``, whose 5 32^2 layers take K3."""
    want: dict = {}
    for b in seen:
        for key in (("full", b, 8, 4096, 4096, 48),
                    ("full_t", b, 8, 1024, 1024, 80)):
            want[key] = want.get(key, 0) + 5
    if captures:
        want[("full_t", capture_b, 8, 1024, 1024, 80)] -= 5 * captures
        want[("avgp", capture_b, 8, 1024, 1024, 80)] = 5 * captures
    return want


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
    from rich_text_to_image_tpu_torch.bench import _cache_size

    _, _, rich, _, _ = sdxl_phase(
        xl, out_dir, "sdxl-refpre",
        ["--inject_selfattn", "0.3", "--inject_background", "0.3"])
    cache = xl.ref_cache
    if cache is None:
        raise AssertionError("sdxl-refpre: the plain pass kept no cache")
    slot = xl._ref_qk_bytes_per_slot((128, 128))
    _, total = _cache_size(cache)
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


SDXL_MICRO = {"original_size": (512, 512), "crops_coords_top_left": (0, 256)}


def sdxl_sample_phase(xl, rows: dict) -> None:
    """``RegionDiffusionXL.sample``, the single entry, at its default size
    (``default_sample_size`` latent pixels: 1024^2) under Euler, 4 steps,
    from one latent, cuDNN deterministic: the plain branch equal to
    ``produce_attn_maps`` and the rich one to ``prompt_to_img`` to the bit;
    SDXL_MICRO's original size and crop corner move the image; a refer
    cache made under the default time ids is taken by a rich call under
    them (R+2 rows a step) and refused under SDXL_MICRO (the in-batch
    flow's R+4 rows). Every run's launches are exact: 70 K1 at head dim 64
    a forward, but on a plain pass's capture steps (from step 1) 10 K1 and
    60 K3."""
    import numpy as np
    import torch

    from rich_text_to_image_tpu_torch.ops import attention as A

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    size = xl.default_sample_size * xl.vae_scale_factor
    h = w = xl.default_sample_size
    prompt = "a cat wearing sunglasses on a beach"
    regions = ["a ginger cat", "golden sunglasses", prompt]  # base last
    masks = np.zeros((len(regions), 1, h, w), np.float32)
    edges = np.linspace(0, w, len(regions) + 1).astype(int)
    for i in range(len(regions)):
        masks[i, :, :, edges[i]:edges[i + 1]] = 1.0
    xl.masks = list(masks)
    g = torch.Generator(device="cuda").manual_seed(7)
    lat = torch.randn((1, h, w, 4), generator=g, device="cuda")
    plan = xl.scheduler.plan(STEPS_SHORT)
    calls = plan.num_steps
    steps = tuple(np.nonzero(plan.timesteps.astype(np.float64) > 700)[0]
                  .tolist())  # inject_selfattn 0.3
    inject = {"inject_selfattn": 0.3, "inject_background": 0.3}
    kw = {"num_inference_steps": STEPS_SHORT, "latents": lat}
    runs, by_shape = {}, {}

    def run(tag, fn, rich: bool):
        A.reset_launches()
        (img, seen), secs = _timed(lambda: _batches(xl, fn))
        caps = 0 if rich else calls - 1
        want = {"full": (SDXL_SELF_64 + SDXL_SELF_32) * len(seen)
                - SDXL_SELF_32 * caps, "avgp": SDXL_SELF_32 * caps,
                "full_t": 0, "stream": 0}
        _expect(f"sdxl-sample {tag}", dict(A.LAUNCHES), want)
        for k, n in A.LAUNCHES_BY_SHAPE.items():
            by_shape[k] = by_shape.get(k, 0) + n
        runs[tag] = (img, seen, secs)
        return img

    try:
        with _agg_start(xl, 1):
            run("plain", lambda: xl.sample(prompt, **kw), False)
            run("produce_attn_maps", lambda: xl.produce_attn_maps(
                prompt, height=size, width=size, **kw)[0], False)
            run("rich", lambda: xl.sample(regions, run_rich_text=True,
                                          **inject, **kw), True)
            run("prompt_to_img", lambda: xl.prompt_to_img(
                regions, height=size, width=size, **inject, **kw), True)
            run("plain-micro", lambda: xl.sample(prompt, **SDXL_MICRO, **kw),
                False)
            run("plain-cache", lambda: xl.sample(
                prompt, ref_capture_steps=steps, **kw), False)
            cache = xl.ref_cache
            run("rich-cache", lambda: xl.sample(
                regions, run_rich_text=True, ref_cache=cache, **inject, **kw),
                True)
            run("rich-cache-micro", lambda: xl.sample(
                regions, run_rich_text=True, ref_cache=cache, **SDXL_MICRO,
                **inject, **kw), True)
    finally:
        torch.backends.cudnn.deterministic = det
    same = {k: bool(np.array_equal(runs[a][0], runs[k][0]))
            for a, k in (("plain", "produce_attn_maps"),
                         ("rich", "prompt_to_img"))}
    gap = _image_diff(runs["plain-micro"][0], runs["plain"][0])
    taken, refused = runs["rich-cache"][1], runs["rich-cache-micro"][1]
    print(f"sdxl-sample: {size}x{size} from default_sample_size "
          f"{xl.default_sample_size} x {xl.vae_scale_factor}, {calls} UNet "
          f"calls a pass (Euler); sample(run_rich_text=False) equal to "
          f"produce_attn_maps: {same['produce_attn_maps']}, the rich branch "
          f"to prompt_to_img: {same['prompt_to_img']}; {SDXL_MICRO} against "
          f"the default time ids: mean |image difference| {gap:.4f} uint8 "
          f"steps; refer cache of steps {list(steps)} under the default time "
          f"ids: UNet batches {_runs(taken)} under them, {_runs(refused)} "
          f"under {SDXL_MICRO}; seconds "
          + json.dumps({k: round(v[2], 3) for k, v in runs.items()}),
          flush=True)
    for tag, (img, _, _) in runs.items():
        f = img.astype(np.float64)
        if img.shape != (1, size, size, 3) or not np.isfinite(f).all() or (
                f.std() == 0):
            raise AssertionError(f"sdxl-sample {tag}: image {img.shape}")
    if not all(same.values()) or gap == 0.0:
        raise AssertionError("sdxl-sample: the entries disagree or the "
                             "micro-conditioning did not reach the image")
    if (taken != [REGIONS + 2] * calls or refused[0] != REGIONS + 4
            or cache is None):
        raise AssertionError("sdxl-sample: the refer cache was not taken "
                             "under its time ids, or taken under others")
    _record_phase(rows, "sdxl-sample", by_shape)


def sdxl_breakdown_phase(xl) -> None:
    """Per-call times at 1024^2 (CUDA events): the UNet at B=2 and R+2,
    one colour-guided step exact (fp32 decode and its gradient, TF32 off)
    with its peak device memory, and pooled by 2, the final decode; then
    one B=2 forward under ``torch.profiler``."""
    import numpy as np
    import torch

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
        _profile_line("sdxl unet B=2",
                      lambda: xl._fwd(x, 500, emb, pooled, tid),
                      out["unet_b2_ms"])


def _bench_launches(kind: str, calls: int, keys: int, agg_start: int) -> dict:
    """The launches by shape of one run of the throughput program with
    ``calls`` UNet calls a pass and ``keys`` key steps in the rich pass
    (all of them in the exact configuration). SD-1.5: 5 K1 and 5 K2 a
    forward, the plain pass's last step capturing its 32^2 layers (K3);
    off a key step the two down-path layers of each level do not run.
    SDXL: 10 K1 at 64^2 and 60 at 32^2 a forward, the 32^2 ones taking K3
    on the plain pass's steps from ``agg_start`` on; off a key step the
    down path's 4 and 20 do not run."""
    rb, skip = BENCH_RICH, calls - keys
    if kind == "sd15":
        want = _sd_launches([2] * calls, captures=1)
        for key in (("full", rb, 8, 4096, 4096, 48),
                    ("full_t", rb, 8, 1024, 1024, 80)):
            want[key] = 5 * keys + 3 * skip
        return want
    return {("full", 2, 10, 4096, 4096, 64): calls * SDXL_SELF_64,
            ("full", 2, 20, 1024, 1024, 64): agg_start * SDXL_SELF_32,
            ("avgp", 2, 20, 1024, 1024, 64): (calls - agg_start)
            * SDXL_SELF_32,
            ("full", rb, 10, 4096, 4096, 64): keys * SDXL_SELF_64
            + skip * (SDXL_SELF_64 - SDXL_DOWN_64),
            ("full", rb, 20, 1024, 1024, 64): keys * SDXL_SELF_32
            + skip * (SDXL_SELF_32 - SDXL_DOWN_32)}


def bench_phase(rows: dict) -> None:
    """The port's throughput program (``rich_text_to_image_tpu_torch/
    bench.py``): its ``_run`` for SD-1.5 at 512^2 and SDXL at 1024^2, turbo
    then exact, 50 steps uncut, each model built once by the CLI's
    ``build_model`` and handed to both configurations. Asserts a positive
    rate and an MFU, finite non-constant images, the rich batch and each
    kernel's launches of one timed run by shape against the step
    structure; prints each configuration's numbers and each ``_emit``
    record, and fills the ``bench_shapes`` entries' launches."""
    import io

    import torch

    from rich_text_to_image_tpu_torch import bench as B
    from rich_text_to_image_tpu_torch.cli.sample import (build_model,
                                                         make_parser)
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.pipelines.base import encoder_key_gates

    total: dict = {}
    for kind, metric in B.METRICS:
        args = make_parser().parse_args(B._argv(kind, True)[0])
        t0 = time.time()
        model = build_model(args)
        torch.cuda.synchronize()
        print(f"bench: {kind} built by cli/sample.build_model in "
              f"{time.time() - t0:.1f} s", flush=True)
        calls = model.scheduler.plan(args.sample_steps).num_steps
        res, by_shape = {}, {}
        for exact in (False, True):
            cfg = "exact" if exact else "turbo"
            detail = {}
            rate, mfu = B._run(kind, exact, model=model, detail=detail)
            keys = int(encoder_key_gates(calls, 1 if exact else 2,
                                         "early").sum())
            _expect_shapes(f"bench {kind} {cfg}", detail["launches"],
                           _bench_launches(kind, calls, keys,
                                           model.agg_start_step))
            if len(model.masks) != BENCH_RICH - 1:
                raise AssertionError(f"bench {kind} {cfg}: "
                                     f"{len(model.masks)} masks, expected "
                                     f"R+1 = {BENCH_RICH - 1}")
            size = B._argv(kind, exact)[1]
            for img in detail["images"]:
                _check_images(f"bench {kind} {cfg}", img, 1, size)
            if not rate > 0 or mfu is None:
                raise AssertionError(f"bench {kind} {cfg}: rate {rate}, mfu "
                                     f"{mfu}")
            for k, n in detail["launches"].items():
                by_shape[k] = by_shape.get(k, 0) + n
            peak = detail["peak_bytes"]
            print(f"bench: {kind} {cfg}: {rate:.4f} images a minute, mfu "
                  f"{mfu:.4f} ({detail['flops']:.6e} FLOPs); runs "
                  f"{[round(t, 4) for t in detail['times']]} s; stage "
                  f"seconds of the best {json.dumps(detail['seconds'])}; "
                  f"peak device memory {peak} bytes ({peak / 2**30:.2f} "
                  f"GiB); refer cache {detail['cache_slots']} slot(s), "
                  f"{detail['cache_bytes']} bytes; {keys} key steps of "
                  f"{calls} UNet calls a pass, rich batch {BENCH_RICH}; "
                  f"launches of one run as derived "
                  + json.dumps(_keyed(detail["launches"]))
                  + f" on {_smi()}", flush=True)
            res[exact] = (rate, mfu)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            B._emit(metric, kind, res[False], res[True])
        print("bench: record " + buf.getvalue().strip(), flush=True)
        _record_phase(rows, f"bench-{kind}", by_shape)
        for k, n in by_shape.items():
            total[k] = total.get(k, 0) + n
        del model
        gc.collect()
        torch.cuda.empty_cache()
    buckets = {row: bucket for bucket, row in BUCKET_ROW.items()}
    for name, row in rows.items():
        for entry in row.get("bench_shapes", []):
            b, h, s, d = entry["shape"]
            entry["launches"] = total.get(
                (buckets[name], b, h, s, s, A._padded(d)), 0)
            if not entry["launches"]:
                raise AssertionError(f"bench: {name} launched no time at "
                                     f"{entry['shape']}")


# the row of the kernels line that each launch bucket counts for
BUCKET_ROW = {"full": "K1_attn_fwd_64x64", "full_t": "K2_attn_fwd_32x32",
              "avgp": "K3_attn_avgp_32x32", "stream": "K4_attn_stream_96x96"}


def _record_phase(rows: dict, tag: str, by_shape: dict) -> None:
    """Adds a phase's launches by shape to the rows of the kernels line:
    ``phase_launches[tag]["B,H,Sq,Skv,head dim"]``."""
    for (bucket, *shape), n in sorted(by_shape.items()):
        rows[BUCKET_ROW[bucket]].setdefault("phase_launches", {}).setdefault(
            tag, {})[",".join(map(str, shape))] = n


def _keyed(by_shape: dict) -> dict:
    return {",".join(map(str, k)): n for k, n in sorted(by_shape.items())}


def grad_guard_phase() -> None:
    """Each CUDA kernel wrapper, given inputs that require a gradient with
    grad mode on, must raise (the kernels have no backward pass) and launch
    nothing; under ``torch.no_grad()`` the same calls launch. A wrapper that
    returns a tensor cut off from the graph fails the run."""
    import torch

    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.ops import conv as CV

    q, k, v = (t.detach().requires_grad_() for t in _qkv(2, 8, 1024, 80, 7))
    lse = torch.zeros((2, 8, 1024), device="cuda")
    x, w, bias = _conv_inputs(2, 64, 64, 320, 320, 7)
    x = x.detach().requires_grad_()
    calls = {
        "flash_attention": lambda: A.flash_attention(q, k, v),
        "flash_attention_avg_probs":
            lambda: A.flash_attention_avg_probs(q, k, v),
        "flash_attention_lse": lambda: A.flash_attention_lse(q, k, v),
        "avg_probs_from_lse": lambda: A.avg_probs_from_lse(q, k, lse),
        "conv3x3": lambda: CV.conv3x3(x, w, bias),
    }
    A.reset_launches()
    CV.reset_launches()
    for name, fn in calls.items():
        try:
            fn()
        except RuntimeError as e:
            if not str(e).startswith(f"{name}:") or "no backward" not in str(e):
                raise AssertionError(f"grad-guard: {name} raised another "
                                     f"error: {e}") from e
        else:
            raise AssertionError(f"grad-guard: {name} returned under "
                                 "autograd, with no gradient to give")
    launched = {**A.LAUNCHES, **CV.LAUNCHES}
    if any(launched.values()):
        raise AssertionError(f"grad-guard: launched {launched}")
    with torch.no_grad():
        for fn in calls.values():
            fn()
    torch.cuda.synchronize()
    launched = {**A.LAUNCHES, **CV.LAUNCHES}
    print(f"grad-guard: {len(calls)} wrappers raise under autograd "
          f"({', '.join(calls)}) and launch nothing; under no_grad they "
          f"launch {launched}", flush=True)
    if launched != {"full": 0, "full_t": 1, "avgp": 2, "stream": 0,
                    "conv3x3": 1}:
        raise AssertionError(f"grad-guard: under no_grad {launched}")


def dual_phase(pipe) -> dict:
    """A full-width SD-1.5 UNet with ``dual_cross_attention`` (the
    Versatile Diffusion dual-guided block: condition lengths 77 and 257,
    routing (1, 0), mix 0.5), drawn on the card; one B=2 forward on a 64^2
    latent and a 334-token context through the kernels (both streams of
    each block: 10 K1 at 64^2 and 10 K2 at 32^2) against the plain
    attention, eps within UNET_RTOL; its time, its device kernels' busy
    time under ``torch.profiler``, and the single-stream UNet's time on the
    same latent and the text rows. Returns the launches by shape."""
    import dataclasses

    import torch

    from rich_text_to_image_tpu_torch import weights
    from rich_text_to_image_tpu_torch.models import config as cfgs
    from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
    from rich_text_to_image_tpu_torch.ops import attention as A

    cfg = dataclasses.replace(cfgs.SD15_UNET, dual_cross_attention=True)
    t0 = time.time()
    with torch.device("meta"):
        unet = UNet2DCondition(cfg)
    unet = weights.random_init_device(
        unet.to(torch.bfloat16).to_empty(device="cuda"), 0).eval()
    unet.requires_grad_(False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in unet.parameters())
    init_s = time.time() - t0
    g = torch.Generator(device="cuda").manual_seed(5)
    lat = torch.randn((1, 64, 64, 4), generator=g, device="cuda")
    x = torch.cat([lat, lat])
    text = pipe.get_text_embeds(["a cat riding a scooter"], [""])
    image = torch.randn((2, DUAL_CONTEXT[1], text.shape[-1]), generator=g,
                        device="cuda")
    ctx = torch.cat([text, image], dim=1)

    def plain():
        with A.plain_attention():
            return unet(x, 500, ctx)

    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launches()
        eps_k, _ = unet(x, 500, ctx)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        by_shape = dict(A.LAUNCHES_BY_SHAPE)
        eps_p, _ = plain()
        ms = _time_ms(lambda: unet(x, 500, ctx), 3)
        plain_ms = _time_ms(plain, 2)
        n_kernels, busy = _device_busy(lambda: unet(x, 500, ctx))
        single_ms = _time_ms(lambda: pipe.unet(x, 500, text), 3)
    _expect_shapes("dual", by_shape, {("full", 2, 8, 4096, 4096, 48): 10,
                                      ("full_t", 2, 8, 1024, 1024, 80): 10})
    err = ((eps_k.float() - eps_p.float()).abs().max()
           / eps_p.float().abs().max()).item()
    fin = bool(torch.isfinite(eps_k).all())
    print(f"dual: UNet with dual_cross_attention, {n_params} parameters "
          f"drawn on the card in {init_s:.1f} s; B=2 forward on a 64^2 "
          f"latent, context {sum(DUAL_CONTEXT)} tokens: eps rel max|d|="
          f"{err:.3e} against the plain attention (tol {UNET_RTOL}), "
          f"finite={fin}; launches by shape {json.dumps(_keyed(by_shape))}; "
          f"forward {ms:.3f} ms (plain attention {plain_ms:.3f} ms), "
          f"{n_kernels} device kernels busy {busy:.3f} ms of it (idle share "
          f"{1 - busy / ms:.3f}); the single-stream UNet's forward on the "
          f"text rows {single_ms:.3f} ms; peak device memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB) on {_smi()}", flush=True)
    if not fin or err > UNET_RTOL:
        raise AssertionError("dual: the UNet through the kernels disagrees "
                             "with the plain attention")
    del unet
    gc.collect()
    torch.cuda.empty_cache()
    return by_shape


def ckpt_phase(pipe, path: str) -> None:
    """``save_pipeline`` of the SD pipeline (UNet bfloat16, VAE and text
    tower float32) into ``path``; the bytes and the seconds."""
    import torch

    from rich_text_to_image_tpu_torch.models.checkpoint import save_pipeline

    torch.cuda.synchronize()
    t0 = time.time()
    nbytes = save_pipeline(path, pipe)
    secs = time.time() - t0
    files = {f: os.path.getsize(os.path.join(path, "params", f))
             for f in sorted(os.listdir(os.path.join(path, "params")))}
    print(f"ckpt: save_pipeline wrote {nbytes} bytes ({nbytes / 2**30:.3f} "
          f"GiB) in {secs:.2f} s ({nbytes / secs / 1e9:.2f} GB/s): "
          f"{json.dumps(files)}", flush=True)
    if nbytes != sum(files.values()):
        raise AssertionError("ckpt: the bytes written are not the files'")


def _lora_dicts(pipe, seed: int) -> tuple:
    """A rank-LORA_RANK LoRA from ``seed`` for every UNet attention
    projection and every text-encoder q/k/v/out_proj, in diffusers' names
    (numpy float32)."""
    import numpy as np

    from rich_text_to_image_tpu_torch.models import convert

    rng = np.random.default_rng(seed)

    def pair(w):
        d_out, d_in = w.shape
        down = rng.standard_normal((LORA_RANK, d_in), np.float32) / np.sqrt(
            np.float32(d_in))
        up = rng.standard_normal((d_out, LORA_RANK), np.float32) * np.float32(
            LORA_UP_STD / np.sqrt(LORA_RANK))
        return down, up

    unet, text = {}, {}
    for key, w in pipe.unet.state_dict().items():
        m = convert._UNET_KEY.match(key)
        if m:
            stem = f"{m.group(1)}.processor.{convert._UNET_PROJ[m.group(2)]}"
            unet[f"{stem}.down.weight"], unet[f"{stem}.up.weight"] = pair(w)
    for key, w in pipe.text_encoder.state_dict().items():
        if key.endswith("_proj.weight"):
            stem = key.removesuffix(".weight") + ".lora_linear_layer"
            text[f"{stem}.down.weight"], text[f"{stem}.up.weight"] = pair(w)
    return unet, text


def lora_phase(pipe, out_dir: str, ckpt: str, rows: dict) -> None:
    """The 512^2 request of ``e2e:`` at 4 steps, with a seeded LoRA merged
    into the UNet (128 projections: q/k/v/out of attn1 and attn2 in its 16
    transformer blocks) and the text encoder (48: q/k/v/out_proj of its 12
    layers): at scale 0 the image must be the base run's exactly, at scale
    1 it must move, with the same launches; then ``load_params`` of the
    ``ckpt:`` checkpoint restores the base weights and the request must
    give the base image again, within 0.5 uint8 steps. cuDNN runs its
    deterministic algorithms here (the colour guidance's VAE gradient), so
    that equal weights give equal images. The checkpoint is deleted at the
    end."""
    import shutil

    import torch

    from rich_text_to_image_tpu_torch.models.checkpoint import load_params
    from rich_text_to_image_tpu_torch.models.convert import (apply_lora_text,
                                                            apply_lora_unet)
    from rich_text_to_image_tpu_torch.models.unet import Attention
    from rich_text_to_image_tpu_torch.ops import attention as A

    lora_u, lora_t = _lora_dicts(pipe, 8)
    base_u = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    base_t = {k: v.clone() for k, v in pipe.text_encoder.state_dict().items()}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs, counts = {}, {}

    def run(tag):
        launches, _, _, rich, _ = sample_phase(
            tag, pipe, os.path.join(out_dir, tag), 512, STEPS_SHORT,
            agg_start=1)
        runs[tag] = (launches, dict(A.LAUNCHES_BY_SHAPE), rich)

    try:
        run("lora-base")
        for scale in (0.0, 1.0):
            u = apply_lora_unet(base_u, lora_u, scale)
            t = apply_lora_text(base_t, lora_t, scale)
            counts[scale] = (sum(u[k] is not base_u[k] for k in u),
                             sum(t[k] is not base_t[k] for k in t))
            pipe.unet.load_state_dict(u, strict=True)
            pipe.text_encoder.load_state_dict(t, strict=True)
            run(f"lora-scale{scale:g}")
        t0 = time.time()
        trees = load_params(ckpt, device=pipe.device)
        for tree, mod in (("unet", pipe.unet), ("vae", pipe.vae),
                          ("text", pipe.text_encoder)):
            mod.load_state_dict(trees[tree], strict=True)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        restored = all(torch.equal(a, base_u[k]) for k, a in
                       pipe.unet.state_dict().items())
        run("lora-restored")
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(ckpt, ignore_errors=True)
    base = runs["lora-base"]
    d0 = _image_diff(runs["lora-scale0"][2], base[2])
    d1 = _image_diff(runs["lora-scale1"][2], base[2])
    dr = _image_diff(runs["lora-restored"][2], base[2])
    print(f"lora: rank {LORA_RANK}, merged {counts[1.0][0]} UNet and "
          f"{counts[1.0][1]} text-encoder projections; mean |image "
          f"difference| against the base run: scale 0 {d0:.4f} (must be 0), "
          f"scale 1 {d1:.4f}, restored from the checkpoint {dr:.4f} (bound "
          f"0.5); load_params and load_state_dict {load_s:.2f} s, UNet "
          f"weights equal to the base's: {restored}; launches "
          f"{runs['lora-scale1'][0]} as the base run's", flush=True)
    # every projection: 4 a self- or cross-attention layer of the UNet, 4 a
    # layer of the text encoder
    want = (4 * sum(isinstance(m, Attention) for m in pipe.unet.modules()),
            4 * len(pipe.text_encoder.text_model.encoder.layers))
    if counts[0.0] != want or counts[1.0] != want:
        raise AssertionError(f"lora: merged counts {counts}, expected {want}")
    if d0 != 0.0 or d1 == 0.0 or dr > 0.5 or not restored:
        raise AssertionError("lora: the images do not move as they must")
    for tag in ("lora-scale0", "lora-scale1", "lora-restored"):
        if runs[tag][:2] != base[:2]:
            raise AssertionError(f"{tag}: launches {runs[tag][:2]}, the base "
                                 f"run's {base[:2]}")
    _record_phase(rows, "lora", runs["lora-scale1"][1])
    _record_phase(rows, "ckpt", runs["lora-restored"][1])


def mesh1_phase(pipe, out_dir: str) -> tuple:
    """The 512^2 4-step refer-precompute request through the CLI's code
    path without a mesh, then with ``--mesh 1`` in a world of one process
    (nccl): the gathers over one rank change nothing, so the rich image and
    the launches by shape must be equal to the bit (cuDNN deterministic, as
    in ``lora:``). Returns (the launches by shape of the run without a
    mesh, the path of its rich PNG) for ``mesh2:``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.parallel.mesh import apply_mesh_arg

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for tag in ("mesh1-off", "mesh1"):
            if tag == "mesh1":
                apply_mesh_arg(pipe, "1")
                backend, shape = dist.get_backend(), dict(pipe.mesh.shape)
            try:
                _, secs, _, rich, _ = sample_phase(
                    tag, pipe, os.path.join(out_dir, tag), 512, STEPS_SHORT,
                    MESH_ARGV, agg_start=1)
            finally:
                if tag == "mesh1":
                    pipe.mesh = None
                    dist.destroy_process_group()
            runs[tag] = (rich, dict(A.LAUNCHES_BY_SHAPE), secs)
    finally:
        torch.backends.cudnn.deterministic = det
    ref, ref_shapes, _ = runs["mesh1-off"]
    got, shapes, secs = runs["mesh1"]
    equal = bool(np.array_equal(got, ref))
    print(f"mesh1: --mesh 1 in a world of one ({backend}), mesh {shape}: rich "
          f"image equal to the run without a mesh: {equal}; launches by "
          f"shape equal: {shapes == ref_shapes}; stage seconds "
          f"{json.dumps(secs)}", flush=True)
    if not equal or shapes != ref_shapes:
        raise AssertionError("mesh1: a mesh of one rank changed the run")
    return ref_shapes, os.path.join(out_dir, "mesh1-off", "seed6_rich.png")


def _train_batch():
    """The training phases' batch: latents [TRAIN_B,64,64,4] and text rows
    [TRAIN_B,77,768], from a seeded generator on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(11)
    return (torch.randn((TRAIN_B, 64, 64, 4), generator=g, device="cuda"),
            torch.randn((TRAIN_B, 77, 768), generator=g, device="cuda"))


def _train_steps(mesh, steps: int, lr: float = TRAIN_LR) -> tuple:
    """``steps`` AdamW steps of ``make_train_step`` (SD-1.5, bfloat16
    autocast, float32 parameters drawn on the card from seed 0) on the
    training batch, every step with the same draw of t and the noise (seed
    100), so that the losses are of one objective: (losses, ms per step,
    peak device bytes, launches of the hand-written kernels by name and by
    shape)."""
    import torch

    from rich_text_to_image_tpu_torch.models import config as cfgs
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.ops import conv as CV
    from rich_text_to_image_tpu_torch.training.train_step import (
        make_train_step)

    init_fn, step = make_train_step(cfgs.SD15_UNET, learning_rate=lr,
                                    dtype=torch.bfloat16, mesh=mesh,
                                    device="cuda")
    state = init_fn(seed=0)
    latents, ehs = _train_batch()
    A.reset_launches()
    CV.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(steps):
        gen = torch.Generator(device="cuda").manual_seed(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, latents, ehs, gen)
        losses.append(float(loss))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    launches = ({**A.LAUNCHES, **CV.LAUNCHES}, dict(A.LAUNCHES_BY_SHAPE))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return losses, ms, peak, launches


def train_phase() -> float:
    """Three steps of the training step on one card: the loss must be
    finite and fall, and no hand-written kernel may launch (attention runs
    through the plain ops under autograd). Returns the first step's loss,
    which ``mesh2:``'s dp = 2 step must match."""
    import numpy as np

    losses, ms, peak, (launches, _) = _train_steps(None, TRAIN_STEPS)
    print(f"train: SD-1.5 UNet at full width, float32 parameters, bfloat16 "
          f"autocast, latents [{TRAIN_B},64,64,4], AdamW lr {TRAIN_LR}: "
          f"losses {losses}, ms per step {[round(m, 1) for m in ms]} (the "
          f"first with the optimizer's state made), peak device memory "
          f"{peak} bytes ({peak / 2**30:.2f} GiB), hand-written kernel "
          f"launches {launches}", flush=True)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses} are not finite and "
                             "falling")
    if any(launches.values()):
        raise AssertionError("train: a hand-written kernel launched under "
                             "autograd")
    return losses[0]


def _mesh2_rank(rank: int, store: str, out_dir: str, spec: dict) -> None:
    """One of two ranks on the one card, in a gloo group (nccl refuses two
    ranks on one device; the collectives move the card's tensors through
    host memory): the mesh1 request at dp = 2 and at tp = 2, the colour
    bench's batched item at dp = 2, one SDXL UNet forward at tp = 2, then
    one training step at dp = 2. Its results go to
    ``out_dir/rank<r>.json``."""
    sys.path.insert(0, spec["root"])
    import numpy as np
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2)
    try:
        from rich_text_to_image_tpu_torch.evaluation import (
            benchmark_color as BC)
        from rich_text_to_image_tpu_torch.ops import attention as A
        from rich_text_to_image_tpu_torch.ops import build
        from rich_text_to_image_tpu_torch.parallel.mesh import mesh_from_spec
        from rich_text_to_image_tpu_torch.pipelines.region_sd import (
            RegionDiffusion)
        from rich_text_to_image_tpu_torch.utils.png import read_png

        build.library()  # the parent built it: loaded, not compiled
        ref = read_png(spec["ref_png"])[None]
        res = {"backend": dist.get_backend()}
        for tag, mesh in (("mesh2-dp", "2,1"), ("mesh2-tp", "1,2")):
            t0 = time.time()
            pipe = RegionDiffusion.random_init(seed=0, device="cuda",
                                               mesh=mesh_from_spec(mesh))
            init_s = time.time() - t0
            (_, secs, _, rich, _), seen = _batches(pipe, lambda: sample_phase(
                f"{tag} rank {rank}", pipe,
                os.path.join(out_dir, tag, f"rank{rank}"), 512, STEPS_SHORT,
                MESH_ARGV, agg_start=1))
            res[tag] = {"by_shape": _keyed(A.LAUNCHES_BY_SHAPE),
                        "seen": seen, "seconds": secs, "init_s": init_s,
                        "image_diff": _image_diff(rich, ref),
                        "mesh": dict(pipe.mesh.shape)}
            if tag == "mesh2-tp":
                res["gathers"] = _tp_layouts(pipe)
            if tag == "mesh2-dp":
                path = os.path.join(out_dir, "colorbench")
                args = BC.make_parser().parse_args(
                    ["--steps", str(STEPS_SHORT), "--num_seeds", "1",
                     "--limit", "4", "--batch_colors", "4", "--save_img",
                     "--save_path", path, "--mesh", mesh])
                with _agg_start(pipe, 1):
                    (summary, seen), secs = _timed(lambda: _batches(
                        pipe, lambda: BC.run(args, model=pipe)))
                res["colorbench"] = {"seen": seen, "seconds": secs,
                                     "n": summary["ours_min"]["n"]}
            del pipe
            gc.collect()
            torch.cuda.empty_cache()
        res["sdxl-tp"] = _sdxl_tp2_forward(mesh_from_spec("1,2"))
        losses, ms, peak, (launches, _) = _train_steps(
            mesh_from_spec("2,1"), 1)
        res["train"] = {"losses": losses, "ms": ms, "peak": peak,
                        "launches": launches,
                        "finite": bool(np.isfinite(losses).all())}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _sdxl_tp2_forward(mesh) -> dict:
    """One full-width SDXL UNet forward at B=2 and a 128^2 latent (1024^2)
    on this rank: whole, then with its weights sharded over the tp = 2
    ``mesh`` (attention on the rank's own heads), the same weights drawn on
    the card from seed 0 on each rank: K1 at [2,5,4096,64] and
    [2,10,1024,64] and no other launch, counted by ``LAUNCHES_BY_SHAPE``;
    eps of the two within UNET_RTOL of max|eps|; the tp forward's ms on the
    host clock (kernels warm from the whole one) and its gathers."""
    import torch

    from rich_text_to_image_tpu_torch.models import config as cfgs
    from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.parallel import mesh as M
    from rich_text_to_image_tpu_torch.pipelines.region_sdxl import _on_device

    cfg = cfgs.SDXL_UNET  # RegionDiffusionXL.random_init(seed=0)'s UNet
    unet = _on_device(lambda: UNet2DCondition(cfg), torch.device("cuda"),
                      torch.bfloat16, 0).eval().requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((2, 128, 128, 4), generator=g, device="cuda")
    emb = torch.randn((2, 77, cfg.cross_attention_dim), generator=g,
                      device="cuda")
    pooled_dim = (cfg.projection_class_embeddings_input_dim
                  - 6 * cfg.addition_time_embed_dim)
    added = {"text_embeds": torch.randn((2, pooled_dim), generator=g,
                                        device="cuda"),
             "time_ids": torch.tensor([[SDXL_SIZE, SDXL_SIZE, 0, 0,
                                        SDXL_SIZE, SDXL_SIZE]] * 2,
                                      dtype=torch.float32, device="cuda")}
    with torch.no_grad():
        eps_whole, _ = unet(x, 500, emb, added_cond=added)
        M.shard_params(unet, mesh)
        torch.cuda.synchronize()
        A.reset_launches()
        M.reset_gathers()
        (eps_tp, _), secs = _timed(
            lambda: unet(x, 500, emb, added_cond=added))
    ref = eps_whole.float()
    out = {"by_shape": _keyed(A.LAUNCHES_BY_SHAPE), "gathers": dict(M.GATHERS),
           "ms": secs * 1e3,
           "eps_rel": ((eps_tp.float() - ref).abs().max()
                       / ref.abs().max()).item(),
           "finite": bool(torch.isfinite(eps_tp).all())}
    del unet, eps_whole, eps_tp, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _every_layer_gathered(unet):
    """While open, the tp UNet runs its attention on every head: the
    ``to_q``, ``to_k`` and ``to_v`` of each block on its own heads take the
    gather after the layer that the other sharded layers have, and the
    block sees whole q, k and v (the layout without
    ``parallel/mesh.heads_local``)."""
    from rich_text_to_image_tpu_torch.models.unet import Attention
    from rich_text_to_image_tpu_torch.parallel.tp import gather_channels

    hooks, saved = [], []
    for m in list(unet.modules()):
        if isinstance(m, Attention) and m.tp_local() is not None:
            rank, _, group = m.tp_local()
            for lin in (m.to_q, m.to_k, m.to_v):
                saved.append((lin, lin.tp_local))
                del lin.tp_local
                hooks.append(lin.register_forward_hook(
                    lambda mod, args, y, g=group, r=rank:
                    gather_channels(y, -1, g, r)))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        for lin, loc in saved:
            lin.tp_local = loc


def _tp_layouts(pipe) -> dict:
    """One B=2 forward of the tp = 2 UNet at a 64^2 latent with the
    attention on each rank's own heads, and with every sharded layer's
    output gathered (``_every_layer_gathered``): the gathers each moves
    (``parallel/mesh.GATHERS``), its ms on the host clock (the collectives
    run through host memory), the blocks on their own heads, and eps of
    the two layouts against each other."""
    import torch

    from rich_text_to_image_tpu_torch.models.unet import Attention
    from rich_text_to_image_tpu_torch.parallel import mesh as M

    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((2, 64, 64, 4), generator=g, device="cuda")
    emb = pipe.get_text_embeds(["a red scooter on a street"], [""])
    local = sum(isinstance(m, Attention) and m.tp_local() is not None
                for m in pipe.unet.modules())
    out, eps = {"local_attention": local}, {}
    for tag in ("local", "gathered"):
        with contextlib.ExitStack() as stack, torch.no_grad():
            if tag == "gathered":
                stack.enter_context(_every_layer_gathered(pipe.unet))
            pipe.unet(x, 500, emb)  # warm
            torch.cuda.synchronize()
            M.reset_gathers()
            (eps[tag], _), secs = _timed(lambda: pipe.unet(x, 500, emb))
        out[tag] = {**M.GATHERS, "ms": secs * 1e3}
    out["eps_rel"] = ((eps["local"].float() - eps["gathered"].float()).abs()
                      .max() / eps["gathered"].float().abs().max()).item()
    return out


def _local_heads_shapes(by_shape: dict, tp: int) -> dict:
    """Launches by shape of a one-rank run as a tp rank makes them: the
    kernels of every layer at ``heads // tp`` heads, the capture's at
    every head (SD-1.5's 8 heads divide by 2 and 4 at every level)."""
    out: dict = {}
    for (bucket, b, h, *rest), n in by_shape.items():
        key = (bucket, b, h if bucket == "avgp" else h // tp, *rest)
        out[key] = out.get(key, 0) + n
    return out


def _shape_key(key: str) -> tuple:
    bucket, *dims = key.split(",")
    return (bucket, *map(int, dims))


def mesh2_phase(out_dir: str, ref_png: str, ref_shapes: dict,
                bench_dir: str, train_loss: float, rows: dict) -> None:
    """Two ranks spawned on the one card (``_mesh2_rank``): at dp = 2 each
    rank's K1/K2 batches halve (plain pass B = 1, its capture's K3 at
    B = 1, rich pass B = 2), at tp = 2 each launches the single-rank run's
    kernels at half the heads (each rank's own), its K3 at every head; the
    gathers of a UNet forward on own heads and with every layer gathered;
    the images within EVAL_MAX_DIFF of the single-rank image; the colour
    bench's batched item at dp = 2 within EVAL_MAX_DIFF of ``colorbench:``'s
    images; the full-width SDXL UNet at tp = 2 launching K1 at its local
    heads only ([2,5,4096,64] and [2,10,1024,64]), its eps within
    UNET_RTOL of the rank's whole UNet; the dp = 2 training step's loss
    within TRAIN_LOSS_RTOL of one rank's first step."""
    import shutil

    import torch.multiprocessing as mp

    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    store = os.path.abspath(os.path.join(out_dir, "store"))  # file:// URL
    spec = {"root": os.path.dirname(os.path.abspath(__file__)),
            "ref_png": ref_png}
    t0 = time.time()
    ctx = mp.start_processes(_mesh2_rank, args=(store, out_dir, spec),
                             nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.time() - t0 > MESH2_TIMEOUT:
                raise AssertionError(f"mesh2: the two ranks took more than "
                                     f"{MESH2_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    wall = time.time() - t0
    res = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    from rich_text_to_image_tpu_torch.schedulers.pndm import PNDMScheduler

    calls = PNDMScheduler().plan(STEPS_SHORT).num_steps
    want = {"mesh2-dp": _sd_launches([1] * calls + [2] * calls, captures=1,
                                     capture_b=1),
            "mesh2-tp": _local_heads_shapes(ref_shapes, 2)}
    by_tag = {}
    for tag, what in (("mesh2-dp", "dp = 2: each rank's batches halve"),
                      ("mesh2-tp", "tp = 2: each rank launches the "
                                   "single-rank run's kernels at its own 4 "
                                   "heads, K3 at all 8")):
        got = [{_shape_key(k): n for k, n in r[tag]["by_shape"].items()}
               for r in res]
        diffs = [r[tag]["image_diff"] for r in res]
        print(f"mesh2: {what}; mesh {res[0][tag]['mesh']} ({res[0]['backend']}"
              f", 2 ranks on one card); UNet batches rank 0 "
              f"{_runs(res[0][tag]['seen'])}, rank 1 "
              f"{_runs(res[1][tag]['seen'])}; launches by (bucket, B, H, Sq, "
              f"Skv, head dim) rank 0 {json.dumps(res[0][tag]['by_shape'])}, "
              f"rank 1 {json.dumps(res[1][tag]['by_shape'])}; mean |image "
              f"difference| against the single-rank image {diffs} (bound "
              f"{EVAL_MAX_DIFF}); stage seconds rank 0 "
              f"{json.dumps(res[0][tag]['seconds'])}; pipeline init "
              f"{[round(r[tag]['init_s'], 1) for r in res]} s", flush=True)
        for g in got:
            _expect_shapes(tag, g, want[tag])
        if max(diffs) > EVAL_MAX_DIFF:
            raise AssertionError(f"{tag}: images too far from the "
                                 f"single-rank one: {diffs}")
        _record_phase(rows, tag, got[0])
        by_tag[tag] = got[0]
    xl = [r["sdxl-tp"] for r in res]
    xl_shapes = [{_shape_key(k): n for k, n in x["by_shape"].items()}
                 for x in xl]
    print(f"mesh2: SDXL UNet at full width, tp = 2, attention on each "
          f"rank's own heads, one B=2 forward at 128^2 (1024^2): launches by "
          f"(bucket, B, H, Sq, Skv, head dim) rank 0 "
          f"{json.dumps(xl[0]['by_shape'])}, rank 1 "
          f"{json.dumps(xl[1]['by_shape'])}; gathers rank 0 "
          f"{json.dumps(xl[0]['gathers'])}, rank 1 "
          f"{json.dumps(xl[1]['gathers'])}; ms "
          f"{[round(x['ms'], 1) for x in xl]}; eps against the rank's "
          f"whole UNet rel max|d| "
          f"{[round(x['eps_rel'], 6) for x in xl]} (tol {UNET_RTOL}); on "
          f"{_smi()}", flush=True)
    for x, got in zip(xl, xl_shapes):
        _expect_shapes("mesh2-sdxl-tp", got, {
            ("full", 2, 5, 4096, 4096, 64): SDXL_SELF_64,
            ("full", 2, 10, 1024, 1024, 64): SDXL_SELF_32})
        if not x["finite"] or x["eps_rel"] > UNET_RTOL:
            raise AssertionError(f"mesh2: the SDXL tp = 2 forward disagrees "
                                 f"with the whole UNet: {x}")
    _record_phase(rows, "mesh2-sdxl-tp", xl_shapes[0])
    from rich_text_to_image_tpu_torch.ops.attention import _padded

    bucket_of = {row: bucket for bucket, row in BUCKET_ROW.items()}
    local = {**by_tag["mesh2-tp"], **xl_shapes[0]}
    for name, row in rows.items():
        for e in row.get("tp2_local", []):  # launches on mesh2's rank 0
            b, h, sq, d = e["shape"]
            e["launches"] = local.get(
                (bucket_of[name], b, h, sq, sq, _padded(d)), 0)
    gl = [r["gathers"] for r in res]
    n_attn = gl[0]["local_attention"]
    print(f"mesh2: tp = 2 gathers of one UNet forward, B=2 at 64^2, on "
          f"{n_attn} attention blocks: on own heads rank 0 "
          f"{json.dumps(gl[0]['local'])}, rank 1 {json.dumps(gl[1]['local'])}"
          f"; every layer's output gathered rank 0 "
          f"{json.dumps(gl[0]['gathered'])}, rank 1 "
          f"{json.dumps(gl[1]['gathered'])}; eps of the two layouts rel "
          f"max|d| {[round(g['eps_rel'], 6) for g in gl]} (tol {UNET_RTOL})",
          flush=True)
    for g in gl:
        if (n_attn != 32 or g["gathered"]["calls"] - g["local"]["calls"]
                != 2 * n_attn or g["eps_rel"] > UNET_RTOL):
            raise AssertionError(f"mesh2: the tp = 2 layouts disagree: {g}")
    means, maxes = _saved_diffs("mesh2-colorbench",
                                os.path.join(out_dir, "colorbench"),
                                bench_dir)
    cb = res[0]["colorbench"]
    print(f"mesh2: colour bench --mesh 2,1, one batched item of 4 colours: "
          f"UNet batches rank 0 {_runs(cb['seen'])}, rank 1 "
          f"{_runs(res[1]['colorbench']['seen'])}; {cb['seconds']:.3f} s; "
          f"saved images against colorbench:'s batched ones, mean |image "
          f"difference| {[round(m, 4) for m in means]} (bound "
          f"{EVAL_MAX_DIFF}), max {maxes} uint8 steps", flush=True)
    if cb["n"] != 4:
        raise AssertionError(f"mesh2: colour bench scored {cb['n']} items")
    tr = [r["train"] for r in res]
    rel = abs(tr[0]["losses"][0] - train_loss) / abs(train_loss)
    print(f"train: dp = 2 on the two ranks of mesh2:, one step: loss "
          f"{[t['losses'][0] for t in tr]} against one rank's {train_loss} "
          f"(relative difference {rel:.3e}, bound {TRAIN_LOSS_RTOL}); ms "
          f"{[round(t['ms'][0], 1) for t in tr]}; peak device memory "
          f"{[t['peak'] for t in tr]} bytes; hand-written kernel launches "
          f"{tr[0]['launches']}; mesh2 wall {wall:.1f} s", flush=True)
    if (not all(t["finite"] for t in tr) or rel > TRAIN_LOSS_RTOL
            or tr[0]["losses"] != tr[1]["losses"]
            or any(any(t["launches"].values()) for t in tr)):
        raise AssertionError("train: the dp = 2 step disagrees")


def _fixture_steering(model, use_guidance: bool) -> float:
    """``tests/test_color_fixture.py``'s ``_run`` through the port's
    ``prompt_to_img``: 12 steps, CFG 8.5, the left half steered toward red;
    the mean RGB distance of the left half of the image from red."""
    import numpy as np

    px = model.unet_cfg.sample_size * model.vae_scale_factor
    h = model.unet_cfg.sample_size
    mask = np.zeros((1, h, h), np.float32)
    mask[:, :, : h // 2] = 1.0
    model.masks = [mask, 1.0 - mask]
    mask_px = np.zeros((1, px, px), np.float32)
    mask_px[:, :, : px // 2] = 1.0
    target = np.asarray([1.0, 0.0, 0.0], np.float32)
    fmt = {"guidance_start_step": 999, "color_guidance_weight": 1.0,
           "target_RGB": [target], "color_obj_atten": [mask_px],
           "color_obj_atten_all": mask}
    img = model.prompt_to_img(
        ["a red square", "a square"], [""], height=px, width=px,
        num_inference_steps=12, guidance_scale=8.5, text_format_dict=fmt,
        use_guidance=use_guidance, seed=7)
    region = img[0][:, : px // 2].astype(np.float32) / 255.0
    return float(np.linalg.norm(region - target, axis=-1).mean())


def _fixture_guided_ms(model) -> dict:
    """Milliseconds of one colour-guided step (the VAE decode of the x0
    prediction and its gradient) at the fixture's size, CUDA events, exact,
    pooled by 2 and in bf16."""
    import numpy as np
    import torch

    h = model.unet_cfg.sample_size
    px = h * model.vae_scale_factor
    g = torch.Generator(device="cuda").manual_seed(2)
    lat = torch.randn((1, h, h, 4), generator=g, device="cuda")
    noise = torch.randn((1, h, h, 4), generator=g, device="cuda")
    fmt = {"color_obj_atten": [(np.random.default_rng(2).random(
               (px, px)) > 0.5).astype(np.float32)],
           "target_RGB": [[1.0, 0.0, 0.0]],
           "color_obj_atten_all": np.ones((h, h), np.float32)}
    out = {}
    for tag, ds, bf16 in (("exact", 1, False), ("gds2", 2, False),
                          ("bf16", 1, True)):
        color = model._color_inputs(fmt, px, px, h, h, ds, bf16, 0.5)
        out[tag] = _time_ms(lambda: model._guided(lat, noise, 0.5, color), 20)
    return out


def _no_launches(tag: str) -> dict:
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.ops import conv as CV

    launches = {**A.LAUNCHES, **CV.LAUNCHES}
    if any(launches.values()) or A.LAUNCHES_BY_SHAPE:
        raise AssertionError(f"{tag}: hand-written kernels launched "
                             f"{launches}: the fixture's attention has "
                             f"64 tokens, under the 512-token threshold")
    return launches


def _fixture_graph_check(out_dir: str, steps: int = 20) -> dict:
    """The trainer's CUDA-graph replay against the same steps run eagerly
    (``WARM_STEPS`` past the run's end): ``steps`` VAE and UNet steps each
    way from the same seeds. The last losses within 1e-3 relative and every
    parameter within one Adam step (the stage's lr) of the eager run's: the
    card's convolution backward is not bitwise reproducible, and Adam
    turns a gradient near zero into a step of about lr either way. Also
    each way's ms a step (host clock; the graphed run's include its warm-up
    and capture)."""
    from rich_text_to_image_tpu_torch.training import color_fixture as CF

    graphed = CF.train(steps, steps, out_dir=os.path.join(out_dir, "graph"),
                       device="cuda")
    warm, CF.WARM_STEPS = CF.WARM_STEPS, steps + 1
    try:
        eager = CF.train(steps, steps, out_dir=os.path.join(out_dir, "eager"),
                         device="cuda")
    finally:
        CF.WARM_STEPS = warm
    out = {}
    for m, lr, loss in (("vae", CF.VAE_LR, "vae_loss"),
                        ("unet", CF.UNET_LR, "dsm_loss")):
        a = getattr(graphed["model"], m).state_dict()
        b = getattr(eager["model"], m).state_dict()
        secs = "vae_seconds" if m == "vae" else "unet_seconds"
        out[m] = {"max_param_diff": max((a[k] - b[k]).abs().max().item()
                                        for k in a),
                  "loss": [graphed[loss], eager[loss]],
                  "ms_a_step": [graphed[secs] / steps * 1e3,
                                eager[secs] / steps * 1e3]}
        rel = abs(graphed[loss] - eager[loss]) / abs(eager[loss])
        if out[m]["max_param_diff"] > lr or rel > 1e-3:
            raise AssertionError(f"fixture-train: the graphed {m} steps "
                                 f"disagree with the eager ones: {out[m]}")
    return out


def fixture_eval_phase(out_dir: str, rows: dict) -> None:
    """The port's colour-fixture evaluation (``evaluation/
    color_fixture_eval.py``) on the committed, JAX-trained fixture: the
    gradient cosines and the colour benchmark at 41 steps, limit 6 x 2
    seeds, exact, pooled by 2 and bf16 guidance. Steering must be real and
    both approximations must beat the plain image; no hand-written kernel
    launches (64 tokens)."""
    from rich_text_to_image_tpu_torch.evaluation import (
        color_fixture_eval as E)
    from rich_text_to_image_tpu_torch.evaluation.fixtures import (
        load_color_fixture)
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.ops import conv as CV

    A.reset_launches()
    CV.reset_launches()
    model = load_color_fixture(device="cuda", agg_start_step=3)
    res = E.run(model, out_dir)
    ms = _fixture_guided_ms(model)
    launches = _no_launches("fixture-eval")
    v, cos = res["verdict"], res["cosines"]
    print(f"fixture-eval: committed fixture (JAX-trained), "
          f"{v['protocol']}: verdict {json.dumps(v)}; grad cosines exact vs "
          f"gds2 min {min(cos):.4f} mean {sum(cos) / len(cos):.4f} over "
          f"{len(cos)}; seconds per configuration "
          f"{json.dumps({k: round(x, 2) for k, x in res['seconds'].items()})}"
          f"; guided step ms at {model.unet_cfg.sample_size}^2 "
          f"{json.dumps({k: round(x, 4) for k, x in ms.items()})}; "
          f"hand-written launches {launches}; on {_smi()}", flush=True)
    if not (v["steering_real"] and v["gds2_ours_min"] < v["plain_min"]
            and v["bf16_ours_min"] < v["plain_min"]):
        raise AssertionError(f"fixture-eval: guidance does not steer on the "
                             f"trained fixture: {v}")
    for name in ("K1_attn_fwd_64x64", "K2_attn_fwd_32x32",
                 "K3_attn_avgp_32x32"):
        rows[name].setdefault("phase_launches", {})["fixture"] = {}


def fixture_train_phase(out_dir: str) -> None:
    """The port's colour-fixture trainer (``training/color_fixture.py``) on
    the card: its CUDA-graph steps against eager ones
    (``_fixture_graph_check``), then the full protocol (1500 VAE and 4000
    UNet steps at batch 64) into ``out_dir``; then the gates of
    ``tests/test_color_fixture.py`` on the fresh pair read back from its
    files: the solid-colour round trip under 0.08 and guidance pulling the
    steered half toward red by 0.05 over the plain run; then the
    evaluation, exact only. No hand-written kernel launches."""
    from rich_text_to_image_tpu_torch.evaluation import (
        color_fixture_eval as E)
    from rich_text_to_image_tpu_torch.evaluation.fixtures import (
        load_color_fixture)
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.ops import conv as CV
    from rich_text_to_image_tpu_torch.training import color_fixture as CF

    A.reset_launches()
    CV.reset_launches()
    graph_d = _fixture_graph_check(os.path.join(out_dir, "fixture_check"))
    fixture = os.path.join(out_dir, "color_fixture_torch")
    res, secs = _timed(lambda: CF.train(out_dir=fixture, device="cuda"))
    model = load_color_fixture(fixture, device="cuda", agg_start_step=3)
    meta = res["meta"]
    rt = CF.solid_color_roundtrip(model)
    d_plain = _fixture_steering(model, False)
    d_ours = _fixture_steering(model, True)
    ev = E.run(model, os.path.join(out_dir, "color_fixture_eval_torch"),
               configs=("exact",))
    launches = _no_launches("fixture-train")
    vae_s, unet_s = res["vae_seconds"], res["unet_seconds"]
    print(f"fixture-train: {meta['vae_steps']} VAE + {meta['unet_steps']} "
          f"UNet steps at batch {meta['batch']}, {meta['px']}^2 px, CUDA "
          f"graphs after {CF.WARM_STEPS} eager steps: VAE stage "
          f"{vae_s:.2f} s ({vae_s / meta['vae_steps'] * 1e3:.2f} ms a step), "
          f"UNet stage {unet_s:.2f} s "
          f"({unet_s / meta['unet_steps'] * 1e3:.2f} ms a step), "
          f"{secs:.2f} s in all; last losses VAE {res['vae_loss']:.5f}, DSM "
          f"{res['dsm_loss']:.5f}; solid-colour round trip "
          f"{meta['vae_solid_color_roundtrip_mean_abs_drgb']} (float16 "
          f"files: {rt:.5f}; bound 0.08); steering to red, 12 steps: "
          f"d_plain {d_plain:.4f}, d_ours {d_ours:.4f} (margin bound 0.05); "
          f"graph against eager steps {json.dumps(graph_d)}; "
          f"exact evaluation verdict {json.dumps(ev['verdict'])}, "
          f"{ev['seconds']['exact']:.2f} s; hand-written launches "
          f"{launches}; on {_smi()}", flush=True)
    if not (meta["vae_solid_color_roundtrip_mean_abs_drgb"] < 0.08
            and rt < 0.08):
        raise AssertionError("fixture-train: the decoder is not "
                             "colour-faithful")
    if not d_ours < d_plain - 0.05:
        raise AssertionError(f"fixture-train: guidance does not steer: "
                             f"{d_ours} against {d_plain}")
    if not ev["verdict"]["steering_real"]:
        raise AssertionError(f"fixture-train: {ev['verdict']}")


def bpe_phase() -> None:
    """The native merge loop (``native/bpe.cpp``, built with g++ at first
    use) must load on this machine and give the Python loop's merges on a
    random merge table; µs a word for both, host clock."""
    import random

    from rich_text_to_image_tpu_torch import native
    from rich_text_to_image_tpu_torch.models.tokenizer import (
        CLIPTokenizer, bytes_to_unicode)

    t0 = time.time()
    if native.load_bpe_lib() is None:
        raise AssertionError(f"bpe: the native library did not load: "
                             f"{native.load_error()}")
    load_s = time.time() - t0
    rng = random.Random(0)
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    symbols = letters + [c + "</w>" for c in letters]
    merges = []
    while len(merges) < 2000:
        a, b = rng.choice(symbols), rng.choice(symbols)
        if (a, b) not in merges and not a.endswith("</w>"):
            merges.append((a, b))
            if not b.endswith("</w>"):
                symbols.append(a + b)
    units = list(bytes_to_unicode().values())
    vocab = {u: i for i, u in enumerate(units + [u + "</w>" for u in units])}
    for m in merges:
        vocab.setdefault("".join(m), len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    words = ["".join(rng.choice(letters) for _ in range(rng.randint(1, 14)))
             for _ in range(5000)]
    out, us = {}, {}
    for native_on in (True, False):
        tok = CLIPTokenizer(vocab, merges, use_native=native_on)
        if (tok._native is not None) != native_on:
            raise AssertionError("bpe: the tokenizer took the wrong loop")
        t0 = time.perf_counter()
        out[native_on] = [tok._bpe(w) for w in words]  # each word once
        us[native_on] = (time.perf_counter() - t0) / len(words) * 1e6
    equal = out[True] == out[False]
    print(f"bpe: native library {os.path.basename(native.lib_path())} loaded "
          f"({load_s:.2f} s with the build); {len(words)} random words over "
          f"{len(merges)} random merges: merges equal to the Python loop's: "
          f"{equal}; native {us[True]:.2f} us a word, Python "
          f"{us[False]:.2f} us a word (host clock)", flush=True)
    if not equal:
        raise AssertionError("bpe: native and Python merges differ")


def flops_phase(pipe, unet_ms: float) -> None:
    """``utils.flops.unet_fwd_flops`` of SD-1.5 and SDXL at B = 2 (meta
    device: nothing runs), and the SD-1.5 forward's share of the card's
    dense bf16 peak from ``unet:``'s measured forward."""
    import types

    import torch

    from rich_text_to_image_tpu_torch.models import config as cfgs
    from rich_text_to_image_tpu_torch.utils import flops as F

    t0 = time.time()
    sd = F.unet_fwd_flops(pipe, 2, False)
    xl = F.unet_fwd_flops(types.SimpleNamespace(
        unet_cfg=cfgs.SDXL_UNET,
        unet=types.SimpleNamespace(dtype=torch.bfloat16)), 2, True)
    count_s = time.time() - t0
    peak, kind = F.peak_flops()
    rate = sd / (unet_ms * 1e-3)
    mfu = rate / peak if peak else None
    print(f"flops: unet_fwd_flops (FlopCounterMode on the meta device, "
          f"products only) SD-1.5 B=2 {sd:.6e}, SDXL B=2 {xl:.6e}, counted "
          f"in {count_s:.1f} s; SD-1.5 forward {unet_ms:.3f} ms (unet:) -> "
          f"{rate / 1e12:.2f} TFLOP/s, mfu {mfu} of the {kind} peak "
          f"{peak}", flush=True)
    if not sd > 0 or not xl > sd:
        raise AssertionError(f"flops: counts {sd}, {xl}")


def _demo_request(kind: str):
    """(``APP_DEFAULTS[kind]``, ``DEMO_EXAMPLE`` as the demo's JSON string,
    its span regions R)."""
    from rich_text_to_image_tpu_torch.cli.examples import (APP_DEFAULTS,
                                                           EXAMPLES)
    from rich_text_to_image_tpu_torch.models.tokenizer import CLIPTokenizer
    from rich_text_to_image_tpu_torch.utils import richtext

    doc = EXAMPLES[DEMO_EXAMPLE]
    prompts, _, _ = richtext.get_region_diffusion_input(
        CLIPTokenizer.byte_level()._tokenize, richtext.parse_json(doc))
    return APP_DEFAULTS[kind], json.dumps(doc), len(prompts) - 1


def demo_phase(tag: str, pipe, kind: str, steps: int, out_dir: str,
               trace_dir: str, want_fn) -> dict:
    """``cli.gradio_app.run_generate`` with ``DEMO_EXAMPLE`` at the demo's
    defaults for ``kind`` (``steps`` in place of its 41), as the demo's
    button calls it: the plain pass with the refer cache, the token maps,
    the figures, the rich pass through the refer-precompute flow (R+2 rows
    a step). Asserts the UNet batches, the launches by shape
    (``want_fn(calls, seen)``), finite non-constant images and the written
    figures; prints the stage seconds (``utils.tracing``) and the peak
    device memory. Then the same request again with its rich pass under
    ``utils.tracing.device_trace`` into ``trace_dir``, whose file must be
    non-empty. Returns
    the first run's launches by shape."""
    import numpy as np
    import torch

    from rich_text_to_image_tpu_torch.cli.gradio_app import run_generate
    from rich_text_to_image_tpu_torch.ops import attention as A
    from rich_text_to_image_tpu_torch.utils import tracing

    d, text, regions = _demo_request(kind)
    if regions + 2 != DEMO_RICH:
        raise AssertionError(f"{tag}: {regions} span regions, expected "
                             f"{DEMO_RICH - 2}")
    size = d["resolution"]
    calls = pipe.scheduler.plan(steps).num_steps

    def request():
        return run_generate(
            pipe, size, text, "", d["seed"], steps, d["guidance_weight"],
            d["color_guidance_weight"], d["inject_selfattn"],
            d["inject_background"], d["segment_threshold"],
            d["num_segments"], vis_dir=out_dir)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    tracing.phase_report()
    outs, seen = _batches(pipe, request)
    stages = tracing.phase_report()
    peak = torch.cuda.max_memory_allocated()
    by_shape = dict(A.LAUNCHES_BY_SHAPE)
    if seen != [2] * calls + [DEMO_RICH] * calls:
        raise AssertionError(f"{tag}: UNet batches {seen}, expected {calls} "
                             f"of 2 then {calls} of R+2 = {DEMO_RICH}")
    _expect_shapes(tag, by_shape, want_fn(calls, seen))
    for name, img in (("plain", outs[0]), ("rich", outs[1])):
        f = img.astype(np.float64)
        if img.shape != (size, size, 3) or not np.isfinite(f).all() or (
                f.std() == 0):
            raise AssertionError(f"{tag}: the {name} image is wrong: "
                                 f"{img.shape}, std {f.std()}")
    figures = [f"segmentation_k{d['num_segments']}_seed{d['seed']}.png",
               f"average_seed{d['seed']}_attn0.png"]
    if not all(os.path.getsize(os.path.join(out_dir, f)) for f in figures):
        raise AssertionError(f"{tag}: a figure is empty: {figures}")

    orig = pipe.prompt_to_img
    traces = []

    def traced(*a, **kw):
        with tracing.device_trace(trace_dir) as path:
            traces.append(path)
            return orig(*a, **kw)

    pipe.prompt_to_img = traced
    try:
        request()
    finally:
        del pipe.prompt_to_img
    tracing.phase_report()
    nbytes = os.path.getsize(traces[0])
    print(f"{tag}: run_generate of {DEMO_EXAMPLE!r} at APP_DEFAULTS["
          f"{kind!r}] ({size}x{size}, {steps} steps in place of "
          f"{d['steps']}, inject_background {d['inject_background']}, "
          f"segment_threshold {d['segment_threshold']}): stage seconds "
          f"{json.dumps(stages)}; UNet batches {_runs(seen)} (rich batch "
          f"R+2 = {DEMO_RICH}); launches by shape "
          f"{json.dumps(_keyed(by_shape))}; figures {figures}; peak device "
          f"memory {peak} bytes ({peak / 2**30:.2f} GiB); device trace of "
          f"the rich pass {traces[0]} ({nbytes} bytes) on {_smi()}",
          flush=True)
    if nbytes == 0:
        raise AssertionError(f"{tag}: the device trace is empty")
    return by_shape


def _demo_sd_launches(calls: int, seen: list) -> dict:
    """The SD demo at 512^2: the plain pass captures at its last step."""
    return _sd_launches(seen, captures=1)


def _demo_xl_launches(calls: int, seen: list) -> dict:
    """The SDXL demo at 1024^2 with the plain pass capturing from step 1:
    10 K1 at 64^2 and 60 at 32^2 a forward at head dim 64, but the 32^2
    ones of the capture steps, which take K3."""
    rb = DEMO_RICH
    return {("full", 2, 10, 4096, 4096, 64): calls * SDXL_SELF_64,
            ("full", 2, 20, 1024, 1024, 64): SDXL_SELF_32,
            ("avgp", 2, 20, 1024, 1024, 64): (calls - 1) * SDXL_SELF_32,
            ("full", rb, 10, 4096, 4096, 64): calls * SDXL_SELF_64,
            ("full", rb, 20, 1024, 1024, 64): calls * SDXL_SELF_32}


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
    t_start = time.time()
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
    grad_guard_phase()
    if kernels_only:
        print(_smi(), flush=True)
        return 0

    t0 = time.time()
    pipe = RegionDiffusion.random_init(seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: full-width SD-1.5 pipeline, random weights, "
          f"{time.time() - t0:.1f} s", flush=True)
    unet_ms = unet_phase(pipe)
    _record_phase(rows, "dual", dual_phase(pipe))
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
          + json.dumps(_keyed(acc["by_shape"])), flush=True)

    # the demo's entry point and the checkpoint and LoRA paths; the lora:
    # phase leaves the pipeline on the checkpoint's weights, the base ones
    ckpt = os.path.join(out, "ckpt")
    ckpt_phase(pipe, ckpt)
    lora_phase(pipe, os.path.join(out, "lora"), ckpt, rows)
    _record_phase(rows, "demo", demo_phase(
        "demo", pipe, "SD", STEPS, os.path.join(out, "demo"),
        os.path.join(out, "trace", "demo"), _demo_sd_launches))

    # this slice's phases: multiple devices, training, the native tokenizer
    # and the FLOP count
    ref_shapes, ref_png = mesh1_phase(pipe, os.path.join(out, "mesh1"))
    train_loss = train_phase()
    mesh2_phase(os.path.join(out, "mesh2"), ref_png, ref_shapes,
                os.path.join(out, "colorbench", "batch_colors_4"),
                train_loss, rows)
    for name in ("K1_attn_fwd_64x64", "K2_attn_fwd_32x32",
                 "K3_attn_avgp_32x32"):
        rows[name].setdefault("phase_launches", {})["train"] = {}
    bpe_phase()
    flops_phase(pipe, unet_ms)

    # the trained colour fixture: the committed JAX-trained pair, then one
    # trained here by the port
    fixture_eval_phase(os.path.join(out, "color_fixture_eval"), rows)
    fixture_train_phase(out)

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
          + json.dumps(_keyed(by_shape)), flush=True)
    sdxl_refpre_phase(xl, os.path.join(out, "sdxl_refpre"), rich_xl)
    with _agg_start(xl, 1):
        by_shape = demo_phase("demo-xl", xl, "SDXL", STEPS_SHORT,
                              os.path.join(out, "demo_xl"),
                              os.path.join(out, "trace", "demo_xl"),
                              _demo_xl_launches)
    _record_phase(rows, "demo-xl", by_shape)
    sdxl_sample_phase(xl, rows)
    for entry in rows["K1_attn_fwd_64x64"]["demo_d64"]:
        b, h, s, d = entry["shape"]
        entry["launches"] = by_shape.get(("full", b, h, s, s, d), 0)
        if not entry["launches"]:
            raise AssertionError(f"demo-xl: no launch at {entry['shape']}")
    sdxl_breakdown_phase(xl)

    # the throughput program at 50 steps: the SDXL pipeline gives its
    # memory back first, and the program builds its own models
    del xl
    gc.collect()
    torch.cuda.empty_cache()
    bench_phase(rows)

    print(_smi(), flush=True)
    print(f"command time: {time.time() - t_start:.1f} s", flush=True)
    if any(r["launches"] in (None, 0) for r in rows.values()):
        raise AssertionError(f"a kernel was launched on no path: {rows}")
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(kernels_only="--kernels-only" in sys.argv[1:]))
