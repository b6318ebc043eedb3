#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``). It exits non-zero, printing no result, when there
is no CUDA device or the port's package is not beside it. Phases, in order:

  1. the card's name and power limit (``nvidia-smi``);
  2. build: compiles ``rich_text_to_image_tpu_torch/csrc/attention.cu`` with
     nvcc for sm_90a;
  3. kernels: each hand-written attention kernel against its plain PyTorch
     version on the card, at the main path's shapes plus a ragged one, with
     its time, the plain version's, the least time the card could take, and
     ``scaled_dot_product_attention``'s as a yardstick;
  4. UNet: one full-width SD-1.5 CFG forward (bfloat16, random weights, 64^2
     latent) with capture of the five 32^2 layers, through the kernels and
     again with the plain attention, compared;
  5. end to end: the port's CLI flow (plain pass, token maps, rich pass with
     a footnote, a coloured span and a font-size span) at 512^2 with 12
     PNDM steps, asserting that every kernel of the path was launched;
  6. breakdown: the per-call times of what the passes repeat (the UNet at
     batch 2 and 3, one colour-guided step, the final decode);
  7. profile: one UNet forward at batch 2 and 3 under ``torch.profiler``,
     its device kernel count and the device's idle share.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failure raises.
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

KERNELS = {
    # name: (TPU kernel it replaces, main-path shape (B, H, S, D))
    "K1_attn_fwd_64x64": ("rich_text_to_image_tpu/ops/attention.py:47",
                          (2, 8, 4096, 40)),
    "K2_attn_fwd_32x32": ("rich_text_to_image_tpu/ops/attention.py:83",
                          (2, 8, 1024, 80)),
    "K3_attn_avgp_32x32": ("rich_text_to_image_tpu/ops/attention.py:181",
                           (2, 8, 1024, 80)),
}
SOURCE = "rich_text_to_image_tpu_torch/csrc/attention.cu"
NOT_PORTED = [
    {"name": "K4_flash_online", "replaces":
     "rich_text_to_image_tpu/ops/attention.py:302", "status": "not ported: "
     "off the SD-1.5 512^2 path"},
    {"name": "K5_conv3x3", "replaces": "rich_text_to_image_tpu/ops/conv.py:50",
     "status": "not ported: opt-in, off by default"},
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


def _bound_ms(b, h, s, d, pavg: bool):
    flops = 4 * b * h * s * s * d
    nbytes = 4 * b * h * s * d * 2 + (b * s * s * 4 if pavg else 0)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


KERNEL_CASES = [  # (kernel, B, S, d): the main path's shapes, and ragged S
    ("K1_attn_fwd_64x64", 2, 4096, 40), ("K1_attn_fwd_64x64", 3, 4096, 40),
    ("K1_attn_fwd_64x64", 2, 4000, 40),
    ("K2_attn_fwd_32x32", 2, 1024, 80), ("K2_attn_fwd_32x32", 3, 1024, 80),
    ("K2_attn_fwd_32x32", 2, 1000, 80),
    ("K3_attn_avgp_32x32", 2, 1024, 80), ("K3_attn_avgp_32x32", 2, 1000, 80),
]


def kernel_phase(cases=KERNEL_CASES) -> dict:
    """Every kernel against its plain version at the main path's shapes and
    a ragged one; returns {kernel: row of the kernels line}."""
    import torch
    import torch.nn.functional as F

    from rich_text_to_image_tpu_torch.ops import attention as A

    rows = {}
    for name, b, s, d in cases:
        q, k, v = _qkv(b, 8, s, d, seed=s + d + b)
        scale = d ** -0.5
        avgp = name.startswith("K3")
        if avgp:
            kern = lambda: A.flash_attention_avg_probs(q, k, v, scale)
            plain = lambda: A.flash_attention_avg_probs_plain(q, k, v, scale)
        else:
            kern = lambda: A.flash_attention(q, k, v, scale)
            plain = lambda: A.flash_attention_plain(q, k, v, scale)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if avgp:
            (o, p), (o_ref, p_ref) = got, want
            p_err = ((p - p_ref).abs().max() / p_ref.abs().max()).item()
        else:
            (o, o_ref), p_err = (got, want), 0.0
        err = (o.float() - o_ref.float()).abs().max().item()
        o_max = o_ref.float().abs().max().item()
        ok = err <= OUT_RTOL * o_max and p_err <= PAVG_RTOL
        ms = _time_ms(kern, 20)
        plain_ms = _time_ms(plain, 5)
        sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 20)
        bound, bound_by = _bound_ms(b, 8, s, d, avgp)
        line = (f"kernel {name} B={b} S={s} d={d}: max|d out|={err:.3e} "
                f"= {err / o_max:.3e} of max|o_ref| {o_max:.3f} "
                f"(tol {OUT_RTOL} of it)"
                + (f" pavg rel={p_err:.3e} (tol {PAVG_RTOL})" if avgp else "")
                + f" ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound:.4f}"
                f" ({bound_by}) sdpa_ms={sdpa_ms:.4f}")
        print(line, flush=True)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{line}")
        mb, _, ms_, md = KERNELS[name][1]
        if (b, s, d) == (mb, ms_, md):
            rows[name] = {
                "name": name, "status": "ported", "route": "cuda",
                "source": SOURCE,
                "replaces": KERNELS[name][0], "launches": None,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
                # no single library call also returns the head-averaged
                # probabilities: SDPA computes only the output
                "library_ms": None if avgp else sdpa_ms,
                "shape_BHSD": list(KERNELS[name][1]),
            }
    return rows


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


def e2e_phase(pipe, out_dir: str) -> dict:
    """The port's CLI flow at 512^2; returns the launch counts of the run."""
    import numpy as np

    from rich_text_to_image_tpu_torch.cli.sample import make_parser, run_sample
    from rich_text_to_image_tpu_torch.ops import attention as A

    args = make_parser().parse_args(
        ["--run_dir", out_dir, "--sample_steps", str(STEPS), "--seed", "6",
         "--rich_text_json", RICH_TEXT])
    param = {"text_input": json.loads(RICH_TEXT), "height": 512,
             "width": 512, "guidance_weight": args.guidance_weight,
             "steps": STEPS, "noise_index": args.seed, "negative_prompt": ""}
    A.reset_launches()
    plain_img, rich_img, seconds = run_sample(pipe, args, param, save=True)
    launches = dict(A.LAUNCHES)
    for tag, img in (("plain", plain_img), ("rich", rich_img)):
        f = img.astype(np.float64)
        if img.shape != (1, 512, 512, 3) or not np.isfinite(f).all() or (
                f.std() == 0):
            raise AssertionError(f"{tag} image is wrong: {img.shape}, "
                                 f"std {f.std()}")
    print("e2e: stage seconds " + json.dumps(seconds) + f", launches "
          f"{launches}, images in {out_dir}", flush=True)
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path was never launched: "
                             f"{launches}")
    return launches


def breakdown_phase(pipe) -> dict:
    """Per-call times, with CUDA events, of what the two passes repeat at
    512^2: the UNet forward at the plain (B=2) and rich (B=3) batch, one
    colour-guided step (fp32 VAE decode of the x0 prediction and its
    gradient) and the final decode."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(2)
    lat = torch.randn((1, 64, 64, 4), generator=g, device="cuda")
    noise = torch.randn((1, 64, 64, 4), generator=g, device="cuda")
    ctx = pipe.get_text_embeds(["a cat", "a scooter"], [""])
    color = dict(
        masks_px=(torch.rand((1, 512, 512), generator=g, device="cuda")
                  > 0.5).float(),
        target_rgb=torch.tensor([[1.0, 0.0, 0.0]], device="cuda"),
        all=torch.ones((1, 64, 64, 1), device="cuda"), weight=0.5)
    out = {}
    with torch.no_grad():
        for b in (2, 3):
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
          f"{n * (out['unet_b3_ms'] + out['guided_step_ms']) / 1e3:.3f} s + "
          "decode", flush=True)
    return out


def profile_phase(pipe, unet_ms: dict) -> None:
    """One UNet forward at B=2 and B=3 under ``torch.profiler``: the number
    of kernels it launches, their summed device time, and the device's idle
    share of the forward's un-profiled time from the breakdown phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(3)
    lat = torch.randn((1, 64, 64, 4), generator=g, device="cuda")
    ctx = pipe.get_text_embeds(["a cat", "a scooter"], [""])
    for b in (2, 3):
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


def main() -> int:
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

    rows = kernel_phase()

    t0 = time.time()
    pipe = RegionDiffusion.random_init(seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: full-width SD-1.5 pipeline, random weights, "
          f"{time.time() - t0:.1f} s", flush=True)
    unet_phase(pipe)
    launches = e2e_phase(pipe, os.path.join(root, "results", "chip_smoke"))
    rows["K1_attn_fwd_64x64"]["launches"] = launches["full"]
    rows["K2_attn_fwd_32x32"]["launches"] = launches["full_t"]
    rows["K3_attn_avgp_32x32"]["launches"] = launches["avgp"]
    profile_phase(pipe, breakdown_phase(pipe))

    print(_smi(), flush=True)
    print(json.dumps({"kernels": list(rows.values()),
                      "not_ported": NOT_PORTED}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
