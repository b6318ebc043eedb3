"""Colour guidance on a trained fixture: the verdict of the colour
benchmark protocol where decode(latent) colour is real.

Counterpart of ``scripts/eval_color_fixture.py``. On a fixture directory
(the committed JAX-trained one by default, or one that
``training/color_fixture.py`` wrote) it runs

  * ``grad_cosines``: cos(exact, pooled by 2) of the colour guidance loss's
    gradient on the trained decoder, at random latents, targets and masks
    (the quantity ``--guidance_downsample 2`` approximates);
  * ``benchmark_color.run`` at 41 steps, ``--limit 6 --num_seeds 2``, in
    three guidance configurations: ``exact`` (float32, full size),
    ``gds2`` (``--guidance_downsample 2``) and ``bf16``
    (``--bf16_guidance``); the plain image comes with each;

and writes ``summary_<name>.json``, ``grad_cosine.jsonl`` and
``verdict.json`` under the JAX script's keys.

    python scripts/port_eval_color_fixture.py [--fixture_dir DIR]
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from . import benchmark_color
from .fixtures import FIXTURE_DIR, load_color_fixture

OUT_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "results",
    "color_fixture_eval_torch"))
CONFIGS = {"exact": [], "gds2": ["--guidance_downsample", "2"],
           "bf16": ["--bf16_guidance"]}


def guidance_loss(model, lat, mask_px, target, pool: int) -> torch.Tensor:
    """The reference's colour loss (region_diffusion.py:151-168) of one
    region: 100 times the squared distance of the decoded image's mean RGB
    under ``mask_px`` [1,H,W] from ``target`` [1,3]; with ``pool`` > 1 the
    latent is average-pooled and the mask subsampled by ``pool`` first."""
    if pool > 1:
        b, h, w, c = lat.shape
        lat = lat.reshape(b, h // pool, pool, w // pool, pool, c).mean((2, 4))
        mask_px = mask_px[:, ::pool, ::pool]
    img = model.vae.decode(lat / model.vae_cfg.scaling_factor)
    img = (img.clamp(-1, 1) + 1) / 2
    w = mask_px[..., None]
    avg = (img * w).sum((1, 2)) / w.sum((1, 2))
    return 100.0 * torch.mean((avg - target) ** 2)


def guidance_grads(model, lat, mask_px, target) -> tuple:
    """(exact, pooled by 2) gradients of :func:`guidance_loss` in ``lat``."""
    out = []
    for pool in (1, 2):
        with torch.enable_grad():
            x = lat.detach().clone().requires_grad_(True)
            (g,) = torch.autograd.grad(
                guidance_loss(model, x, mask_px, target, pool), x)
        out.append(g)
    return tuple(out)


def draw_probes(model, n: int, seed: int = 0) -> list:
    """``n`` (latent [1,h,h,4], target [1,3], mask [1,H,H]) triples from a
    ``torch.Generator`` of the model's device seeded with ``seed``: normal
    latents, uniform targets, masks of 4x4-pixel cells on with
    probability 1/2 (the JAX script's distributions, not its numbers)."""
    dev = model.device
    h = model.unet_cfg.sample_size
    px = h * model.vae_scale_factor
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    out = []
    for _ in range(n):
        lat = torch.randn((1, h, h, 4), generator=gen, device=dev)
        target = torch.rand((1, 3), generator=gen, device=dev)
        m = (torch.rand((1, px // 4, px // 4), generator=gen, device=dev)
             > 0.5).float()
        out.append((lat, target, m.repeat_interleave(4, 1)
                    .repeat_interleave(4, 2)))
    return out


def grad_cosines(model, n: int = 12, seed: int = 0, probes=None) -> list:
    """cos(exact grad, pooled-by-2 grad) of the colour loss on the model's
    decoder for each probe (:func:`draw_probes`' ``n`` by default)."""
    rows = []
    for i, (lat, target, mask) in enumerate(
            probes if probes is not None else draw_probes(model, n, seed)):
        g_exact, g_pool = guidance_grads(model, lat, mask, target)
        cos = float((g_exact * g_pool).sum() /
                    (g_exact.norm() * g_pool.norm() + 1e-12))
        rows.append({"i": i, "cos_exact_vs_gds2": round(cos, 4)})
    return rows


def run(model, out_dir: str = OUT_DIR, configs=tuple(CONFIGS),
        steps: int = 41, limit: int = 6, num_seeds: int = 2,
        n_cos: int = 12) -> dict:
    """The cosines and the benchmark in ``configs`` (names of
    :data:`CONFIGS`, ``exact`` among them); writes the files and returns
    ``{"verdict", "summaries", "cosines", "seconds"}``, seconds per
    configuration on the host clock. A configuration not run is None in
    the verdict."""
    os.makedirs(out_dir, exist_ok=True)
    rows = grad_cosines(model, n_cos)
    with open(os.path.join(out_dir, "grad_cosine.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    cosines = [r["cos_exact_vs_gds2"] for r in rows]
    print(f"[grad] cos(exact, gds2) on trained decoder: "
          f"min={min(cosines):.3f} mean={np.mean(cosines):.3f}", flush=True)

    summaries, seconds = {}, {}
    for name in configs:
        args = benchmark_color.make_parser().parse_args([
            "--limit", str(limit), "--num_seeds", str(num_seeds),
            "--steps", str(steps), "--device", str(model.device),
            "--save_path", os.path.join(out_dir, f"run_{name}"),
        ] + CONFIGS[name])
        t0 = time.perf_counter()
        s = benchmark_color.run(args, model=model)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        seconds[name] = time.perf_counter() - t0
        summaries[name] = s
        with open(os.path.join(out_dir, f"summary_{name}.json"), "w") as f:
            json.dump(s, f, indent=2)
        print(f"[{name}] plain_min={s['plain_min']['mean']:.4f} "
              f"ours_min={s['ours_min']['mean']:.4f} "
              f"plain_avg={s['plain_avg']['mean']:.4f} "
              f"ours_avg={s['ours_avg']['mean']:.4f}", flush=True)

    def ours_min(name):
        return summaries[name]["ours_min"]["mean"] if name in summaries \
            else None

    ex = summaries["exact"]
    verdict = {
        "steering_real": ex["ours_min"]["mean"] < ex["plain_min"]["mean"],
        "plain_min": ex["plain_min"]["mean"],
        "exact_ours_min": ours_min("exact"),
        "gds2_ours_min": ours_min("gds2"),
        "bf16_ours_min": ours_min("bf16"),
        "grad_cos_exact_vs_gds2_min": min(cosines),
        "grad_cos_exact_vs_gds2_mean": round(float(np.mean(cosines)), 4),
        "protocol": f"{steps} steps, CFG 8.5, inject 0.2/0.3, weight 1, "
                    f"limit {limit} x {num_seeds} seeds, trained fixture",
    }
    with open(os.path.join(out_dir, "verdict.json"), "w") as f:
        json.dump(verdict, f, indent=2)
    print(json.dumps(verdict), flush=True)
    return {"verdict": verdict, "summaries": summaries, "cosines": cosines,
            "seconds": seconds}


def main(argv=None) -> dict:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fixture_dir", default=FIXTURE_DIR)
    p.add_argument("--out", default=OUT_DIR)
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=41)
    p.add_argument("--limit", type=int, default=6)
    p.add_argument("--num_seeds", type=int, default=2)
    a = p.parse_args(argv)
    model = load_color_fixture(a.fixture_dir, device=a.device,
                               agg_start_step=3)
    return run(model, a.out, tuple(CONFIGS), a.steps, a.limit, a.num_seeds)
