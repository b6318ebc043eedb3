"""The port's batched benchmark paths against the JAX package's and
against its own sequential rich pass, after ``tests/test_colorbatch.py``.

``color_bench_batch``: K colour items in one loop of 2+3K rows a step (3K
past the reference rows' last use, "ref-skip"), the colour guidance per
item at batch 1. ``style_bench_batch``: K style items of R+2 rows each.
Both tiny pipelines in float32 on the CPU from the same numpy latent.

Against JAX the decodes are replaced by the identity and the final latents
[K, h, w, 4] are compared: within 1e-4 of their scale (5 PNDM calls, a VAE
gradient each step); the bfloat16 guidance decode within 2e-3 (bf16
rounding of the decode and its gradient, in another order on each side).
Against the port's sequential ``prompt_to_img`` the uint8 images are
compared with the JAX test's bounds: mean |diff| < 0.1, max <= 2 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rich_text_to_image_tpu.ops.resize import resize_bicubic
from rich_text_to_image_tpu.schedulers.dpmsolver import (
    DPMSolverMultistepScheduler as JDPM)
from rich_text_to_image_tpu.schedulers.pndm import PNDMScheduler as JPNDM
from rich_text_to_image_tpu_torch.schedulers.dpmsolver import (
    DPMSolverMultistepScheduler as TDPM)
from rich_text_to_image_tpu_torch.schedulers.pndm import PNDMScheduler as TPNDM
from torch_port_pipes import close, tiny_pipes
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS, H, PX = 4, 8, 16
BASE = "a photo of a car on the road"
COLORS = {"red": (255, 0, 0), "teal": (0, 128, 128), "navy": (0, 0, 128)}
SCHEDULERS = {"pndm": (JPNDM, TPNDM), "dpm": (JDPM, TDPM)}


@pytest.fixture(scope="module")
def pipes():
    jp, tp = tiny_pipes()
    lat = np.array(jax.random.normal(jax.random.PRNGKey(5), (1, H, H, 4)))
    return jp, tp, lat


def _masks(seed, n):
    soft = np.random.RandomState(seed).rand(n, H, H).astype(np.float32)
    return list((soft / soft.sum(0, keepdims=True))[:, None])


def _color_args(pipes, seed=0):
    jp, tp, _ = pipes
    masks = _masks(seed, 2)
    jp.masks = tp.masks = masks
    mask_px = np.asarray(resize_bicubic(masks[0], (PX, PX))).clip(0, 1)[0]
    rgbs = np.stack([np.asarray(v, np.float32) / 255.0
                     for v in COLORS.values()])
    return [f"{n} car" for n in COLORS], rgbs, mask_px


def _latents_only(monkeypatch, jp, tp):
    monkeypatch.setattr(jp, "decode_latents", lambda lat: np.asarray(lat))
    monkeypatch.setattr(tp, "decode_latents", lambda lat: lat.numpy())


@pytest.mark.parametrize("sched,bg,gds", [
    ("pndm", 0.3, 1), ("pndm", 0.99, 1), ("dpm", 0.3, 2)],
    ids=["pndm-refskip", "pndm-noskip", "dpm-refskip-gds2"])
def test_color_bench_batch_matches_jax(pipes, monkeypatch, sched, bg, gds):
    """bg 0.3 puts the reference's last use before the last step (the
    merged 3K-row forward runs after it); bg 0.99 puts the
    background-injection step last, so every step carries the reference."""
    jp, tp, lat = pipes
    _latents_only(monkeypatch, jp, tp)
    js, ts = SCHEDULERS[sched]
    monkeypatch.setattr(jp, "scheduler", js())
    monkeypatch.setattr(jp, "_jit_cache", {})
    monkeypatch.setattr(tp, "scheduler", ts())
    prompts, rgbs, mask_px = _color_args(pipes)
    S = tp.scheduler.plan(STEPS).num_steps
    assert (int(bg * S) < S - 1) == (bg < 0.5)
    args = (prompts, BASE, rgbs, mask_px, PX, PX, STEPS, 8.5)
    kw = dict(seed=1, inject_background=bg, guidance_downsample=gds)
    want = jp.color_bench_batch(*args, latents=jnp.asarray(lat), **kw)
    got = tp.color_bench_batch(*args, latents=lat, **kw)
    assert got.shape == want.shape == (3, H, H, 4)
    close(got, want)


def test_bf16_guidance_matches_jax(pipes, monkeypatch):
    jp, tp, lat = pipes
    _latents_only(monkeypatch, jp, tp)
    prompts, rgbs, mask_px = _color_args(pipes, seed=7)
    args = (prompts[:2], BASE, rgbs[:2], mask_px, PX, PX, STEPS, 8.5)
    want = jp.color_bench_batch(*args, latents=jnp.asarray(lat),
                                bf16_guidance=True)
    got = tp.color_bench_batch(*args, latents=lat, bf16_guidance=True)
    close(got, want, rel=2e-3)


def _uint8_close(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.mean() < 0.1 and diff.max() <= 2, (diff.mean(), diff.max())


def test_color_bench_batch_matches_sequential(pipes):
    _, tp, lat = pipes
    prompts, rgbs, mask_px = _color_args(pipes, seed=3)
    batched = tp.color_bench_batch(prompts, BASE, rgbs, mask_px, PX, PX,
                                   STEPS, 8.5, seed=1, latents=lat)
    assert batched.shape == (3, PX, PX, 3) and batched.dtype == np.uint8
    for k, prompt in enumerate(prompts):
        fmt = {"guidance_start_step": 999, "color_guidance_weight": 1,
               "target_RGB": [rgbs[k]], "color_obj_atten": [mask_px[None]],
               "color_obj_atten_all": np.asarray(tp.masks[0])}
        seq = tp.prompt_to_img(
            [prompt, BASE], [""], height=PX, width=PX,
            num_inference_steps=STEPS, guidance_scale=8.5, latents=lat,
            text_format_dict=fmt, use_guidance=True, inject_selfattn=0.2,
            inject_background=0.3, seed=1)
        _uint8_close(batched[k], seq[0])


ITEMS = [["a cat in the style of monet", "a dog in the style of van gogh",
          "a cat next to a dog"],
         ["a cat in the style of dali", "a dog in the style of picasso",
          "a cat next to a dog"]]


def test_style_bench_batch_matches_jax(pipes, monkeypatch):
    jp, tp, lat = pipes
    _latents_only(monkeypatch, jp, tp)
    jp.masks = tp.masks = _masks(2, 3)
    want = jp.style_bench_batch(ITEMS, PX, PX, STEPS, 8.5, seed=2,
                                latents=jnp.asarray(lat))
    got = tp.style_bench_batch(ITEMS, PX, PX, STEPS, 8.5, seed=2,
                               latents=lat)
    assert got.shape == want.shape == (2, H, H, 4)
    close(got, want)


def test_style_bench_batch_matches_sequential(pipes):
    _, tp, lat = pipes
    tp.masks = _masks(2, 3)
    batched = tp.style_bench_batch(ITEMS, PX, PX, STEPS, 8.5, seed=2,
                                   latents=lat)
    for k, item in enumerate(ITEMS):
        seq = tp.prompt_to_img(item, [""], height=PX, width=PX,
                               num_inference_steps=STEPS, guidance_scale=8.5,
                               latents=lat, seed=2)
        _uint8_close(batched[k], seq[0])


def test_predict_x0_matches_jax(pipes):
    jp, tp, lat = pipes
    eps = np.random.default_rng(1).standard_normal(lat.shape).astype(
        np.float32)
    close(tp.predict_x0(lat, eps, 501), jp.predict_x0(lat, eps, 501))
