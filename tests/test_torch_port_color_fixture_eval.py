"""The port's colour-fixture evaluation (``evaluation/color_fixture_eval.py``)
against the JAX script ``scripts/eval_color_fixture.py``, float32 on the
CPU, on the committed trained fixture.

  * the exact and pooled-by-2 gradients of the colour guidance loss
    (``scripts/eval_color_fixture.py:61-75``) at JAX's draws of latents,
    targets and masks for the script's keys: each within 1e-4 of its scale,
    their cosine within 1e-4 of JAX's; the script's own ``grad_cosines``
    rows (rounded to 4 decimals) and the port's, given the same draws,
    within one unit of the rounding;
  * a tiny run of the evaluation (3 steps, limit 1, 1 seed) writes
    ``summary_<name>.json`` for the three configurations, ``grad_cosine
    .jsonl`` and a ``verdict.json`` with the JAX script's keys.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.evaluation.fixtures import (
    load_color_fixture as jax_load_fixture)
from rich_text_to_image_tpu_torch.evaluation import color_fixture_eval as E
from rich_text_to_image_tpu_torch.evaluation import fixtures as TF
from torch_port_pipes import close
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 3


@pytest.fixture(scope="module")
def pair():
    return jax_load_fixture(agg_start_step=3), TF.load_color_fixture(
        device="cpu", agg_start_step=3)


def _jax_probes(model, n, seed=0):
    """The script's draws (eval_color_fixture.py:79-85)."""
    h = model.unet_cfg.sample_size
    px = h * model.vae_scale_factor
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, k1, k2, k3 = jax.random.split(key, 4)
        lat = jax.random.normal(k1, (1, h, h, 4))
        target = jax.random.uniform(k2, (1, 3))
        m = jax.random.uniform(k3, (1, px // 4, px // 4)) > 0.5
        mask = jnp.repeat(jnp.repeat(m.astype(jnp.float32), 4, 1), 4, 2)
        out.append((lat, target, mask))
    return out


def _jax_loss(model):
    """eval_color_fixture.py:61-75."""
    vae, vp = model.vae, model.vae_params

    def loss(lat, mask_px, target, pool):
        if pool > 1:
            lat = jax.lax.reduce_window(
                lat, 0.0, jax.lax.add, (1, pool, pool, 1),
                (1, pool, pool, 1), "VALID") / (pool * pool)
            mask_px = mask_px[:, ::pool, ::pool]
        img = vae.apply(vp, lat / model.vae_cfg.scaling_factor,
                        method=vae.decode)
        img = (img.clip(-1, 1) + 1) / 2
        w = mask_px[..., None]
        avg = (img * w).sum((1, 2)) / w.sum((1, 2))
        return 100.0 * jnp.mean((avg - target) ** 2)

    return loss


def _torch(probes):
    return [tuple(torch.from_numpy(np.array(a)) for a in p) for p in probes]


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def test_guidance_gradients_match_jax(pair):
    jp, tp = pair
    loss = _jax_loss(jp)
    grad = jax.jit(jax.grad(loss), static_argnums=3)
    for (lat, target, mask), (tl, tt, tm) in zip(_jax_probes(jp, N),
                                                 _torch(_jax_probes(jp, N))):
        want = [np.asarray(grad(lat, mask, target, pool)) for pool in (1, 2)]
        got = [g.numpy() for g in E.guidance_grads(tp, tl, tm, tt)]
        for g, w in zip(got, want):
            assert g.shape == w.shape == tuple(lat.shape)
            close(g, w, 1e-4)
        assert abs(_cos(*got) - _cos(*want)) < 1e-4


def test_grad_cosines_match_the_jax_script(pair):
    jp, tp = pair
    spec = importlib.util.spec_from_file_location(
        "eval_color_fixture",
        os.path.join(ROOT, "scripts", "eval_color_fixture.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    want = script.grad_cosines(jp, n=N)
    got = E.grad_cosines(tp, probes=_torch(_jax_probes(jp, N)))
    assert [r["i"] for r in got] == [r["i"] for r in want]
    for g, w in zip(got, want):
        assert abs(g["cos_exact_vs_gds2"] - w["cos_exact_vs_gds2"]) <= (
            1e-4 + 1e-9), (g, w)
    # the port's own draws: as many rows, cosines in [-1, 1]
    own = E.grad_cosines(tp, n=2, seed=1)
    assert len(own) == 2
    assert all(-1 <= r["cos_exact_vs_gds2"] <= 1 for r in own)


def test_tiny_evaluation_writes_the_jax_files(pair, tmp_path):
    _, tp = pair
    res = E.run(tp, str(tmp_path), steps=3, limit=1, num_seeds=1, n_cos=2)
    with open(tmp_path / "verdict.json") as f:
        verdict = json.load(f)
    assert verdict == res["verdict"]
    assert set(verdict) == {
        "steering_real", "plain_min", "exact_ours_min", "gds2_ours_min",
        "bf16_ours_min", "grad_cos_exact_vs_gds2_min",
        "grad_cos_exact_vs_gds2_mean", "protocol"}
    assert verdict["protocol"] == ("3 steps, CFG 8.5, inject 0.2/0.3, "
                                   "weight 1, limit 1 x 1 seeds, trained "
                                   "fixture")
    for name in E.CONFIGS:
        with open(tmp_path / f"summary_{name}.json") as f:
            s = json.load(f)
        assert s["ours_min"]["n"] == s["plain_min"]["n"] == 1
        assert np.isfinite(verdict[f"{name}_ours_min"])
    # every configuration starts from the same plain image
    plains = {res["summaries"][n]["plain_min"]["mean"] for n in E.CONFIGS}
    assert len(plains) == 1
    with open(tmp_path / "grad_cosine.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["i"] for r in rows] == [0, 1]
    assert set(res["seconds"]) == set(E.CONFIGS)
