"""The port's training step against the JAX package's ``make_train_step``,
and under a mesh against itself on one rank.

Both packages start from the same TINY_UNET parameters (JAX's
``fast_init``, through the bridge) and take three AdamW steps at lr 1e-3
on one batch of 3 rows, float32 on the CPU. The port's timesteps and noise are JAX's draws
for each step's key (``train_step.draw_t_noise`` handed them), so both
optimise the same losses:

  * the first step's loss and every parameter's gradient within 1e-4 of
    scale (the JAX gradient read from AdamW's first moment after the step,
    (1 - 0.9)·g); the loss after three steps within 1e-3
    relative; the parameters after one and after three steps within
    2·lr·steps of each other plus 1e-4 of scale — Adam moves a parameter by
    about lr a step whatever its gradient's size, so a gradient near zero
    whose sign the two packages' float32 sums set differently moves it by
    up to 2·lr the other way;
  * the loss falls over the three steps;
  * in 2 spawned ranks (``tests/torch_port_ranks.py``): the same steps at
    dp = 2 (the 3 rows in blocks of 2 and 1) and at tp = 2 (the weights
    that the rule shards split over the ranks, each shard's gradient its
    block of the whole) against the port's single-rank step: losses and
    gradients within 1e-5 of scale, and at tp = 2, where the attention
    runs on each rank's own heads, the first step against JAX's within
    1e-4. A gather whose backward summed over the tp ranks would double
    every sharded weight's gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.models.init_utils import fast_init
from rich_text_to_image_tpu.models.unet import UNet2DCondition as JUNet
from rich_text_to_image_tpu.training.train_step import TrainState
from rich_text_to_image_tpu.training.train_step import (
    make_train_step as j_make_train_step)
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
from rich_text_to_image_tpu_torch.training import train_step as TS
from torch_port_pipes import close
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)
import torch_port_ranks as R

LR, B, STEPS = 1e-3, 3, 3


def _jax_draw(key, shape):
    """The t and noise JAX's loss draws from the step's key."""
    rt, rn = jax.random.split(key)
    t = jax.random.randint(rt, (shape[0],), 0, 1000)
    noise = jax.random.normal(rn, shape, dtype=jnp.float32)
    return np.asarray(t).astype(np.int64), np.array(noise)


def _port_run(unet_sd, draws, latents, ehs, monkeypatch, mesh=None):
    queue = list(draws)
    monkeypatch.setattr(TS, "draw_t_noise", lambda gen, shape, device: tuple(
        torch.from_numpy(a) for a in queue.pop(0)))
    init_fn, step = TS.make_train_step(R.port_cfg(C.TINY_UNET),
                                       learning_rate=LR, dtype=torch.float32,
                                       device="cpu")
    unet = UNet2DCondition(R.port_cfg(C.TINY_UNET))
    unet.load_state_dict(unet_sd)
    state = init_fn(unet=unet)
    out = {"losses": [], "params": []}
    for i in range(STEPS):
        state, loss = step(state, latents, ehs, None)
        out["losses"].append(float(loss))
        if i == 0:
            out["grads"] = {n: p.grad.numpy().copy()
                            for n, p in state.module.named_parameters()}
        out["params"].append({n: p.detach().numpy().copy()
                              for n, p in state.module.state_dict().items()})
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    _, jstep = j_make_train_step(C.TINY_UNET, learning_rate=LR,
                                 dtype=jnp.float32)
    # the step's own state on fast_init's parameters (flax's eager init
    # takes ten times as long): optax's adamw as make_train_step builds it
    params = fast_init(JUNet(C.TINY_UNET, dtype=jnp.float32), 0,
                       jnp.zeros((1, 8, 8, 4)), jnp.int32(0),
                       jnp.zeros((1, 77, 32)))
    state = TrainState(params, optax.adamw(LR, weight_decay=1e-2).init(params),
                       jnp.int32(0))
    rng = np.random.default_rng(2)
    latents = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    ehs = rng.standard_normal((B, 77, 32)).astype(np.float32)
    keys = [jax.random.PRNGKey(10 + i) for i in range(STEPS)]
    draws = [_jax_draw(k, latents.shape) for k in keys]
    tu = weights.load_flax(UNet2DCondition(R.port_cfg(C.TINY_UNET)),
                           jax.tree.map(np.asarray, state.params), "unet")
    unet_sd = {k: v.clone() for k, v in tu.state_dict().items()}
    group = R.start(R.train_checks, 2, tmp_path_factory.mktemp("train"), {
        "unet": unet_sd, "unet_cfg": R.port_cfg(C.TINY_UNET), "lr": LR,
        "draws": draws, "latents": latents, "ehs": ehs})

    # JAX: the steps; the first step's gradient from AdamW's first moment
    # after it, (1 - b1)·g with b1 = 0.9 (optax's state: scale_by_adam's,
    # first in adamw's chain)
    step = jax.jit(jstep)
    jax_out = {"losses": [], "params": []}
    for i, k in enumerate(keys):
        state, loss = step(state, jnp.asarray(latents), jnp.asarray(ehs), k)
        jax_out["losses"].append(float(loss))
        jax_out["params"].append(weights.from_flax(
            jax.tree.map(np.asarray, state.params), "unet"))
        if i == 0:
            jax_out["grads"] = weights.from_flax(jax.tree.map(
                lambda m: np.asarray(m) / np.float32(0.1),
                state.opt_state[0].mu), "unet")
    return unet_sd, draws, latents, ehs, jax_out, group


@pytest.fixture(scope="module")
def port(setup):
    unet_sd, draws, latents, ehs, _, _ = setup
    with pytest.MonkeyPatch.context() as mp:
        return _port_run(unet_sd, draws, latents, ehs, mp)


def _adam_bound(got, want, steps):
    want = np.asarray(want)
    atol = 2 * LR * steps + 1e-4 * max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_first_step_matches_jax(setup, port):
    *_, jax_out, _ = setup
    close(port["losses"][0], jax_out["losses"][0], 1e-4)
    assert port["grads"].keys() == jax_out["grads"].keys()
    for n, g in jax_out["grads"].items():
        close(port["grads"][n], g.numpy(), 1e-4)


def test_three_steps_match_jax(setup, port):
    *_, jax_out, _ = setup
    np.testing.assert_allclose(port["losses"][-1], jax_out["losses"][-1],
                               rtol=1e-3)
    for i in (0, STEPS - 1):
        for n, p in jax_out["params"][i].items():
            _adam_bound(port["params"][i][n], p.numpy(), i + 1)


def test_loss_falls(port):
    losses = port["losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("mesh", ["dp2", "tp2"])
def test_mesh_steps_match_one_rank(setup, port, mesh):
    res = setup[-1].results()
    for r in res:
        got = r[mesh]
        np.testing.assert_allclose(got["losses"], port["losses"], rtol=1e-5)
    if mesh == "dp2":
        for r in res:
            _grads_close(r[mesh]["grads"], port["grads"])
        return
    # tp = 2: a sharded weight's gradient is its block of the whole
    sharded = res[0][mesh]["sharded"]
    assert len(sharded) > 10
    for r in res:
        got = {}
        for n, g in port["grads"].items():
            if n.rsplit(".", 1)[0] in sharded:
                got[n] = np.concatenate([q[mesh]["grads"][n] for q in res])
                # a backward that summed over the ranks would give 2 (the
                # 1x1 mid level's Q and K get none: one key a row)
                norm = np.linalg.norm(g)
                if norm > 0:
                    ratio = np.linalg.norm(got[n]) / norm
                    assert abs(ratio - 1) < 1e-4, (n, ratio)
            else:
                got[n] = r[mesh]["grads"][n]
        _grads_close(got, port["grads"])


def test_tp2_step_matches_jax(setup):
    """tp = 2, attention on each rank's own heads, against the JAX step
    itself: the first step's loss and every gradient (a tp shard's put
    back in its place) within 1e-4 of scale."""
    *_, jax_out, group = setup
    res = [r["tp2"] for r in group.results()]
    close(res[0]["losses"][0], jax_out["losses"][0], 1e-4)
    for n, g in jax_out["grads"].items():
        got = res[0]["grads"][n]
        if n.rsplit(".", 1)[0] in res[0]["sharded"]:
            got = np.concatenate([r["grads"][n] for r in res])
        close(got, g.numpy(), 1e-4)


def _grads_close(got, want, rel=1e-5):
    """Every gradient within ``rel`` of the scale of the whole gradient
    (its largest entry over all parameters)."""
    assert got.keys() == want.keys()
    scale = max(np.abs(g).max() for g in want.values())
    for n, g in want.items():
        np.testing.assert_allclose(got[n], g, rtol=0, atol=rel * scale,
                                   err_msg=n)
