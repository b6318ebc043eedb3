"""The port's training step in bfloat16 against the JAX package's.

JAX's ``make_train_step(dtype=jnp.bfloat16)`` builds the flax UNet at
``dtype=bf16``: each layer casts its float32 parameters and its input to
bf16, so every activation is bf16. The port's ``make_train_step(dtype=
torch.bfloat16)`` runs the forward under ``torch.autocast``: matrix products
and convolutions in bf16, norms, softmax and the residual adds that meet a
norm's float32 output in float32. Both start from the same TINY_UNET
parameters (JAX's ``fast_init``, through the bridge) and take one AdamW step
at lr 1e-3 on one batch of 3 rows, on the CPU, with JAX's draw of ``t`` and
the noise handed to the port (``train_step.draw_t_noise``):

  * the loss within 2e-2 relative (measured: 2.2e-3);
  * every gradient within 5e-2 of the scale of the whole gradient, its
    largest entry over all parameters (measured: 1.96e-2; JAX's own bf16
    gradient is 2.3e-2 of that scale from its float32 one). Against each
    tensor's own largest entry the two differ by up to 0.146, as bf16
    rounding alone moves JAX's (0.117 between its bf16 and float32 steps),
    so that is not asserted. A port that cast as flax does (a bf16 copy of
    the parameters, every activation bf16) came no closer: 2.45e-2 of the
    whole scale, 0.134 of a tensor's own;
  * the parameters after the step within 2·lr plus 1e-4 of scale (Adam
    moves a parameter by about lr whatever its gradient's size).
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
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)
import torch_port_ranks as R

LR, B = 1e-3, 3
LOSS_RTOL, GRAD_TOL = 2e-2, 5e-2


@pytest.fixture(scope="module")
def steps():
    params = fast_init(JUNet(C.TINY_UNET, dtype=jnp.float32), 0,
                       jnp.zeros((1, 8, 8, 4)), jnp.int32(0),
                       jnp.zeros((1, 77, 32)))
    state = TrainState(params, optax.adamw(LR, weight_decay=1e-2).init(params),
                       jnp.int32(0))
    rng = np.random.default_rng(2)
    latents = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    ehs = rng.standard_normal((B, 77, 32)).astype(np.float32)
    key = jax.random.PRNGKey(10)
    rt, rn = jax.random.split(key)  # as the step's loss draws them
    t = np.asarray(jax.random.randint(rt, (B,), 0, 1000)).astype(np.int64)
    noise = np.array(jax.random.normal(rn, latents.shape, dtype=jnp.float32))

    _, jstep = j_make_train_step(C.TINY_UNET, learning_rate=LR,
                                 dtype=jnp.bfloat16)
    after, loss = jax.jit(jstep)(state, jnp.asarray(latents),
                                 jnp.asarray(ehs), key)
    jax_out = {
        "loss": float(loss),
        # AdamW's first moment after one step is (1 - 0.9)·g
        "grads": weights.from_flax(jax.tree.map(
            lambda m: np.asarray(m) / np.float32(0.1),
            after.opt_state[0].mu), "unet"),
        "params": weights.from_flax(jax.tree.map(np.asarray, after.params),
                                    "unet")}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TS, "draw_t_noise", lambda gen, shape, device: (
            torch.from_numpy(t), torch.from_numpy(noise)))
        init_fn, step = TS.make_train_step(R.port_cfg(C.TINY_UNET),
                                           learning_rate=LR,
                                           dtype=torch.bfloat16,
                                           device="cpu")
        unet = weights.load_flax(UNet2DCondition(R.port_cfg(C.TINY_UNET)),
                                 jax.tree.map(np.asarray, params), "unet")
        st, loss = step(init_fn(unet=unet), latents, ehs, None)
    port = {"loss": float(loss),
            "grads": {n: p.grad.numpy().copy()
                      for n, p in st.module.named_parameters()},
            "params": {n: p.detach().numpy().copy()
                       for n, p in st.module.named_parameters()}}
    return jax_out, port


def test_bf16_loss_matches_jax(steps):
    jax_out, port = steps
    np.testing.assert_allclose(port["loss"], jax_out["loss"], rtol=LOSS_RTOL)


def test_bf16_gradients_match_jax(steps):
    jax_out, port = steps
    want = jax_out["grads"]
    assert port["grads"].keys() == want.keys()
    scale = max(float(g.abs().max()) for g in want.values())
    for n, g in want.items():
        np.testing.assert_allclose(port["grads"][n], g.numpy(), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=n)


def test_bf16_step_moves_parameters_as_jax(steps):
    jax_out, port = steps
    for n, p in jax_out["params"].items():
        p = p.numpy()
        atol = 2 * LR + 1e-4 * max(np.abs(p).max(), 1e-6)
        np.testing.assert_allclose(port["params"][n], p, rtol=0, atol=atol,
                                   err_msg=n)
