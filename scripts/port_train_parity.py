"""Hold the port's training step against the JAX package's at SD-1.5 widths.

Each package takes the same AdamW steps (lr 1e-5 by default, decoupled
weight decay 1e-2) from the same parameters on the same batch, float32 on
the CPU, in a subprocess of its own, one after the other:

  * ``--side jax``: ``rich_text_to_image_tpu.training.train_step.
    make_train_step(SD15_UNET, dtype=float32)`` on ``fast_init``'s
    parameters (seed 0). It writes the parameters (flax paths), the batch
    and each step's draw of ``t`` and the noise (from ``PRNGKey(10 + i)``,
    as the step's loss draws them) to ``params.npz`` and ``batch.npz``, then
    its losses and the first step's gradient (read from AdamW's first
    moment, (1 - 0.9)·g) to ``jax.npz``;
  * ``--side port``: ``rich_text_to_image_tpu_torch.training.train_step.
    make_train_step`` on the same parameters (``weights.load_flax``), with
    JAX's draws handed in through ``draw_t_noise``. It prints one JSON
    line: both packages' losses, the first loss's and the last loss's
    relative difference, and the first step's gradients' max|Δ| relative
    to their scale (the largest |g| over every parameter).

The tolerances are those of ``tests/test_torch_port_train_step.py`` at
TINY widths: the first loss within 1e-4 relative, the last within 1e-3.
A one-off check outside the tests; at ``--latent 64`` the larger process
peaked at 32.8 GiB of resident memory on the CPU.

    python scripts/port_train_parity.py [--latent 32] [--batch 2]
        [--steps 3] [--lr 1e-5] [--dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST_RTOL, LAST_RTOL = 1e-4, 1e-3


def _flat(tree, prefix=()) -> dict:
    """{"a/b/c": leaf} of a nested mapping."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, leaf in flat.items():
        node = out
        *path, name = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


def jax_side(a) -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from rich_text_to_image_tpu.models import config as C
    from rich_text_to_image_tpu.models.init_utils import fast_init
    from rich_text_to_image_tpu.models.unet import UNet2DCondition
    from rich_text_to_image_tpu.training.train_step import (TrainState,
                                                            make_train_step)

    cfg = C.SD15_UNET
    hw = a.latent
    params = fast_init(UNet2DCondition(cfg, dtype=jnp.float32), 0,
                       jnp.zeros((1, hw, hw, 4)), jnp.int32(0),
                       jnp.zeros((1, 77, cfg.cross_attention_dim)))
    np.savez(os.path.join(a.dir, "params.npz"), **_flat(params))
    rng = np.random.default_rng(2)
    latents = rng.standard_normal((a.batch, hw, hw, 4)).astype(np.float32)
    ehs = rng.standard_normal(
        (a.batch, 77, cfg.cross_attention_dim)).astype(np.float32)
    keys = [jax.random.PRNGKey(10 + i) for i in range(a.steps)]
    draws = {}
    for i, k in enumerate(keys):  # as the step's loss_fn draws them
        rt, rn = jax.random.split(k)
        draws[f"t{i}"] = np.asarray(
            jax.random.randint(rt, (a.batch,), 0, 1000)).astype(np.int64)
        draws[f"noise{i}"] = np.asarray(
            jax.random.normal(rn, latents.shape, dtype=jnp.float32))
    np.savez(os.path.join(a.dir, "batch.npz"), latents=latents, ehs=ehs,
             **draws)

    _, step = make_train_step(cfg, learning_rate=a.lr, dtype=jnp.float32)
    state = TrainState(params, optax.adamw(a.lr, weight_decay=1e-2).init(
        params), jnp.int32(0))
    del params
    step = jax.jit(step, donate_argnums=(0,))
    losses, secs = [], []
    for i, k in enumerate(keys):
        t0 = time.time()
        state, loss = step(state, jnp.asarray(latents), jnp.asarray(ehs), k)
        losses.append(float(loss))
        secs.append(time.time() - t0)
        if i == 0:  # optax's adamw: scale_by_adam's state first in the chain
            grads = {f"grad/{n}": g / np.float32(0.1) for n, g in
                     _flat(state.opt_state[0].mu).items()}
        print(f"jax step {i}: loss {losses[-1]!r} ({secs[-1]:.1f} s)",
              flush=True)
    np.savez(os.path.join(a.dir, "jax.npz"), losses=np.asarray(losses),
             seconds=np.asarray(secs), **grads)


def port_side(a) -> dict:
    import torch

    from rich_text_to_image_tpu_torch import weights
    from rich_text_to_image_tpu_torch.models import config as C
    from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
    from rich_text_to_image_tpu_torch.training import train_step as TS

    with np.load(os.path.join(a.dir, "batch.npz")) as z:
        batch = {k: z[k] for k in z.files}
    draws = [(torch.from_numpy(batch[f"t{i}"]),
              torch.from_numpy(batch[f"noise{i}"])) for i in range(a.steps)]
    TS.draw_t_noise = lambda gen, shape, device: draws.pop(0)
    unet = UNet2DCondition(C.SD15_UNET)
    with np.load(os.path.join(a.dir, "params.npz")) as z:
        weights.load_flax(unet, _nest({k: z[k] for k in z.files}), "unet")
    init_fn, step = TS.make_train_step(C.SD15_UNET, learning_rate=a.lr,
                                       dtype=torch.float32, device="cpu")
    state = init_fn(unet=unet)
    losses, secs, grads = [], [], None
    for i in range(a.steps):
        t0 = time.time()
        state, loss = step(state, batch["latents"], batch["ehs"], None)
        losses.append(float(loss))
        secs.append(time.time() - t0)
        if i == 0:
            grads = {n: p.grad.numpy().copy()
                     for n, p in state.module.named_parameters()}
        print(f"port step {i}: loss {losses[-1]!r} ({secs[-1]:.1f} s)",
              flush=True)
    del state, unet
    with np.load(os.path.join(a.dir, "jax.npz")) as z:
        jax_losses = [float(x) for x in z["losses"]]
        jax_secs = [float(x) for x in z["seconds"]]
        want = weights.from_flax(_nest({k[len("grad/"):]: z[k] for k in
                                        z.files if k.startswith("grad/")}),
                                 "unet")
    scale = max(float(g.abs().max()) for g in want.values())
    worst, worst_name = 0.0, None
    for n, g in want.items():
        d = float(np.abs(grads[n] - g.numpy()).max())
        if d > worst:
            worst, worst_name = d, n
    rel = [abs(p - j) / abs(j) for p, j in zip(losses, jax_losses)]
    return {
        "config": {"unet": "SD15_UNET", "latent": [a.batch, a.latent,
                                                   a.latent, 4],
                   "lr": a.lr, "steps": a.steps, "dtype": "float32",
                   "device": "cpu"},
        "jax_losses": jax_losses, "port_losses": losses,
        "loss_rel_diff": rel,
        "grad_max_abs_diff_rel_scale": worst / scale,
        "grad_worst_param": worst_name, "grad_scale": scale,
        "jax_loss_rises_after_step_1": jax_losses[1] > jax_losses[0],
        "port_loss_rises_after_step_1": losses[1] > losses[0],
        "first_within": rel[0] <= FIRST_RTOL,
        "last_within": rel[-1] <= LAST_RTOL,
        "seconds_a_step": {"jax": jax_secs, "port": secs},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--side", choices=("jax", "port"))
    p.add_argument("--latent", type=int, default=32)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--dir", default=None,
                   help="where the sides exchange their arrays (a new "
                        "temporary directory by default)")
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    if a.side == "jax":
        jax_side(a)
        return 0
    if a.side == "port":
        print("RESULT " + json.dumps(port_side(a)), flush=True)
        return 0
    a.dir = a.dir or tempfile.mkdtemp(prefix="port_train_parity_")
    base = [sys.executable, os.path.abspath(__file__), "--latent",
            str(a.latent), "--batch", str(a.batch), "--steps", str(a.steps),
            "--lr", str(a.lr), "--dir", a.dir]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run(base + ["--side", "jax"], env=env, check=True)
    out = subprocess.run(base + ["--side", "port"], env=env, check=True,
                         capture_output=True, text=True)
    sys.stdout.write(out.stdout)
    res = json.loads(out.stdout.rsplit("RESULT ", 1)[1])
    print(json.dumps(res, indent=1))
    for name in ("params.npz", "batch.npz", "jax.npz"):
        os.remove(os.path.join(a.dir, name))
    os.rmdir(a.dir)
    return 0 if res["first_within"] and res["last_within"] else 1


if __name__ == "__main__":
    sys.exit(main())
