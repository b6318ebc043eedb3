"""Diffusion fine-tuning step (ε-prediction MSE), on one device or a mesh.

Counterpart of ``rich_text_to_image_tpu/training/train_step.py`` (the
reference is inference-only; the JAX package added training). Under a mesh
(``parallel/mesh.py``) each batch rank takes its block of the batch's rows
and the gradients are summed over the batch ranks, which gives the whole
batch's mean; tensor parallelism shards the UNet's weights and gathers their
outputs (``parallel/tp.py``), whose backward hands each shard its gradient.

Attention runs through the plain PyTorch ops (``ops.attention.
plain_attention``): the hand-written kernels have no backward pass, as the
JAX package's Pallas kernels have none, and that package's step likewise
differentiates only where its dispatch sends attention to XLA. Parameters
are float32; on the card the forward computes in ``dtype`` under
``torch.autocast``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.config import UNetConfig
from ..models.unet import UNet2DCondition
from ..ops.attention import plain_attention
from ..schedulers.common import make_alphas_cumprod
from .. import weights


@dataclasses.dataclass
class TrainState:
    module: UNet2DCondition
    optimizer: torch.optim.Optimizer
    step: int = 0


def draw_t_noise(gen: torch.Generator, shape, device):
    """The step's timesteps [B] in [0, 1000) and standard-normal noise of
    ``shape``, drawn for the whole batch from ``gen``."""
    t = torch.randint(0, 1000, (shape[0],), generator=gen, device=gen.device)
    noise = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return t.to(device), noise.to(device)


def make_train_step(unet_cfg: UNetConfig, learning_rate: float = 1e-5,
                    dtype=torch.bfloat16, mesh=None, device="cuda"):
    """Returns ``(init_fn, train_step)`` for the UNet's denoising score
    matching.

    ``init_fn(seed=0, unet=None)`` -> :class:`TrainState`: ``unet`` (moved
    to the device in float32), or random weights drawn on the device from
    ``seed``; sharded over the mesh's tp axis; AdamW (betas 0.9, 0.999, eps
    1e-8, weight decay 1e-2, decoupled: optax's ``adamw``).

    ``train_step(state, latents [B,h,w,4], ehs [B,77,D], gen)`` -> (state,
    loss): every rank passes the whole batch; ``gen`` draws ``t`` and the
    noise for the whole batch (:func:`draw_t_noise`)."""
    dev = torch.device(device)
    alphas = torch.as_tensor(make_alphas_cumprod(), dtype=torch.float32,
                             device=dev)
    autocast = dtype != torch.float32

    def init_fn(seed: int = 0, unet: UNet2DCondition | None = None):
        if unet is None:
            with torch.device("meta"):
                unet = UNet2DCondition(unet_cfg)
            unet = weights.random_init_device(
                unet.to_empty(device=dev), seed)
        unet = unet.to(device=dev, dtype=torch.float32).train()
        unet.requires_grad_(True)
        if mesh is not None:
            from ..parallel.mesh import shard_params

            shard_params(unet, mesh)
        opt = torch.optim.AdamW(unet.parameters(), lr=learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-2)
        return TrainState(unet, opt, 0)

    def train_step(state: TrainState, latents, ehs, gen: torch.Generator):
        latents = torch.as_tensor(latents, dtype=torch.float32, device=dev)
        ehs = torch.as_tensor(ehs, dtype=torch.float32, device=dev)
        t, noise = draw_t_noise(gen, latents.shape, dev)
        total = noise.numel()
        if mesh is not None:
            if latents.shape[0] < mesh.batch_size:
                raise ValueError(f"batch of {latents.shape[0]} rows over "
                                 f"{mesh.batch_size} batch ranks")
            lo, hi = mesh.rows(latents.shape[0])
            latents, ehs, t, noise = (a[lo:hi]
                                      for a in (latents, ehs, t, noise))
        a = alphas[t][:, None, None, None]
        x_t = torch.sqrt(a) * latents + torch.sqrt(1.0 - a) * noise
        with plain_attention(), torch.autocast(dev.type, dtype=dtype,
                                               enabled=autocast):
            eps, _ = state.module(x_t, t, ehs)
        # the local rows' share of the whole batch's mean
        loss = ((eps.float() - noise) ** 2).sum() / total
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            from ..parallel.mesh import all_reduce_sum, batch_spec

            group = batch_spec(mesh)
            for p in state.module.parameters():
                if p.grad is not None:
                    all_reduce_sum(p.grad, group)
            all_reduce_sum(loss, group)
        state.optimizer.step()
        state.step += 1
        return state, loss

    return init_fn, train_step

