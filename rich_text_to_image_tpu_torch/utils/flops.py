"""Model FLOPs of the pipeline's programs, counted without executing them.

Counterpart of ``rich_text_to_image_tpu/utils/flops.py``. That module reads
XLA's cost model of the compiled programs; here
``torch.utils.flop_counter.FlopCounterMode`` counts the forward on the
``meta`` device, where no kernel runs and no memory is filled. The two
counts differ in kind: XLA's adds elementwise work (norms, activations,
softmax), ``FlopCounterMode`` counts matrix products and convolutions only,
two FLOPs a multiply-add. Attention is counted under
``ops.attention.plain_attention``: a launch of a hand-written kernel
through ``ctypes`` is invisible to the counter, the plain version's matrix
products are not.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models.unet import UNet2DCondition
from ..ops.attention import plain_attention

# Dense bf16 tensor-core peak of one card, keyed on substrings of
# ``torch.cuda.get_device_name()``: NVIDIA's data sheet for the H100 SXM at
# its 700 W limit (a card set below it runs slower).
PEAK_BF16 = {"H100": 989e12}


def peak_flops(device="cuda"):
    """(dense bf16 peak in FLOP/s, device name) of ``device`` (card 0 by
    default); the peak is None for a card the table does not name, and
    for a device that is not a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None, device.type
    kind = torch.cuda.get_device_name(device)
    for key, val in PEAK_BF16.items():
        if key in kind:
            return val, kind
    return None, kind


def _meta_unet(model) -> UNet2DCondition:
    """``model``'s UNet topology on the meta device, at its dtype."""
    with torch.device("meta"):
        unet = UNet2DCondition(model.unet_cfg)
    return unet.to(model.unet.dtype)


def count_flops(fn) -> float:
    """FLOPs of the matrix products and convolutions ``fn()`` runs (on the
    meta device: nothing executes), attention through the plain ops."""
    with torch.no_grad(), plain_attention():
        with FlopCounterMode(display=False) as counter:
            fn()
    return float(counter.get_total_flops())


def _inputs(model, unet, batch: int, xl: bool):
    ucfg = model.unet_cfg
    h = w = ucfg.sample_size
    dt = unet.dtype
    meta = dict(device="meta", dtype=dt)
    x = torch.empty((batch, h, w, ucfg.in_channels), **meta)
    e = torch.empty((batch, 77, ucfg.cross_attention_dim), **meta)
    added = None
    if xl:
        # the pooled width from the add_embedding itself (the config's
        # formula does not hold for the tiny test configs)
        pool = (unet.add_embedding.linear_1.in_features
                - 6 * ucfg.addition_time_embed_dim)
        added = {"text_embeds": torch.empty((batch, pool), **meta),
                 "time_ids": torch.empty((batch, 6), device="meta")}
    return x, e, added


def unet_fwd_flops(model, batch: int, xl: bool) -> float:
    """One UNet forward of ``batch`` rows at the model's native latent
    size."""
    unet = _meta_unet(model)
    x, e, added = _inputs(model, unet, batch, xl)
    t = torch.zeros((), device="meta")
    return count_flops(lambda: unet(x, t, e, added_cond=added))


def unet_encode_flops(model, batch: int, xl: bool) -> float:
    """The down path only (``conv_in`` and the down blocks): what encoder
    reuse skips on a step that is not a key step. A run of stride N does
    key_steps × fwd + (steps − key_steps) × (fwd − encode)."""
    unet = _meta_unet(model)
    x, e, _ = _inputs(model, unet, batch, xl)
    emb = torch.empty((batch, model.unet_cfg.time_embed_dim), device="meta",
                      dtype=unet.dtype)
    return count_flops(lambda: unet.encode(x, emb, e))


def _meta_vae(model):
    from ..models.vae import AutoencoderKL

    with torch.device("meta"):
        # the gradient goes to the latent only, as the guided step's does
        return AutoencoderKL(model.vae_cfg).requires_grad_(False)


def vae_decode_flops(model, batch: int = 1) -> float:
    """The float32 VAE decode of ``batch`` latents at the native size."""
    vae = _meta_vae(model)
    h = w = model.unet_cfg.sample_size
    z = torch.empty((batch, h, w, 4), device="meta")
    return count_flops(lambda: vae.decode(z))


def guidance_grad_flops(model, batch: int = 1) -> float:
    """The colour guidance's gradient program: the decode, the masked mean
    colour and its loss, forward and backward to the latent."""
    vae = _meta_vae(model)
    h = w = model.unet_cfg.sample_size
    px = h * model.vae_scale_factor
    m = torch.empty((1, px, px), device="meta")
    tgt = torch.empty((1, 3), device="meta")

    def run():
        with torch.enable_grad():
            z = torch.empty((batch, h, w, 4), device="meta",
                            requires_grad=True)
            imgs = vae.decode(z / model.vae_cfg.scaling_factor)
            imgs = (imgs / 2 + 0.5).clamp(0.0, 1.0)
            num = torch.einsum("bhwc,nhw->nc", imgs, m)
            den = m.sum(dim=(1, 2))[:, None] + 1e-12
            loss = (((num / den - tgt) ** 2).mean(dim=1) * 100.0).sum()
            torch.autograd.grad(loss, z)

    return count_flops(run)
