"""Host pieces the rich pass shares: the encoder-reuse key steps and the
refer-precompute cache's validity guard and memory budget.

Counterpart of ``rich_text_to_image_tpu/pipelines/base.py`` without its mesh
placement and jitted decode (the port runs on one card and decodes with the
pipeline's own VAE).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.unet import INJECT_RESNET_NAME, Attention, ResnetBlock2D

# Bytes the refer-precompute cache may take: the JAX package's budget for
# the (Q, K)/resnet slots, kept so that both packages take the same flow for
# the same request. It is that package's choice, not a measurement of the
# card's memory.
REF_PRECOMPUTE_MAX_BYTES = 6e9


def encoder_key_gates(num_steps: int, stride: int,
                      schedule: str = "early") -> np.ndarray:
    """Key-step gates of the encoder-reuse turbo (arXiv 2312.09608 §4): on
    a key step the UNet's down path runs, between key steps its cached
    output feeds the decoder. ``uniform`` takes every ``stride``-th step;
    ``early`` (the default) takes as many steps on a power curve that is
    denser at high noise. Step 0 is always a key step."""
    S = int(num_steps)
    stride = max(int(stride), 1)
    gates = np.zeros(S, bool)
    if stride == 1:
        gates[:] = True
        return gates
    n = len(range(0, S, stride))
    if schedule == "uniform":
        gates[::stride] = True
        return gates
    if schedule != "early":
        raise ValueError(f"unknown encoder-reuse schedule: {schedule!r}")
    idx = set(np.floor(S * (np.arange(n) / n) ** 1.5).astype(int).tolist())
    # the curve may put two early steps on one index: fill from the front
    # so that the count stays uniform's
    for i in range(S):
        if len(idx) >= n:
            break
        idx.add(i)
    gates[sorted(idx)] = True
    return gates


@torch.no_grad()
def ref_fingerprint(*tensors) -> tuple:
    """(sum, sum of squares) in float32 of each tensor: what a refer cache
    records of the initial latent and of the uncond and base prompt rows,
    so that a rich pass of another seed or prompt does not take it."""
    out = []
    for t in tensors:
        t32 = torch.as_tensor(t).float()
        out += [t32.sum(), (t32 * t32).sum()]
    return tuple(float(v) for v in torch.stack(out).cpu().numpy())


def ref_cache_matches(cache: dict, want_steps, num_steps: int,
                      guidance_scale: float, latent_hw, fp) -> bool:
    """Whether a refer cache fits this rich run: the injection steps, the
    trajectory's length, the guidance scale, the latent size and the
    fingerprint must all match; on any mismatch the caller runs the
    in-batch flow."""
    if tuple(cache.get("steps", ())) != tuple(want_steps):
        return False
    if cache["traj"].shape[0] != num_steps + 1:
        return False
    if cache.get("g") is None or float(cache["g"]) != float(guidance_scale):
        return False
    if tuple(cache.get("hw", ())) != tuple(latent_hw):
        return False
    old = cache.get("fp")
    if old is None or len(old) != len(fp):
        return False
    return bool(np.allclose(np.asarray(old), np.asarray(fp),
                            rtol=1e-4, atol=1e-6))


def _level_size(n: int, downs: int) -> int:
    for _ in range(downs):
        n = (n + 1) // 2  # a stride-2 3x3 convolution with padding 1
    return n


def _downs(cfg, layer_name: str) -> int:
    """How many times the latent was halved where ``layer_name`` runs."""
    L = len(cfg.block_out_channels)
    part, _, rest = layer_name.partition(".")
    if part == "mid_block":
        return L - 1
    lvl = int(rest.split(".")[0])
    return lvl if part == "down_blocks" else L - 1 - lvl


def ref_qk_bytes_per_slot(unet, latent_hw) -> int:
    """Bytes one refer-cache slot holds: the cond row's (Q, K) of every
    self-attention layer and the feature of :data:`INJECT_RESNET_NAME`, at
    the UNet's dtype, from the modules' widths and the latent size alone
    (no forward runs; a UNet on the meta device will do)."""
    h, w = latent_hw
    item = torch.empty((), dtype=unet.dtype).element_size()
    total = 0

    def tokens(name):
        k = _downs(unet.cfg, name)
        return _level_size(h, k) * _level_size(w, k)

    for m in unet.modules():
        if isinstance(m, Attention) and m.layer_name.endswith(".attn1"):
            total += 2 * tokens(m.layer_name) * m.dim * item
        elif (isinstance(m, ResnetBlock2D)
              and m.layer_name == INJECT_RESNET_NAME):
            total += tokens(m.layer_name) * m.conv2.out_channels * item
    return total
