"""Initial latents drawn as the reference draws them, for seed parity.

The reference seeds torch's global generator and draws the initial latent
with ``torch.randn`` in NCHW (richtext_utils.py:22-27;
region_diffusion.py:90-91). Drawn on the CPU (MT19937 + Box-Muller) it is
bit-exact on any machine; a CUDA draw (Philox) is another sequence, so a
latent made on a card is passed in as an array instead (the pipelines take
``latents=`` everywhere). The port's layout is NHWC: the transpose happens
here, so a reference latent drops in unchanged.
"""

from __future__ import annotations

import numpy as np


def torch_randn_latents(seed: int, batch: int, channels: int, h: int, w: int):
    """NHWC float32 latents of ``torch.manual_seed(seed)``; ``torch.randn``
    on the CPU."""
    import torch

    torch.manual_seed(seed)
    lat = torch.randn(batch, channels, h, w)
    return np.asarray(lat.numpy().transpose(0, 2, 3, 1))


def load_latents_npy(path: str):
    """A saved reference latent (.npy, NCHW or NHWC) as NHWC float32."""
    arr = np.load(path)
    # the latent has 4 channels: NCHW iff axis 1 is 4 and the last is not
    if arr.ndim == 4 and arr.shape[1] == 4 and arr.shape[-1] != 4:
        arr = arr.transpose(0, 2, 3, 1)
    return arr.astype(np.float32)
