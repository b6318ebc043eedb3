"""The invisible watermark every SDXL image carries, in PyTorch.

Counterpart of ``rich_text_to_image_tpu/utils/watermark.py``: the 48-bit
diffusers message, one bit per 4x4 block of the level-1 Haar LL band of
the U chroma channel, quantization-index modulated into the block's mean
(scale 8, the bits tiled over the blocks in row-major order). Embedding is
a handful of elementwise torch ops on the images' device; images narrower
than 256 px pass through, as the reference encoder's own gate does.
``decode_watermark`` (host numpy) recovers the bits by a majority vote per
bit.
"""

from __future__ import annotations

import numpy as np
import torch

# diffusers' WATERMARK_MESSAGE (pipelines/stable_diffusion_xl/watermark.py)
WATERMARK_MESSAGE = 0b101100111110110010010000011110111011000110011110
WATERMARK_BITS = tuple(int(b) for b in bin(WATERMARK_MESSAGE)[2:])
SCALE = 8.0
BLOCK = 4
MIN_WIDTH = 256

# full-range BT.601 (the YUV pair of the invisible-watermark package)
_Y = (0.299, 0.587, 0.114)


def _tiled_bits(nb_r: int, nb_c: int) -> np.ndarray:
    n = nb_r * nb_c
    reps = -(-n // len(WATERMARK_BITS))
    flat = np.tile(np.asarray(WATERMARK_BITS, np.float32), reps)[:n]
    return flat.reshape(nb_r, nb_c)


@torch.no_grad()
def _embed_u8(images: torch.Tensor) -> torch.Tensor:
    f = images.float()
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = _Y[0] * r + _Y[1] * g + _Y[2] * b
    u = 0.492 * (b - y) + 128.0
    v = 0.877 * (r - y) + 128.0
    # crop to multiples of 8: the Haar band halves once, blocks need 4
    h8, w8 = (u.shape[-2] // 8) * 8, (u.shape[-1] // 8) * 8
    reg = u[..., :h8, :w8]
    ll = (reg[..., 0::2, 0::2] + reg[..., 0::2, 1::2]
          + reg[..., 1::2, 0::2] + reg[..., 1::2, 1::2]) * 0.5
    nb_r, nb_c = ll.shape[-2] // BLOCK, ll.shape[-1] // BLOCK
    means = ll.reshape(*ll.shape[:-2], nb_r, BLOCK, nb_c, BLOCK).mean(
        dim=(-3, -1))
    bits = torch.from_numpy(_tiled_bits(nb_r, nb_c)).to(images.device)
    # nearest centre of the bit's lattice, (k + 0.25 + 0.5 bit) * SCALE
    off = 0.25 + 0.5 * bits
    k = torch.round(means / SCALE - off)
    delta = (k + off) * SCALE - means
    # every pixel of a block's 8x8 footprint moved by delta / 2 moves each
    # LL coefficient by delta, hence the block mean
    shift = delta.repeat_interleave(2 * BLOCK, dim=-2).repeat_interleave(
        2 * BLOCK, dim=-1) * 0.5
    u = u.clone()
    u[..., :h8, :w8] += shift
    u, v = u - 128.0, v - 128.0
    r = y + v / 0.877
    b = y + u / 0.492
    g = (y - _Y[0] * r - _Y[2] * b) / _Y[1]
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.round(rgb).clamp(0, 255).to(torch.uint8)


def apply_watermark(images):
    """Watermark uint8 RGB images [B, H, W, 3] (a tensor, on any device, or
    numpy); images narrower than 256 px come back unchanged. Returns what
    it was given: a tensor on the same device, or numpy."""
    if images.shape[-2] < MIN_WIDTH:
        return images
    if isinstance(images, np.ndarray):
        return _embed_u8(torch.from_numpy(images)).numpy()
    return _embed_u8(images)


def decode_watermark(image_u8, scale: float = SCALE):
    """The 48 message bits of one watermarked uint8 RGB image [H, W, 3] by a
    majority vote per bit over the blocks; returns (bits, the smallest vote
    margin in [0, 1])."""
    f = np.asarray(image_u8, np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = _Y[0] * r + _Y[1] * g + _Y[2] * b
    u = 0.492 * (b - y) + 128.0
    h8, w8 = (u.shape[0] // 8) * 8, (u.shape[1] // 8) * 8
    reg = u[:h8, :w8]
    ll = (reg[0::2, 0::2] + reg[0::2, 1::2]
          + reg[1::2, 0::2] + reg[1::2, 1::2]) * 0.5
    nb_r, nb_c = ll.shape[0] // BLOCK, ll.shape[1] // BLOCK
    means = ll.reshape(nb_r, BLOCK, nb_c, BLOCK).mean(axis=(1, 3))
    # residues in (S/2, S) are nearer a bit-1 centre
    est = (means.reshape(-1) % scale > 0.5 * scale).astype(np.float32)
    n_bits = len(WATERMARK_BITS)
    idx = np.arange(len(est)) % n_bits
    votes = np.bincount(idx, weights=est, minlength=n_bits)
    counts = np.bincount(idx, minlength=n_bits).astype(np.float64)
    frac = votes / np.maximum(counts, 1)
    bits = tuple(int(x > 0.5) for x in frac)
    return bits, float(np.abs(frac - 0.5).min() * 2)
