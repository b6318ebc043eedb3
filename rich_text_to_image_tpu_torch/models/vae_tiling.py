"""Tiled and sliced VAE decoding, in PyTorch.

Counterpart of ``rich_text_to_image_tpu/models/vae_tiling.py`` (diffusers'
``AutoencoderKL.tiled_decode`` behind ``enable_vae_tiling``): the latent is
cut into overlapping tiles, each decoded alone, and the seams blended
linearly. As in the JAX package the latent is first padded at its bottom
and right edges by repeating the edge up to a whole number of tile strides,
so that every tile has one shape; the image is cropped back at the end.
``sliced_decode`` decodes one batch row at a time (``enable_vae_slicing``).
Tensors stay on their device; layouts are NHWC.
"""

from __future__ import annotations

import torch


def _blend_v(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """The bottom ``extent`` rows of a blended into the top rows of b."""
    extent = min(a.shape[1], b.shape[1], extent)
    if extent <= 0:
        return b
    w = (torch.arange(extent, device=b.device, dtype=b.dtype)
         / extent)[None, :, None, None]
    out = b.clone()
    out[:, :extent] = a[:, a.shape[1] - extent:] * (1 - w) + b[:, :extent] * w
    return out


def _blend_h(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """The right ``extent`` columns of a blended into the left ones of b."""
    extent = min(a.shape[2], b.shape[2], extent)
    if extent <= 0:
        return b
    w = (torch.arange(extent, device=b.device, dtype=b.dtype)
         / extent)[None, None, :, None]
    out = b.clone()
    out[:, :, :extent] = (a[:, :, a.shape[2] - extent:] * (1 - w)
                          + b[:, :, :extent] * w)
    return out


def _edge_pad(z: torch.Tensor, need_h: int, need_w: int) -> torch.Tensor:
    """z [B, h, w, C] grown to [B, need_h, need_w, C] by repeating its last
    row and column."""
    rows = torch.arange(need_h, device=z.device).clamp(max=z.shape[1] - 1)
    cols = torch.arange(need_w, device=z.device).clamp(max=z.shape[2] - 1)
    return z[:, rows][:, :, cols]


def tiled_decode(decode_fn, z: torch.Tensor, tile_latent: int = 64,
                 overlap_factor: float = 0.25, scale: int = 8) -> torch.Tensor:
    """Decode the latent z [B, h, w, C] in overlapping tiles of
    ``tile_latent`` latent pixels; ``decode_fn`` takes a latent tile and
    returns its image [B, tile*scale, tile*scale, 3] in float. The strides,
    blend width and kept rows are diffusers' (overlap_size, blend_extent,
    row_limit)."""
    B, h, w, _ = z.shape
    if h <= tile_latent and w <= tile_latent:
        return decode_fn(z).float()
    stride = int(tile_latent * (1 - overlap_factor))
    blend = int(tile_latent * scale * overlap_factor)
    keep = tile_latent * scale - blend
    starts_i = list(range(0, h, stride))
    starts_j = list(range(0, w, stride))
    zp = _edge_pad(z, starts_i[-1] + tile_latent, starts_j[-1] + tile_latent)
    rows = [[decode_fn(zp[:, i:i + tile_latent, j:j + tile_latent]).float()
             for j in starts_j] for i in starts_i]
    # blend against the raw decoded neighbours, crop as each tile is kept:
    # diffusers' loop
    out_rows = []
    for i, row in enumerate(rows):
        kept = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_v(rows[i - 1][j], tile, blend)
            if j > 0:
                tile = _blend_h(row[j - 1], tile, blend)
            kept.append(tile[:, :keep, :keep])
        out_rows.append(torch.cat(kept, dim=2))
    return torch.cat(out_rows, dim=1)[:, :h * scale, :w * scale]


def sliced_decode(decode_fn, z: torch.Tensor) -> torch.Tensor:
    """Decode one batch row of z at a time."""
    if z.shape[0] == 1:
        return decode_fn(z).float()
    return torch.cat([decode_fn(z[i:i + 1]).float() for i in range(z.shape[0])],
                     dim=0)
