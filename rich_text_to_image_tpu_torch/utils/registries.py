"""Attention-layer registries + resolution bookkeeping.

Mirrors utils/attention_utils.py:12-67 of the reference. Names match our
UNet's ``layer_name`` strings exactly (which in turn match the reference's
module paths).
"""

from __future__ import annotations

from ..models.config import UNetConfig

SelfAttentionLayers = [
    "down_blocks.0.attentions.0.transformer_blocks.0.attn1",
    "down_blocks.0.attentions.1.transformer_blocks.0.attn1",
    "down_blocks.1.attentions.0.transformer_blocks.0.attn1",
    "down_blocks.1.attentions.1.transformer_blocks.0.attn1",
    "down_blocks.2.attentions.0.transformer_blocks.0.attn1",
    "down_blocks.2.attentions.1.transformer_blocks.0.attn1",
    "mid_block.attentions.0.transformer_blocks.0.attn1",
    "up_blocks.1.attentions.0.transformer_blocks.0.attn1",
    "up_blocks.1.attentions.1.transformer_blocks.0.attn1",
    "up_blocks.1.attentions.2.transformer_blocks.0.attn1",
    "up_blocks.2.attentions.0.transformer_blocks.0.attn1",
    "up_blocks.2.attentions.1.transformer_blocks.0.attn1",
    "up_blocks.2.attentions.2.transformer_blocks.0.attn1",
    "up_blocks.3.attentions.0.transformer_blocks.0.attn1",
    "up_blocks.3.attentions.1.transformer_blocks.0.attn1",
    "up_blocks.3.attentions.2.transformer_blocks.0.attn1",
]

CrossAttentionLayers = [
    "down_blocks.1.attentions.0.transformer_blocks.0.attn2",
    "down_blocks.2.attentions.0.transformer_blocks.0.attn2",
    "down_blocks.2.attentions.1.transformer_blocks.0.attn2",
    "mid_block.attentions.0.transformer_blocks.0.attn2",
    "up_blocks.1.attentions.0.transformer_blocks.0.attn2",
    "up_blocks.1.attentions.1.transformer_blocks.0.attn2",
    "up_blocks.1.attentions.2.transformer_blocks.0.attn2",
    "up_blocks.2.attentions.1.transformer_blocks.0.attn2",
]

CrossAttentionLayers_XL = [
    "down_blocks.2.attentions.1.transformer_blocks.3.attn2",
    "down_blocks.2.attentions.1.transformer_blocks.4.attn2",
    "mid_block.attentions.0.transformer_blocks.0.attn2",
    "mid_block.attentions.0.transformer_blocks.1.attn2",
    "mid_block.attentions.0.transformer_blocks.2.attn2",
    "mid_block.attentions.0.transformer_blocks.3.attn2",
    "up_blocks.0.attentions.0.transformer_blocks.1.attn2",
    "up_blocks.0.attentions.0.transformer_blocks.2.attn2",
    "up_blocks.0.attentions.0.transformer_blocks.3.attn2",
    "up_blocks.0.attentions.0.transformer_blocks.4.attn2",
    "up_blocks.0.attentions.0.transformer_blocks.5.attn2",
    "up_blocks.0.attentions.0.transformer_blocks.6.attn2",
    "up_blocks.0.attentions.0.transformer_blocks.7.attn2",
    "up_blocks.1.attentions.0.transformer_blocks.0.attn2",
]


def attn_layer_resolutions(cfg: UNetConfig, latent_hw: tuple[int, int]):
    """{layer_name: spatial_resolution} for every attn1/attn2 in the UNet.

    Down level l runs at latent/2^l; up level l at latent/2^(L-1-l); mid at
    the bottom resolution. Resolutions count rows: a rectangular latent maps
    by its height, and a level's width follows the latent's aspect.
    """
    L = len(cfg.block_out_channels)
    res: dict[str, int] = {}
    h = latent_hw[0]

    def add(prefix, n_attn, depth, r):
        for a in range(n_attn):
            for t in range(depth):
                for which in ("attn1", "attn2"):
                    res[f"{prefix}.attentions.{a}.transformer_blocks.{t}.{which}"] = r

    for lvl, btype in enumerate(cfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            add(f"down_blocks.{lvl}", cfg.layers_per_block,
                cfg.transformer_layers_per_block[lvl], h // (2**lvl))
    add("mid_block", 1, cfg.transformer_layers_per_block[-1], h // (2 ** (L - 1)))
    for lvl, btype in enumerate(cfg.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            r = h // (2 ** (L - 1 - lvl))
            depth_rev = list(reversed(cfg.transformer_layers_per_block))[lvl]
            add(f"up_blocks.{lvl}", cfg.layers_per_block + 1, depth_rev, r)
    return res
