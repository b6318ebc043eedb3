"""The port's FLOP count (``utils/flops.py``) against analytic counts and
against the JAX package's.

``FlopCounterMode`` counts matrix products and convolutions, two FLOPs a
multiply-add, on the meta device:

  * an ``nn.Linear`` and an ``nn.Conv2d`` (stride 1 and 2) exactly as their
    analytic counts;
  * the full SD-1.5 UNet forward at B = 2 (64^2 latent) within 1% of the
    sum of its products written out from the config below (the linear and
    convolution layers, the two attention products of every attention
    layer); they agree exactly;
  * the TINY UNet forward against the JAX package's ``unet_fwd_flops``, which
    reads XLA's cost model of the compiled program: the port counts 10.9%
    more at B = 2 (1.1088 on the CPU here; 1.1088 at B = 1), the down path
    alone 7.7% more. XLA adds the elementwise work the port does not count,
    but rewrites the products it counts (convolutions and dots with a size-1
    dimension folded or simplified away), which takes off more. The test
    holds the ratio to [1.0, 1.2] and the port's count to be linear in the
    batch.
"""

import types

import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.models.unet import UNet2DCondition as JUNet
from rich_text_to_image_tpu.utils import flops as JF
from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
from rich_text_to_image_tpu_torch.utils import flops as TF
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)


def test_linear_and_conv_exactly():
    with torch.device("meta"):
        lin = nn.Linear(96, 40)
        conv = nn.Conv2d(12, 20, 3, padding=1)
        down = nn.Conv2d(12, 20, 3, stride=2, padding=1)
        x = torch.empty(7, 5, 96)
        img = torch.empty(3, 12, 16, 10)
    assert TF.count_flops(lambda: lin(x)) == 2 * 7 * 5 * 96 * 40
    assert TF.count_flops(lambda: conv(img)) == 2 * 3 * 20 * 16 * 10 * 12 * 9
    assert TF.count_flops(lambda: down(img)) == 2 * 3 * 20 * 8 * 5 * 12 * 9


def analytic_unet_flops(cfg, B: int) -> int:
    """The products of one forward of ``cfg``'s UNet, written out."""
    h = cfg.sample_size
    ctx, L = cfg.cross_attention_dim, len(cfg.block_out_channels)
    ch0, temb = cfg.block_out_channels[0], cfg.time_embed_dim

    def conv(cin, cout, k, side):
        return 2 * B * side * side * cin * cout * k * k

    def lin(rows, cin, cout):
        return 2 * rows * cin * cout

    def resnet(cin, cout, side):
        f = conv(cin, cout, 3, side) + conv(cout, cout, 3, side)
        f += lin(B, temb, cout)
        return f + (conv(cin, cout, 1, side) if cin != cout else 0)

    def transformer(c, side, depth):
        s = side * side
        f = 2 * lin(B * s, c, c)  # proj_in, proj_out
        per = (4 * lin(B * s, c, c) + 2 * 2 * B * s * s * c  # attn1
               + 2 * lin(B * s, c, c) + 2 * lin(B * 77, ctx, c)  # attn2
               + 2 * 2 * B * s * 77 * c
               + lin(B * s, c, 8 * c) + lin(B * s, 4 * c, c))  # feed-forward
        return f + depth * per

    depth = cfg.transformer_layers_per_block
    total = lin(B, ch0, temb) + lin(B, temb, temb) + conv(4, ch0, 3, h)
    skips, prev, side = [ch0], ch0, h
    for lvl, btype in enumerate(cfg.down_block_types):
        ch = cfg.block_out_channels[lvl]
        for i in range(cfg.layers_per_block):
            total += resnet(prev if i == 0 else ch, ch, side)
            if btype.startswith("CrossAttn"):
                total += transformer(ch, side, depth[lvl])
            skips.append(ch)
        prev = ch
        if lvl != L - 1:
            side //= 2
            total += conv(ch, ch, 3, side)  # stride 2: the output's size
            skips.append(ch)
    total += 2 * resnet(prev, prev, side) + transformer(prev, side, depth[-1])
    for lvl, btype in enumerate(cfg.up_block_types):
        ch = cfg.block_out_channels[L - 1 - lvl]
        for i in range(cfg.layers_per_block + 1):
            total += resnet((prev if i == 0 else ch) + skips.pop(), ch, side)
            if btype.startswith("CrossAttn"):
                total += transformer(ch, side, depth[L - 1 - lvl])
        prev = ch
        if lvl != L - 1:
            side *= 2
            total += conv(ch, ch, 3, side)
    return total + conv(ch0, cfg.out_channels, 3, h)


def _port_model(cfg):
    with torch.device("meta"):
        unet = UNet2DCondition(cfg)
    return types.SimpleNamespace(unet_cfg=cfg, unet=unet.to(torch.bfloat16))


def test_sd15_forward_matches_its_products():
    got = TF.unet_fwd_flops(_port_model(C.SD15_UNET), 2, False)
    want = analytic_unet_flops(C.SD15_UNET, 2)
    assert got == pytest.approx(want, rel=1e-2)
    assert 1.5e12 < got < 1.7e12  # ~0.8 TFLOP a row at 64^2


def test_tiny_forward_against_jax():
    cfg = C.TINY_UNET
    ju = JUNet(cfg, dtype=jnp.float32)
    h = cfg.sample_size
    params = jax.eval_shape(lambda: ju.init(
        jax.random.PRNGKey(0), jnp.zeros((1, h, h, 4)), jnp.int32(0),
        jnp.zeros((1, 77, cfg.cross_attention_dim))))
    jm = types.SimpleNamespace(unet_cfg=cfg, unet=ju, unet_params=params)
    tm = _port_model(cfg)
    one = TF.unet_fwd_flops(tm, 1, False)
    assert TF.unet_fwd_flops(tm, 2, False) == 2 * one
    # at the 1x1 level an attention product over one key is elementwise,
    # and the counter does not count it: 128 FLOPs a row
    assert one == pytest.approx(analytic_unet_flops(cfg, 1), rel=1e-5)
    ratio = 2 * one / JF.unet_fwd_flops(jm, 2, False)
    assert 1.0 <= ratio <= 1.2, ratio
    ratio = (TF.unet_encode_flops(tm, 2, False)
             / JF.unet_encode_flops(jm, 2, False))
    assert 1.0 <= ratio <= 1.2, ratio
