"""The port's DualTransformer2DModel against the JAX package's
DualTransformer2D, after ``tests/test_dual_transformer.py``.

The block alone and a whole UNet with ``dual_cross_attention=True`` (tiny
config, condition lengths 7 and 5) run on both packages on the same
parameters (``fast_init`` / ``init`` bridged by ``weights.load_flax``,
which also checks that the bridge covers every parameter of both streams)
and the same numpy inputs, float32 on the CPU, at mix ratios 0, 0.5 and 1
under both routings. Tolerance: 1e-4 of each output's scale, as the other
UNet parity tests (float32, sums in another order). A routing that is not
a permutation of (0, 1) raises in both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.models import unet as J
from rich_text_to_image_tpu.models.init_utils import fast_init
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models import unet as T
from torch_port_pipes import close
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

L0, L1 = 7, 5
MIXES = [0.0, 0.5, 1.0]
ROUTINGS = [(1, 0), (0, 1)]
# the capture names of both streams of one block
SELF = frozenset(f"down_blocks.1.attentions.0.transformers.{j}"
                 ".transformer_blocks.0.attn1" for j in (0, 1))
CROSS = frozenset(f"mid_block.attentions.0.transformers.{j}"
                  ".transformer_blocks.0.attn2" for j in (0, 1))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg(mix=0.5, index=(1, 0)):
    return dataclasses.replace(
        C.TINY_UNET, dual_cross_attention=True,
        dual_condition_lengths=(L0, L1), dual_transformer_index=index,
        dual_mix_ratio=mix)


def _jax_block(mix, index):
    return J.DualTransformer2D(
        heads=2, dim=16, depth=1, kv_dim=32, use_linear_projection=False,
        groups=8, condition_lengths=(L0, L1), transformer_index=index,
        mix_ratio=mix)


def _port_block(mix, index):
    cfg = dataclasses.replace(_cfg(mix, index), norm_num_groups=8,
                              cross_attention_dim=32,
                              use_linear_projection=False)
    return T.DualTransformer2DModel(cfg, 2, 16, 1, "blk")


@pytest.fixture(scope="module")
def block_params():
    args = (jnp.zeros((1, 4, 4, 16)), jnp.zeros((1, L0 + L1, 32)),
            J.UNetControls(), J.EMPTY_CAPTURE, None)
    return _jax_block(0.5, (1, 0)).init(jax.random.PRNGKey(0), *args)


@pytest.fixture(scope="module")
def unet_params():
    model = J.UNet2DCondition(_cfg(), dtype=jnp.float32)
    return fast_init(model, 0, jnp.zeros((1, 8, 8, 4)), jnp.int32(0),
                     jnp.zeros((1, L0 + L1, 32)), dtype=jnp.float32)


@pytest.mark.parametrize("index", ROUTINGS)
@pytest.mark.parametrize("mix", MIXES)
def test_block_matches_jax(block_params, mix, index):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)  # NHWC
    ctx = rng.standard_normal((2, L0 + L1, 32)).astype(np.float32)
    want = _jax_block(mix, index).apply(
        block_params, jnp.asarray(x), jnp.asarray(ctx), J.UNetControls(),
        J.EMPTY_CAPTURE, None)
    blk = weights.load_flax(_port_block(mix, index), _np(block_params),
                            "unet")
    with torch.no_grad():
        got = blk(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(ctx), None, T.EMPTY_CAPTURE, None)
    close(got.permute(0, 2, 3, 1).numpy(), want)


def test_block_routes_each_condition_to_its_stream(block_params):
    """At mix 1 the block is stream ``index[0]`` on the first L0 tokens,
    at mix 0 stream ``index[1]`` on the last L1 (reference :135, :145)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 16, 4, 4)).astype(
        np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, L0 + L1, 32)).astype(
        np.float32))
    args = (None, T.EMPTY_CAPTURE, None)
    with torch.no_grad():
        for mix, j, cond in ((1.0, 1, ctx[:, :L0]), (0.0, 0, ctx[:, L0:])):
            blk = weights.load_flax(_port_block(mix, (1, 0)),
                                    _np(block_params), "unet")
            got = blk(x, ctx, *args)
            direct = blk.transformers[j](x, cond, *args)
            close(got.numpy(), direct.numpy(), rel=1e-6)


@pytest.mark.parametrize("index", ROUTINGS)
@pytest.mark.parametrize("mix", MIXES)
def test_dual_unet_matches_jax(unet_params, mix, index):
    """A whole dual UNet forward with the capture of layers in both
    streams: eps and the captured maps."""
    cfg = _cfg(mix, index)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, L0 + L1, 32)).astype(np.float32)
    eps_j, aux_j = J.UNet2DCondition(cfg, dtype=jnp.float32).apply(
        unet_params, jnp.asarray(x), jnp.int32(300), jnp.asarray(ctx),
        capture=J.CaptureSpec(self_probs=SELF, cross_probs=CROSS))
    tu = weights.load_flax(T.UNet2DCondition(cfg), _np(unet_params), "unet")
    with torch.no_grad():
        eps_t, aux_t = tu(torch.from_numpy(x), 300, torch.from_numpy(ctx),
                          capture=T.CaptureSpec(self_probs=SELF,
                                                cross_probs=CROSS))
    close(eps_t.numpy(), eps_j)
    for kind, names in (("self_probs", SELF), ("cross_probs", CROSS)):
        assert set(aux_t[kind]) == set(aux_j[kind]) == names
        for n in names:
            close(aux_t[kind][n].numpy(), aux_j[kind][n])
    # the cross maps of the two streams see the two conditions
    assert {aux_t["cross_probs"][n].shape[-1] for n in CROSS} == {L0, L1}


def test_degenerate_transformer_index_raises_in_both():
    with pytest.raises(ValueError, match="permutation"):
        _jax_block(0.5, (0, 0)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 16)),
            jnp.zeros((1, L0 + L1, 32)), J.UNetControls(), J.EMPTY_CAPTURE,
            None)
    with pytest.raises(ValueError, match="permutation"):
        _port_block(0.5, (0, 0))
    with pytest.raises(ValueError, match="permutation"):
        T.UNet2DCondition(_cfg(index=(1, 1)))
