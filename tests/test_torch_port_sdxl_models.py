"""The port's SDXL modules against the JAX package's: the text_time UNet,
the projected CLIP text tower, the SDXL attention-layer layout, and the
plain attention and capture at SDXL's head dim 64.

Both sides run in float32 on the CPU on the same numpy inputs and the same
parameters (the JAX trees mapped by ``weights.from_flax``). Tolerances:
1e-4 relative to each output's scale for the UNet and the text towers
(float32 through a few dozen layers whose sums run in another order), atol
1e-5 for the attention plain versions against the JAX kernels in interpret
mode (as tests/test_torch_port_attention.py holds the SD-1.5 head dims).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.models import clip as JC
from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.models import unet as J
from rich_text_to_image_tpu.models.init_utils import fast_init
from rich_text_to_image_tpu.ops import attention as JA
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models import clip as TC
from rich_text_to_image_tpu_torch.models import unet as T
from rich_text_to_image_tpu_torch.ops import attention as TA
from rich_text_to_image_tpu_torch.utils.registries import (
    CrossAttentionLayers_XL, attn_layer_resolutions)
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

# the JAX SDXL tests' tiny second tower (tests/test_pipeline_sdxl.py)
TEXT2 = C.CLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         hidden_act="gelu", projection_dim=32)
XL = C.TINY_XL_UNET
POOLED = 32
SELF = frozenset({"down_blocks.1.attentions.0.transformer_blocks.0.attn1",
                  "up_blocks.0.attentions.2.transformer_blocks.1.attn1"})
CROSS = frozenset({"down_blocks.2.attentions.1.transformer_blocks.1.attn2",
                   "mid_block.attentions.0.transformer_blocks.0.attn2"})


def _with_pooled(cfg, pooled: int):
    """``cfg`` whose ``add_embedding`` takes a pooled row ``pooled`` wide
    (the JAX package's Dense layer infers it from its first input)."""
    return dataclasses.replace(
        cfg, projection_class_embeddings_input_dim=(
            pooled + 6 * cfg.addition_time_embed_dim))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _added(b, seed=3):
    rng = np.random.default_rng(seed)
    pooled = rng.standard_normal((b, POOLED)).astype(np.float32)
    ids = np.tile(np.asarray([[32, 48, 0, 0, 32, 48]], np.float32), (b, 1))
    return pooled, ids


@pytest.fixture(scope="module")
def xl_unet():
    ju = J.UNet2DCondition(XL, dtype=jnp.float32)
    params = fast_init(
        ju, 0, jnp.zeros((1, 16, 16, 4)), jnp.int32(0),
        jnp.zeros((1, 77, XL.cross_attention_dim)),
        {"text_embeds": jnp.zeros((1, POOLED)), "time_ids": jnp.zeros((1, 6))})
    tu = weights.load_flax(T.UNet2DCondition(_with_pooled(XL, POOLED)),
                           _np_tree(params), "unet")
    return ju, params, tu


@pytest.mark.parametrize("mode", ["plain", "capture", "controls"])
def test_xl_unet_matches_jax(xl_unet, mode):
    """The text_time UNet at TINY_XL_UNET (levels of depth 0, 1 and 2):
    eps, and with capture the head-averaged maps, the (Q, K) pairs and the
    inject resnet's feature; with controls the font-size weights and the
    in-batch injection from row 1 into rows 2..3."""
    ju, params, tu = xl_unet
    rng = np.random.default_rng(1)
    b = 4 if mode == "controls" else 2
    x = rng.standard_normal((b, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((b, 77, XL.cross_attention_dim)).astype(
        np.float32)
    pooled, ids = _added(b)
    jkw, tkw = {}, {}
    if mode == "capture":
        jkw["capture"] = J.CaptureSpec(
            self_probs=SELF, cross_probs=CROSS, qk=True,
            resnet=frozenset({J.INJECT_RESNET_NAME}))
        tkw["capture"] = T.CaptureSpec(
            self_probs=SELF, cross_probs=CROSS, qk=True,
            resnet=frozenset({T.INJECT_RESNET_NAME}))
    if mode == "controls":
        tw = np.ones((b, 77), np.float32)
        ts = np.ones((b, 77), np.float32)
        tw[1, [3, 4]] = [2.5, 1.5]
        ts[1, 4] = -1.0
        jkw["controls"] = J.UNetControls(
            token_weights=jnp.asarray(tw), token_signs=jnp.asarray(ts),
            inject_gate=jnp.asarray(True), inject_src=1, inject_dst=(2, 4))
        tkw["controls"] = T.UNetControls(
            token_weights=torch.from_numpy(tw),
            token_signs=torch.from_numpy(ts), inject_gate=True,
            inject_src=1, inject_dst=(2, 4))
    eps_j, aux_j = ju.apply(
        params, jnp.asarray(x), jnp.int32(700), jnp.asarray(ctx),
        added_cond={"text_embeds": jnp.asarray(pooled),
                    "time_ids": jnp.asarray(ids)}, **jkw)
    with torch.no_grad():
        eps_t, aux_t = tu(torch.from_numpy(x), 700, torch.from_numpy(ctx),
                          added_cond={"text_embeds": torch.from_numpy(pooled),
                                      "time_ids": torch.from_numpy(ids)},
                          **tkw)
    _close(eps_t.numpy(), eps_j)
    if mode == "capture":
        for n in SELF:
            _close(aux_t["self_probs"][n].numpy(), aux_j["self_probs"][n])
        for n in CROSS:
            _close(aux_t["cross_probs"][n].numpy(), aux_j["cross_probs"][n])
        assert set(aux_t["self_qk"]) == set(aux_j["self_qk"])
        for n, (q, k) in aux_j["self_qk"].items():
            _close(aux_t["self_qk"][n][0].numpy(), q)
            _close(aux_t["self_qk"][n][1].numpy(), k)
        r = T.INJECT_RESNET_NAME
        _close(aux_t["resnet_hidden"][r].numpy(), aux_j["resnet_hidden"][r])


def test_xl_embed_time_matches_jax(xl_unet):
    """``embed_time`` with ``added_cond``: the time embedding plus
    ``add_embedding`` of [pooled, sinusoidal time ids]; the ids given as
    one row broadcast over the batch equal the same ids tiled."""
    ju, params, tu = xl_unet
    pooled, ids = _added(3, seed=5)
    want = ju.apply(params, jnp.int32(321), 3,
                    {"text_embeds": jnp.asarray(pooled),
                     "time_ids": jnp.asarray(ids)}, method=ju.embed_time)
    with torch.no_grad():
        got = tu.embed_time(321, 3, {"text_embeds": torch.from_numpy(pooled),
                                     "time_ids": torch.from_numpy(ids)})
        one = tu.embed_time(321, 3, {"text_embeds": torch.from_numpy(pooled),
                                     "time_ids": torch.from_numpy(ids[:1])})
    _close(got.numpy(), want)
    np.testing.assert_array_equal(one.numpy(), got.numpy())
    with pytest.raises(ValueError, match="added_cond"):
        tu.embed_time(321, 3)


def _shape_tree(tree):
    """The leaves as zero-stride arrays of their shapes (no memory)."""
    return jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        tree)


@pytest.mark.parametrize("which", ["tiny", "sdxl"])
def test_xl_unet_module_tree_matches_jax(which):
    """The port's module tree at TINY_XL_UNET and at the full SDXL_UNET
    (built on the meta device, the JAX tree by ``eval_shape``): every flax
    leaf maps to a parameter of its shape and every parameter is filled
    (``check_coverage``); levels of depth 0 hold no transformer, and the
    heads at each level are ``num_attention_heads``."""
    cfg = XL if which == "tiny" else C.SDXL_UNET
    pooled = POOLED if which == "tiny" else 1280
    s = cfg.sample_size
    ju = J.UNet2DCondition(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda: ju.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 4)),
                        jnp.int32(0),
                        jnp.zeros((1, 77, cfg.cross_attention_dim)),
                        {"text_embeds": jnp.zeros((1, pooled)),
                         "time_ids": jnp.zeros((1, 6))}))
    with torch.device("meta"):
        tu = T.UNet2DCondition(_with_pooled(cfg, pooled))
    weights.check_coverage(
        weights.map_flax_tree(_shape_tree(shapes), "unet"), tu)
    assert tu.down_blocks[0].attentions is None
    assert tu.up_blocks[-1].attentions is None
    heads = {m.layer_name.split(".attentions")[0]: m.heads
             for m in tu.modules() if isinstance(m, T.Attention)}
    want = cfg.heads_per_level
    assert heads["down_blocks.1"] == want[1]
    assert heads["mid_block"] == want[-1]
    assert heads["up_blocks.0"] == want[-1]
    if which == "sdxl":
        assert {m.dim // m.heads for m in tu.modules()
                if isinstance(m, T.Attention)} == {64}
        n = sum(p.numel() for p in tu.parameters())
        assert 2.5e9 < n < 2.7e9  # diffusers' SDXL base UNet: 2.567e9


def test_sdxl_attention_layout_at_1024():
    """At a 128^2 latent: 10 attn1 layers at 64^2 (down_blocks.1: 2 x 2,
    up_blocks.1: 3 x 2) and 60 at 32^2 (down_blocks.2: 2 x 10, mid: 10,
    up_blocks.0: 3 x 10); every SDXL cross layer of the registry exists."""
    res = attn_layer_resolutions(C.SDXL_UNET, (128, 128))
    attn1 = {n: r for n, r in res.items() if n.endswith(".attn1")}
    count = {r: sum(1 for v in attn1.values() if v == r)
             for r in set(attn1.values())}
    assert count == {64: 10, 32: 60}
    assert sum(n.startswith("down_blocks.1") for n, r in attn1.items()
               if r == 64) == 4
    assert sum(n.startswith("mid_block") for n in attn1) == 10
    assert all(n in res for n in CrossAttentionLayers_XL)


@pytest.fixture(scope="module")
def text2():
    jm = JC.CLIPTextModel(TEXT2)
    params = fast_init(jm, 4, jnp.zeros((1, 77), jnp.int32))
    tm = weights.load_flax(TC.CLIPTextModel(TEXT2), _np_tree(params), "text")
    return jm, params, tm


def test_projected_tower_matches_jax(text2):
    """The projected tower (gelu, ``text_projection`` without bias):
    ``penultimate`` (the input of the last layer, before the final layer
    norm), ``pooled`` and ``projected``."""
    jm, params, tm = text2
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 900, (2, 77)).astype(np.int32)
    ids[0, 9], ids[1, 30] = 999, 999  # an EOS id in each row
    out_j = jm.apply(params, jnp.asarray(ids), eos_token_id=999)
    with torch.no_grad():
        out_t = tm(torch.from_numpy(ids.astype(np.int64)), eos_token_id=999)
    assert tm.text_projection.bias is None
    assert out_t["projected"].shape == (2, TEXT2.projection_dim)
    for key in ("penultimate", "pooled", "projected", "last_hidden_state"):
        _close(out_t[key].numpy(), out_j[key])


def test_projected_tower_module_tree_at_sdxl_width():
    """SDXL_TEXT_2's tree (32 layers, 1280 wide, 1280 projection) maps both
    ways, on the meta device."""
    jm = JC.CLIPTextModel(C.SDXL_TEXT_2)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 77), jnp.int32)))
    with torch.device("meta"):
        tm = TC.CLIPTextModel(C.SDXL_TEXT_2)
    mapped = weights.map_flax_tree(_shape_tree(shapes), "text")
    weights.check_coverage(mapped, tm)
    assert mapped["text_projection.weight"][0][-2:] == (
        "text_projection", "kernel")


def _qkv(seed, b, h, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("b,h,s", [(1, 20, 136), (2, 10, 200)])
def test_head_dim_64_plain_matches_jax(b, h, s):
    """The plain attention at SDXL's head dim 64 (ragged S) against the
    JAX kernel the JAX dispatch gives d = 64 (``_full_kernel``), in
    interpret mode; and the kernels' instantiation for it is 64 itself."""
    q, k, v = _qkv(s + h, b, h, s, 64)
    want = np.asarray(JA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
        _fullrow="classic"))
    got = TA.flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert TA._padded(64) == 64 and TA._padded(56) == 64
    assert [TA._padded(d) for d in (40, 48, 72, 80, 160)] == [48, 48, 80, 80,
                                                              160]


def test_head_dim_64_capture_plain_matches_jax():
    """The capture's plain version at 20 heads of 64 (the SDXL 32^2 layers)
    against the JAX capture kernel in interpret mode: output and head
    average."""
    q, k, v = _qkv(9, 1, 20, 130, 64)
    o_j, p_j = JA.flash_attention_avg_probs(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    o_t, p_t = TA.flash_attention_avg_probs_plain(
        *map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=1e-5)
