"""The port's SD-1.5-topology UNet against the JAX package's, through the
parameter bridge.

Both sides run in float32 on the CPU on the same numpy inputs and the same
parameters (the JAX tree mapped by ``weights.from_flax``). Tolerance: 1e-4
relative to the output's scale — float32 through a few dozen layers whose
sums run in another order (XLA's versus ATen's); the max |d| seen is ~3e-6.
"""

import dataclasses
import os

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
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "color_fixture",
                       "unet_params.npz")
SELF = frozenset({"down_blocks.1.attentions.0.transformer_blocks.0.attn1",
                  "up_blocks.2.attentions.1.transformer_blocks.0.attn1"})
CROSS = frozenset({"down_blocks.1.attentions.0.transformer_blocks.0.attn2",
                   "mid_block.attentions.0.transformer_blocks.0.attn2",
                   "up_blocks.1.attentions.2.transformer_blocks.0.attn2"})


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _fixture_params(template):
    """The trained fixture's flat npz as a flax tree shaped like template."""
    leaves, treedef = jax.tree.flatten_with_path(template)
    with np.load(FIXTURE) as z:
        out = [np.asarray(z["/".join(getattr(p, "key", str(p)) for p in path)],
                          np.float32) for path, _ in leaves]
    return jax.tree.unflatten(treedef, out)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("which", ["tiny", "fixture"])
def test_unet_matches_jax(which):
    cfg = C.TINY_UNET if which == "tiny" else C.FIXTURE_UNET
    ju = J.UNet2DCondition(cfg, dtype=jnp.float32)
    params = fast_init(ju, 0, jnp.zeros((1, 8, 8, 4)), jnp.int32(0),
                       jnp.zeros((1, 77, 32)))
    if which == "fixture":
        params = _fixture_params(params)
    tu = weights.load_flax(T.UNet2DCondition(cfg), _np_tree(params), "unet")

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    tw = np.ones((2, 77), np.float32)
    ts = np.ones((2, 77), np.float32)
    tw[1, [3, 4]] = [2.5, 1.5]
    ts[1, 4] = -1.0
    eps_j, aux_j = ju.apply(
        params, jnp.asarray(x), jnp.int32(700), jnp.asarray(ctx),
        controls=J.UNetControls(token_weights=jnp.asarray(tw),
                                token_signs=jnp.asarray(ts)),
        capture=J.CaptureSpec(self_probs=SELF, cross_probs=CROSS))
    with torch.no_grad():
        eps_t, aux_t = tu(
            torch.from_numpy(x), 700, torch.from_numpy(ctx),
            controls=T.UNetControls(token_weights=torch.from_numpy(tw),
                                    token_signs=torch.from_numpy(ts)),
            capture=T.CaptureSpec(self_probs=SELF, cross_probs=CROSS))
    _close(eps_t, eps_j)
    assert set(aux_t["self_probs"]) == SELF
    assert set(aux_t["cross_probs"]) == CROSS
    for kind in ("self_probs", "cross_probs"):
        for name in aux_j[kind]:
            _close(aux_t[kind][name], aux_j[kind][name])


def test_full_width_transformer_block_matches_jax():
    """One SD-1.5 Transformer2D at 32^2 (C=640, 8 heads, head dim 80) —
    the K2/K3 kernels' layer — with capture of its self-attention."""
    name = "down_blocks.1.attentions.0"
    jt = J.Transformer2D(heads=8, dim=640, depth=1, kv_dim=768,
                         use_linear_projection=False, layer_name=name)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 32, 32, 640)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 768)).astype(np.float32)
    spec = dict(self_probs=frozenset({f"{name}.transformer_blocks.0.attn1"}))
    params = fast_init(jt, 3, jnp.zeros((1, 32, 32, 640)),
                       jnp.zeros((1, 77, 768)), None, J.EMPTY_CAPTURE, None)
    aux_j = {}
    y_j = jt.apply(params, jnp.asarray(x), jnp.asarray(ctx), None,
                   J.CaptureSpec(**spec), aux_j)
    tt = T.Transformer2DModel(C.SD15_UNET, 8, 640, 1, name)
    weights.load_flax(tt, _np_tree(params), "unet")
    aux_t = {}
    with torch.no_grad():
        y_t = tt(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(ctx),
                 None, T.CaptureSpec(**spec), aux_t)
    _close(y_t.permute(0, 2, 3, 1), y_j)
    (n,) = spec["self_probs"]
    assert aux_t["self_probs"][n].shape == (1, 1024, 1024)
    _close(aux_t["self_probs"][n], aux_j["self_probs"][n])


def test_timestep_embedding_matches_jax():
    t = np.array([1, 500, 999], np.int32)
    want = J.timestep_embedding(jnp.asarray(t), 320, True, 0.0)
    got = T.timestep_embedding(torch.from_numpy(t), 320, True, 0.0)
    # sin/cos of float32 arguments up to ~1000 rad: one ulp of the argument
    # is 6e-5 there, and the two libraries reduce the range differently
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


def test_encode_decode_compose_forward():
    unet = weights.random_init(T.UNet2DCondition(C.TINY_UNET), 0)
    x = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(0))
    ctx = torch.randn((2, 77, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        eps, _ = unet(x, 10, ctx)
        emb = unet.embed_time(10, 2)
        eps2, _ = unet.decode(unet.encode(x, emb, ctx), emb, ctx)
    assert eps.shape == (2, 8, 8, 4)
    torch.testing.assert_close(eps, eps2)


@pytest.mark.parametrize("which", ["inject_cross", "cross_mix",
                                   "cross_full"])
def test_prompt_to_prompt_controls_and_capture_match_jax(which):
    """The prompt-to-prompt controls and capture (they raised until the
    prompt-to-prompt baseline was ported) against the JAX package's, on
    the trained fixture's UNet: ``inject_cross`` blends a base row's full
    cross probabilities through a Refine gather, ``cross_mix`` with a
    partial mix through a Replace matrix, and ``cross_full`` captures every
    attn2 layer's probabilities after the font-size weights and signs."""
    cfg = C.FIXTURE_UNET
    ju = J.UNet2DCondition(cfg, dtype=jnp.float32)
    params = _fixture_params(fast_init(
        ju, 0, jnp.zeros((1, 8, 8, 4)), jnp.int32(0), jnp.zeros((1, 77, 32))))
    tu = weights.load_flax(T.UNet2DCondition(cfg), _np_tree(params), "unet")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    tw = np.ones((2, 77), np.float32)
    ts = np.ones((2, 77), np.float32)
    tw[1, [3, 4]] = [2.5, 1.5]
    ts[1, 4] = -1.0
    kw = dict(token_weights=tw, token_signs=ts)
    capture = {}
    if which == "cross_full":
        capture = dict(cross_full=True)
    else:
        _, aux = ju.apply(params, jnp.asarray(x[:1]), jnp.int32(300),
                          jnp.asarray(ctx[:1]),
                          capture=J.CaptureSpec(cross_full=True))
        probs = {n: np.array(p) for n, p in aux["cross_probs_full"].items()}
        if which == "inject_cross":
            mapper = np.arange(77, dtype=np.int32)[::-1].copy()
            mix = np.ones(77, np.float32)
        else:
            mapper = np.eye(77, dtype=np.float32)[rng.permutation(77)]
            mix = rng.uniform(0, 1, 77).astype(np.float32)
        kw.update(inject_cross=probs, cross_mapper=mapper, cross_mix=mix)

    def controls(mod, conv):
        return mod.UNetControls(**{
            k: ({n: conv(p) for n, p in v.items()} if isinstance(v, dict)
                else conv(v)) for k, v in kw.items()})

    eps_j, aux_j = ju.apply(
        params, jnp.asarray(x), jnp.int32(700), jnp.asarray(ctx),
        controls=controls(J, jnp.asarray),
        capture=J.CaptureSpec(**capture))
    with torch.no_grad():
        eps_t, aux_t = tu(torch.from_numpy(x), 700, torch.from_numpy(ctx),
                          controls=controls(T, torch.from_numpy),
                          capture=T.CaptureSpec(**capture))
    _close(eps_t, eps_j)
    if which == "cross_full":
        assert set(aux_t["cross_probs_full"]) == set(
            aux_j["cross_probs_full"]) and len(aux_t["cross_probs_full"]) > 0
        for n, p in aux_j["cross_probs_full"].items():
            assert aux_t["cross_probs_full"][n].shape == p.shape
            _close(aux_t["cross_probs_full"][n], p)


def test_unported_configs_raise():
    """SDXL's text_time UNet is ported (tests/test_torch_port_sdxl_models.py)
    and so is DualTransformer2D (tests/test_torch_port_dual_transformer.py):
    a dual config builds, with two streams in each attention block; an
    added embedding other than text_time is not ported and raises."""
    dual = T.UNet2DCondition(dataclasses.replace(C.TINY_UNET,
                                                 dual_cross_attention=True))
    names = dual.state_dict()
    assert any(".attentions.0.transformers.1." in n for n in names)
    assert not any(".attentions.0.transformer_blocks." in n for n in names)
    with pytest.raises(NotImplementedError, match="text_time"):
        T.UNet2DCondition(dataclasses.replace(C.TINY_XL_UNET,
                                              addition_embed_type="text"))
