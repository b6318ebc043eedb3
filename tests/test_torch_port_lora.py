"""The port's LoRA merging (``models/convert.py``) against the JAX
package's ``apply_lora_unet`` / ``apply_lora_text``, after
``tests/test_lora.py``.

The same numpy LoRA dict (rank 4, diffusers names, drawn from a seed for
every attention projection) goes through both packages, on the same tiny
parameters (``fast_init`` bridged by ``weights.load_flax``), float32 on the
CPU. Tolerances: the merged weights within 1e-6 absolute (one float32
product and add on each side); the UNet's eps and the text encoder's
hidden states within 1e-4 of their scale (float32 through the whole model,
sums in another order); ``scale=0`` leaves the weights and the outputs
exactly as they were.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.models import convert as JC
from rich_text_to_image_tpu.models.clip import CLIPTextModel as JClip
from rich_text_to_image_tpu.models.init_utils import fast_init
from rich_text_to_image_tpu.models.unet import UNet2DCondition as JUNet
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models import convert as TC
from rich_text_to_image_tpu_torch.models.clip import CLIPTextModel as TClip
from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition as TUNet
from torch_port_pipes import close
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

RANK = 4
WEIGHT_ATOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def unet():
    """(JAX module, JAX params, the port's module on the same params)."""
    ju = JUNet(C.TINY_UNET, dtype=jnp.float32)
    params = fast_init(ju, 0, jnp.zeros((1, 8, 8, 4)), jnp.int32(0),
                       jnp.zeros((1, 77, 32)), dtype=jnp.float32)
    tu = weights.load_flax(TUNet(C.TINY_UNET), _np(params), "unet").eval()
    return ju, params, tu


@pytest.fixture(scope="module")
def text():
    jm = JClip(C.TINY_TEXT, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))
    tm = weights.load_flax(TClip(C.TINY_TEXT), _np(params), "text").eval()
    return jm, params, tm


def _unet_lora(sd, seed):
    """A diffusers UNet LoRA for every attention projection of ``sd``."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, w in sd.items():
        m = TC._UNET_KEY.match(key)
        if m is None:
            continue
        stem = f"{m.group(1)}.processor.{TC._UNET_PROJ[m.group(2)]}"
        d_out, d_in = w.shape
        out[f"{stem}.down.weight"] = (
            rng.standard_normal((RANK, d_in)).astype(np.float32) * 0.1)
        out[f"{stem}.up.weight"] = (
            rng.standard_normal((d_out, RANK)).astype(np.float32) * 0.1)
    return out


def _text_lora(sd, seed, infix="lora_linear_layer"):
    rng = np.random.default_rng(seed)
    out = {}
    for key, w in sd.items():
        if not key.endswith("_proj.weight"):
            continue
        mod = key.removesuffix(".weight")
        d_out, d_in = w.shape
        out[f"{mod}.{infix}.down.weight"] = (
            rng.standard_normal((RANK, d_in)).astype(np.float32) * 0.1)
        out[f"{mod}.{infix}.up.weight"] = (
            rng.standard_normal((d_out, RANK)).astype(np.float32) * 0.1)
    return out


def _merged_keys(base, merged):
    return sorted(k for k in base if merged[k] is not base[k])


@pytest.mark.parametrize("scale", [0.7, 1.0])
def test_unet_merge_matches_jax(unet, scale):
    _, params, tu = unet
    sd = tu.state_dict()
    lora = _unet_lora(sd, 0)
    got = TC.apply_lora_unet(sd, lora, scale=scale)
    want = weights.from_flax(_np(JC.apply_lora_unet(params, lora, scale)),
                             "unet")
    assert set(got) == set(want) == set(sd)
    for k in sd:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=k)
    merged = _merged_keys(sd, got)
    # 4 projections x (attn1, attn2) x the 16 transformer blocks of the
    # SD-1.5 topology
    assert len(merged) == len(lora) // 2 == 4 * 2 * 16
    assert all(k.endswith(("to_q.weight", "to_k.weight", "to_v.weight",
                           "to_out.0.weight")) for k in merged)


def test_unet_lora_forward_matches_jax_and_scale_zero_is_exact(unet):
    ju, params, tu = unet
    sd = tu.state_dict()
    lora = _unet_lora(sd, 1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)

    def port_eps(state):
        mod = TUNet(C.TINY_UNET)
        mod.load_state_dict(state, strict=True)
        with torch.no_grad():
            return mod(torch.from_numpy(x), 500, torch.from_numpy(ctx))[0]

    base = port_eps(sd)
    merged = port_eps(TC.apply_lora_unet(sd, lora, scale=1.0))
    want, _ = ju.apply(JC.apply_lora_unet(params, lora, 1.0),
                       jnp.asarray(x), jnp.int32(500), jnp.asarray(ctx))
    close(merged.numpy(), want)
    assert float((merged - base).abs().max()) > 1e-4  # the LoRA moved eps
    zero = port_eps(TC.apply_lora_unet(sd, lora, scale=0.0))
    assert torch.equal(zero, base)


@pytest.mark.parametrize("infix", ["lora_linear_layer", "lora"])
@pytest.mark.parametrize("scale", [0.6, 1.0])
def test_text_merge_matches_jax(text, infix, scale):
    _, params, tm = text
    sd = tm.state_dict()
    lora = _text_lora(sd, 3, infix)
    got = TC.apply_lora_text(sd, lora, scale=scale)
    want = weights.from_flax(_np(JC.apply_lora_text(params, lora, scale)),
                             "text")
    for k in sd:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=WEIGHT_ATOL, err_msg=k)
    merged = _merged_keys(sd, got)
    assert len(merged) == 4 * C.TINY_TEXT.num_hidden_layers
    assert "text_projection.weight" not in merged


def test_text_lora_embeddings_match_jax_and_scale_zero_is_exact(text):
    jm, params, tm = text
    sd = tm.state_dict()
    lora = _text_lora(sd, 4)
    ids = np.random.default_rng(4).integers(0, C.TINY_TEXT.vocab_size,
                                            (2, 77))

    def port_hidden(state):
        mod = TClip(C.TINY_TEXT)
        mod.load_state_dict(state, strict=True)
        with torch.no_grad():
            return mod(torch.from_numpy(ids))["last_hidden_state"]

    base = port_hidden(sd)
    merged = port_hidden(TC.apply_lora_text(sd, lora, scale=1.0))
    want = jm.apply(JC.apply_lora_text(params, lora, 1.0),
                    jnp.asarray(ids, jnp.int32))["last_hidden_state"]
    close(merged.numpy(), want)
    assert float((merged - base).abs().max()) > 1e-4
    zero = port_hidden(TC.apply_lora_text(sd, lora, scale=0.0))
    assert torch.equal(zero, base)


@pytest.mark.parametrize("which", ["unet", "text"])
def test_prefixed_keys_are_accepted(unet, text, which):
    """A leading ``unet.`` / ``text_encoder.`` (the LoraLoaderMixin
    layout) merges as the bare keys do, in both packages."""
    if which == "unet":
        _, params, mod = unet
        sd = mod.state_dict()
        lora, fn, jfn = _unet_lora(sd, 5), TC.apply_lora_unet, \
            JC.apply_lora_unet
    else:
        _, params, mod = text
        sd = mod.state_dict()
        lora, fn, jfn = _text_lora(sd, 5), TC.apply_lora_text, \
            JC.apply_lora_text
    prefixed = {f"{'unet' if which == 'unet' else 'text_encoder'}.{k}": v
                for k, v in lora.items()}
    bare = fn(sd, lora, scale=0.5)
    got = fn(sd, prefixed, scale=0.5)
    assert all(torch.equal(got[k], bare[k]) for k in sd)
    assert jfn(params, prefixed, 0.5) is not params


def _broken(lora, guard, example_key):
    """``lora`` with one fault of the kind ``guard``."""
    bad = dict(lora)
    if guard == "half_pair":
        del bad[example_key.replace(".down.", ".up.")]
    elif guard == "shape":
        bad[example_key] = np.zeros((RANK, 3), np.float32)
    elif guard == "unused":
        stem = example_key.split(".", 1)[0]
        bad[f"{stem}.99.processor.to_q_lora.down.weight"] = np.zeros(
            (RANK, 8), np.float32)
    else:  # "empty": no LoRA tensor at all
        bad = {}
    return bad


@pytest.mark.parametrize("guard", ["half_pair", "shape", "unused", "empty"])
@pytest.mark.parametrize("which", ["unet", "text"])
def test_guards_raise_in_both(unet, text, which, guard):
    if which == "unet":
        _, params, mod = unet
        sd = mod.state_dict()
        lora, fn, jfn = _unet_lora(sd, 6), TC.apply_lora_unet, \
            JC.apply_lora_unet
    else:
        _, params, mod = text
        sd = mod.state_dict()
        lora, fn, jfn = _text_lora(sd, 6), TC.apply_lora_text, \
            JC.apply_lora_text
    key = next(k for k in lora if k.endswith(".down.weight"))
    bad = _broken(lora, guard, key)
    match = {"half_pair": "half-present", "shape": "shape mismatch",
             "unused": "matched no", "empty": "LoRA"}[guard]
    with pytest.raises(ValueError, match=match):
        jfn(params, bad, 1.0)
    with pytest.raises(ValueError, match=match):
        fn(sd, bad)


def test_merge_keeps_a_bf16_weight_bf16_and_casts_once():
    """The merge is float32 and is cast once to the weight's dtype: a
    bfloat16 weight gives round_bf16(W + s·up@down), and the other entries
    stay the input's own tensors."""
    cfg = dataclasses.replace(C.TINY_TEXT, num_hidden_layers=1)
    sd = {k: v.to(torch.bfloat16) for k, v in
          weights.random_init(TClip(cfg), 0).state_dict().items()}
    lora = _text_lora(sd, 7)
    got = TC.apply_lora_text(sd, lora, scale=0.5)
    key = "text_model.encoder.layers.0.self_attn.q_proj.weight"
    stem = key.removesuffix(".weight") + ".lora_linear_layer"
    up = torch.from_numpy(lora[f"{stem}.up.weight"])
    down = torch.from_numpy(lora[f"{stem}.down.weight"])
    want = (sd[key].float() + 0.5 * (up @ down)).to(torch.bfloat16)
    assert got[key].dtype == torch.bfloat16 and torch.equal(got[key], want)
    other = "text_model.final_layer_norm.weight"
    assert got[other] is sd[other]
