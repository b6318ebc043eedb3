"""The turbo knobs of the rich pass in the port against the JAX package:
encoder reuse, the pooled guidance decode and the bfloat16 guidance decode.

  * ``encoder_key_gates`` equals the JAX package's over a grid of step
    counts, strides and both schedules, and raises as it does;
  * the rich pass with ``encoder_reuse=2`` in its three flows (no
    injection; the in-batch flow's two launches a step; the refer-
    precompute flow) within 1e-4 of scale of the JAX rich pass;
  * ``guidance_downsample=2`` within 1e-4 of scale of JAX, and a size it
    does not divide falls back to the exact decode;
  * ``bf16_guidance`` within 2e-3 of scale of JAX's bfloat16 run (both
    decode in bfloat16 on the CPU, each with its own rounding order; the
    gap measured on this test's inputs is 1.7e-4) and apart from the
    float32 run.

Tiny configs, float32 UNet and VAE on the CPU, same numpy latents and
masks, bridged parameters.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.pipelines import base as JB
from rich_text_to_image_tpu.pipelines import region_sd as JP
from rich_text_to_image_tpu_torch.pipelines import base as TB
from rich_text_to_image_tpu_torch.pipelines import region_sd as TP
from torch_port_pipes import close, tiny_pipes
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

H, PX, STEPS, G = 8, 16, 12, 7.5
PROMPTS = ["a tall tree", "a red rose", "a garden with a rose bush"]


@pytest.mark.parametrize("schedule", ["early", "uniform"])
def test_encoder_key_gates_equal_jax(schedule):
    for S in (1, 2, 3, 5, 12, 13, 41, 42, 50):
        for stride in (1, 2, 3, 4, 7):
            got = TB.encoder_key_gates(S, stride, schedule)
            want = JB.encoder_key_gates(S, stride, schedule)
            np.testing.assert_array_equal(got, want)
            assert got[0] and got.sum() == len(range(0, S, stride))
    for mod in (TB, JB):
        with pytest.raises(ValueError, match="schedule"):
            mod.encoder_key_gates(12, 2, "late")


@pytest.fixture(scope="module")
def pipes():
    jp, tp = tiny_pipes()
    rng = np.random.default_rng(5)
    soft = rng.random((3, 1, H, H)).astype(np.float32) + 0.1
    soft /= soft.sum(axis=0, keepdims=True)
    jp.masks = tp.masks = [m for m in soft]
    lat0 = rng.standard_normal((1, H, H, 4)).astype(np.float32)
    return jp, tp, lat0


def _fmt(guidance: bool, px=PX, h=H):
    fmt = {"word_pos": np.array([3, 4]), "font_size": np.array([2.5, 0.5])}
    if guidance:
        m = np.zeros((1, px, px), np.float32)
        m[:, :, :px // 2] = 1.0
        fmt.update(target_RGB=[np.array([0.9, 0.1, 0.1])],
                   guidance_start_step=999, color_guidance_weight=0.5,
                   color_obj_atten=[m],
                   color_obj_atten_all=np.full((1, h, h), 0.5, np.float32))
    return fmt


def _rich(pipe, lat, ref_cache=None, px=PX, **kw):
    mod = TP if isinstance(pipe, TP.RegionDiffusion) else JP
    guidance = kw.pop("use_guidance", False)
    spec = mod.RichControlSpec(guidance_scale=G, use_guidance=guidance,
                               color_guidance_weight=0.5, **kw)
    return np.asarray(pipe.produce_latents(
        pipe.get_text_embeds(PROMPTS, [""]), height=px, width=px,
        num_inference_steps=STEPS, latents=lat, spec=spec,
        text_format_dict=_fmt(guidance, px, px // 2), ref_cache=ref_cache))


def _jax_cache(jp, tp, lat0, steps):
    """The JAX layout of the port's refer cache (its capture is held
    against JAX's in test_torch_port_refpre.py): trajectory [S+1, h, w*4],
    one spare slot after the real ones, JAX's own fingerprint."""
    tp.produce_attn_maps([PROMPTS[-1]], [""], height=PX, width=PX,
                         num_inference_steps=STEPS, guidance_scale=G,
                         latents=lat0, ref_capture_steps=steps)
    c = tp.ref_cache
    pad = lambda t: jnp.asarray(torch.cat([t, torch.zeros_like(t[:1])]))
    emb = jp.get_text_embeds([PROMPTS[-1]], [""])
    return dict(
        steps=c["steps"], g=c["g"], hw=c["hw"],
        fp=JB.ref_fingerprint(jnp.asarray(lat0), emb[0], emb[-1]),
        traj=jnp.asarray(c["traj"].reshape(c["traj"].shape[0], H, -1)),
        qk={n: tuple(pad(t) for t in qk) for n, qk in c["qk"].items()},
        resnet={n: pad(f) for n, f in c["resnet"].items()})


def _steps(pipe, inject_selfattn):
    plan = pipe.scheduler.plan(STEPS)
    gates = plan.timesteps.astype(np.float64) > (1 - inject_selfattn) * 1000
    return tuple(np.nonzero(gates)[0].tolist())


@pytest.mark.parametrize("flow", ["plain", "in_batch", "refpre"])
def test_encoder_reuse_matches_jax(pipes, flow):
    jp, tp, lat0 = pipes
    kw = dict(encoder_reuse=2)
    if flow != "plain":
        kw.update(inject_selfattn=0.4, inject_background=0.3)
    t_cache = j_cache = None
    if flow == "refpre":
        j_cache = _jax_cache(jp, tp, lat0, _steps(tp, 0.4))
        t_cache = tp.ref_cache
    seen = []
    hook = tp.unet.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].shape[0]))
    try:
        emb_calls = []
        orig = tp.unet.embed_time
        tp.unet.embed_time = lambda t, b: emb_calls.append(b) or orig(t, b)
        t_lat = _rich(tp, lat0, t_cache, **kw)
    finally:
        hook.remove()
        del tp.unet.embed_time
    assert seen == []  # encode/decode are called, never the whole forward
    S = STEPS + 1
    assert emb_calls == ([4, 2] if flow == "in_batch" else [4]) * S
    j_lat = _rich(jp, jnp.asarray(lat0), j_cache, **kw)
    if flow == "refpre":
        assert any(k[0] == "richpre" and k[6] for k in jp._jit_cache)
    close(t_lat, j_lat)
    exact = _rich(tp, lat0, t_cache, **dict(kw, encoder_reuse=1))
    assert np.abs(t_lat - exact).max() > 1e-4  # the reuse did something


@pytest.mark.parametrize("knob", ["gds2", "bf16"])
def test_guidance_turbo_matches_jax(pipes, knob):
    jp, tp, lat0 = pipes
    kw = dict(use_guidance=True)
    kw.update(guidance_downsample=2 if knob == "gds2" else 1,
              bf16_guidance=knob == "bf16")
    t_lat = _rich(tp, lat0, **kw)
    j_lat = _rich(jp, jnp.asarray(lat0), **kw)
    close(t_lat, j_lat, rel=1e-4 if knob == "gds2" else 2e-3)
    exact = _rich(tp, lat0, use_guidance=True)
    assert np.abs(t_lat - exact).max() > 1e-4
    if knob == "bf16":  # made once, reused
        vae = tp._guidance_vae(True)
        assert vae is tp._guidance_vae(True) and vae is not tp.vae
        assert vae.decoder.conv_in.weight.dtype == torch.bfloat16


def test_guidance_downsample_falls_back_where_it_does_not_divide(pipes):
    """d = 3 divides neither the 8-row latent nor the 16-pixel image: the
    exact decode runs (the JAX rule, region_sd.py:820-822)."""
    _, tp, lat0 = pipes
    np.testing.assert_array_equal(
        _rich(tp, lat0, use_guidance=True, guidance_downsample=3),
        _rich(tp, lat0, use_guidance=True))
