"""The refer-precompute flow of the port against the JAX package's.

The plain pass, asked for ``ref_capture_steps``, keeps the reference
trajectory (the latent before every step and the final one) and, at the
injection steps, the cond row's (Q, K) of every self-attention layer and
its feature at the injected resnet; the rich pass then runs R+2 rows a step
and injects from the cache. Held here, on the tiny configs in float32 on
the CPU, from the same numpy latents on bridged parameters:

  * the capture leaves the plain image and the aggregates bit-identical;
  * the cache (trajectory, each slot's (Q, K), the resnet feature) within
    1e-4 of each array's scale of the JAX package's ``ref_cache``;
  * the rich pass within 1e-4 of scale of the JAX refpre flow, and within
    2e-3 (relative to its mean |latent|) of the port's own in-batch flow,
    as ``tests/test_ref_precompute.py`` holds the JAX package's;
  * a cache of other injection steps, another guidance scale or another
    seed is not taken: the in-batch flow runs, to the same latent;
  * the memory guard skips the capture; the bytes of a slot equal the JAX
    package's at the tiny and the full SD-1.5 configuration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.models.unet import UNet2DCondition as JUNet
from rich_text_to_image_tpu.pipelines import region_sd as JP
from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
from rich_text_to_image_tpu_torch.pipelines import base as TB
from rich_text_to_image_tpu_torch.pipelines import region_sd as TP
from torch_port_pipes import close as _close
from torch_port_pipes import tiny_pipes
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

H, PX, STEPS, G = 8, 16, 12, 7.5
PROMPTS = ["a tall tree", "a red rose", "a garden with a rose bush"]


@pytest.fixture(scope="module")
def pipes():
    jp, tp = tiny_pipes()
    rng = np.random.default_rng(5)
    soft = rng.random((3, 1, H, H)).astype(np.float32) + 0.1
    soft /= soft.sum(axis=0, keepdims=True)
    jp.masks = tp.masks = [m for m in soft]
    lat0 = rng.standard_normal((1, H, H, 4)).astype(np.float32)
    return jp, tp, lat0


def _steps(pipe, inject_selfattn):
    plan = pipe.scheduler.plan(STEPS)
    gates = plan.timesteps.astype(np.float64) > (1 - inject_selfattn) * 1000
    return tuple(np.nonzero(gates)[0].tolist())


def _fmt(font: bool):
    if not font:
        return {}
    m = np.zeros((1, PX, PX), np.float32)
    m[:, :, :PX // 2] = 1.0
    return {"word_pos": np.array([3, 4]), "font_size": np.array([2.5, 0.5]),
            "target_RGB": [np.array([0.9, 0.1, 0.1])],
            "guidance_start_step": 999, "color_guidance_weight": 0.5,
            "color_obj_atten": [m],
            "color_obj_atten_all": np.full((1, H, H), 0.5, np.float32)}


def _capture(pipe, lat, steps, g=G):
    pipe.produce_attn_maps([PROMPTS[-1]], [""], height=PX, width=PX,
                           num_inference_steps=STEPS, guidance_scale=g,
                           latents=lat, ref_capture_steps=steps)
    return pipe.ref_cache


def _rich(pipe, lat, selfattn, background, font, ref_cache=None, g=G):
    mod = TP if isinstance(pipe, TP.RegionDiffusion) else JP
    spec = mod.RichControlSpec(guidance_scale=g, inject_selfattn=selfattn,
                               inject_background=background,
                               use_guidance=font, color_guidance_weight=0.5)
    return np.asarray(pipe.produce_latents(
        pipe.get_text_embeds(PROMPTS, [""]), height=PX, width=PX,
        num_inference_steps=STEPS, latents=lat, spec=spec,
        text_format_dict=_fmt(font), ref_cache=ref_cache))


def _rows(tp, fn):
    """UNet batch sizes of the calls ``fn`` makes."""
    seen = []
    hook = tp.unet.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].shape[0]))
    try:
        out = fn()
    finally:
        hook.remove()
    return out, seen


def test_capture_leaves_plain_pass_unchanged(pipes):
    _, tp, lat0 = pipes
    kw = dict(height=PX, width=PX, num_inference_steps=STEPS,
              guidance_scale=G, latents=lat0)
    img_a, agg_a = tp.produce_attn_maps([PROMPTS[-1]], [""], **kw)
    assert tp.ref_cache is None
    img_b, agg_b = tp.produce_attn_maps([PROMPTS[-1]], [""],
                                        ref_capture_steps=_steps(tp, 0.4),
                                        **kw)
    assert tp.ref_cache is not None
    np.testing.assert_array_equal(img_a, img_b)
    np.testing.assert_array_equal(agg_a.self_sum.numpy(),
                                  agg_b.self_sum.numpy())
    assert agg_a.cross_sums.keys() == agg_b.cross_sums.keys()
    for r in agg_a.cross_sums:
        np.testing.assert_array_equal(agg_a.cross_sums[r],
                                      agg_b.cross_sums[r])


def test_ref_cache_matches_jax(pipes):
    jp, tp, lat0 = pipes
    steps = _steps(tp, 0.4)
    assert len(steps) == 5
    jc = _capture(jp, jnp.asarray(lat0), steps)
    tc = _capture(tp, lat0, steps)
    assert tc["steps"] == jc["steps"] == steps
    assert tc["g"] == jc["g"] and tuple(tc["hw"]) == tuple(jc["hw"])
    # the embedding rows are layer-normed: their sums cancel to float
    # noise (~1e-5 here), which the absolute tolerance covers
    np.testing.assert_allclose(tc["fp"], jc["fp"], rtol=1e-5, atol=1e-4)
    S = tp.scheduler.plan(STEPS).num_steps
    assert tuple(tc["traj"].shape) == (S + 1, H, H, 4)
    _close(tc["traj"].reshape(S + 1, H, H * 4), jc["traj"])
    n = len(steps)
    assert set(tc["qk"]) == set(jc["qk"])
    assert len(tc["qk"]) == 16
    for name, (q, k) in tc["qk"].items():
        jq, jk = jc["qk"][name]  # JAX keeps a spare slot at the end
        assert q.shape[1:] == jq.shape[1:] and q.shape[0] == n
        _close(q, jq[:n])
        _close(k, jk[:n])
    assert set(tc["resnet"]) == set(jc["resnet"])
    for name, f in tc["resnet"].items():
        _close(f, jc["resnet"][name][:n])
        assert f.data_ptr() not in {t.data_ptr() for t in tc["traj"]}


@pytest.mark.parametrize("selfattn,background,font", [
    (0.4, 0.3, True), (0.0, 0.4, False)], ids=["inject+font+colour", "bg"])
def test_refpre_rich_pass_matches_jax_and_in_batch(pipes, selfattn,
                                                   background, font):
    """Against the JAX refpre flow with injection, font-size reweighting,
    colour guidance and background injection; the background-only case
    (no (Q, K) slots, only the trajectory) against the in-batch flow."""
    jp, tp, lat0 = pipes
    steps = _steps(tp, selfattn)
    cache = _capture(tp, lat0, steps)
    t_lat, rows = _rows(tp, lambda: _rich(tp, lat0, selfattn, background,
                                          font, cache))
    assert rows == [4] * (STEPS + 1)  # R+2: no reference rows
    if steps:
        j_lat = _rich(jp, jnp.asarray(lat0), selfattn, background, font,
                      _capture(jp, jnp.asarray(lat0), steps))
        assert any(k[0] == "richpre" for k in jp._jit_cache)
        _close(t_lat, j_lat)
    in_batch, rows = _rows(tp, lambda: _rich(tp, lat0, selfattn, background,
                                             font))
    assert rows == [6] * (STEPS + 1)  # R+4
    scale = np.abs(in_batch).mean()
    np.testing.assert_allclose(t_lat / scale, in_batch / scale, rtol=2e-3,
                               atol=2e-3)
    off = _rich(tp, lat0, 0.0, 0.0, font)
    assert np.abs(t_lat - off).max() > 1e-3  # the injection did something


@pytest.mark.parametrize("mismatch", ["steps", "guidance", "seed"])
def test_mismatched_cache_falls_back_to_in_batch(pipes, mismatch):
    _, tp, lat0 = pipes
    want = _rich(tp, lat0, 0.4, 0.0, False)
    if mismatch == "steps":
        cache = _capture(tp, lat0, _steps(tp, 0.8))
    elif mismatch == "guidance":
        cache = _capture(tp, lat0, _steps(tp, 0.4), g=5.0)
    else:
        other = np.random.default_rng(9).standard_normal(lat0.shape)
        cache = _capture(tp, other.astype(np.float32), _steps(tp, 0.4))
    got, rows = _rows(tp, lambda: _rich(tp, lat0, 0.4, 0.0, False, cache))
    assert rows == [6] * (STEPS + 1)
    np.testing.assert_array_equal(got, want)
    # and the matching cache is taken
    cache = _capture(tp, lat0, _steps(tp, 0.4))
    assert TB.ref_cache_matches(
        cache, _steps(tp, 0.4), STEPS + 1, G, (H, H),
        TB.ref_fingerprint(torch.from_numpy(lat0),
                           *tp.get_text_embeds(PROMPTS[-1:], [""])[[0, -1]]))


def test_memory_guard_skips_the_capture(pipes):
    _, tp, lat0 = pipes
    assert tp._ref_qk_bytes_per_slot((H, H)) > 0
    tp.ref_precompute_max_bytes = 1
    try:
        _capture(tp, lat0, (0, 1))
        assert tp.ref_cache is None
        # an empty step list keeps the trajectory only, which the guard
        # does not count
        assert _capture(tp, lat0, ())["qk"] == {}
    finally:
        del tp.ref_precompute_max_bytes  # back to the class's budget
    assert tp.ref_precompute_max_bytes == 6e9


@pytest.mark.parametrize("hw", [(8, 8), (8, 16), (16, 8)])
def test_slot_bytes_equal_jax_tiny(pipes, hw):
    jp, tp, _ = pipes
    assert tp._ref_qk_bytes_per_slot(hw) == jp._ref_qk_bytes_per_slot(hw)


def test_slot_bytes_equal_jax_full_sd15():
    """At full SD-1.5 width, 512^2 (latent 64^2), bfloat16: ~46 MB of
    (Q, K) and 0.66 MB of resnet feature a slot. JAX from abstract shapes,
    the port from a UNet on the meta device."""
    ju = JUNet(C.SD15_UNET, dtype=jnp.bfloat16)
    jp = JP.RegionDiffusion.__new__(JP.RegionDiffusion)
    jp.unet, jp.unet_cfg = ju, C.SD15_UNET
    jp.unet_params = jax.eval_shape(lambda: ju.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4)), jnp.int32(0),
        jnp.zeros((1, 77, 768))))
    with torch.device("meta"):
        tu = UNet2DCondition(C.SD15_UNET).to(torch.bfloat16)
    got = TB.ref_qk_bytes_per_slot(tu, (64, 64))
    assert got == jp._ref_qk_bytes_per_slot((64, 64)) == 46_858_240
