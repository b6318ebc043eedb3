"""The port's schedulers against the JAX package's: DDIM, EulerDiscrete and
DPM-Solver++ (2M), with PNDM beside them in the rollouts.

  * The host plans are the same arrays (same dtype, same values) at 4, 12
    and 41 steps: both sides compute them with the same numpy code.
  * A rollout of every step of a plan, on float32 tensors, from the same
    latent with the same model outputs at each step (numpy, from a seed),
    stays within 1e-6 of the JAX rollout relative to the latent's scale,
    for one latent and for the stacked pair (2, h, w, 4) that the in-batch
    flow steps (DPM-Solver++'s state is then a pair of x0 predictions).
  * ``scale_model_input`` and ``init_noise_sigma`` agree.
  * The SD plain pass under DDIM, Euler and DPM-Solver++, and the rich pass
    under DDIM and DPM-Solver++ (with in-batch injection), on the tiny
    configs in float32 from the same latents and parameters: within 1e-4
    of each output's scale of the JAX package's. Euler's rich pass raises
    in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu import schedulers as J
from rich_text_to_image_tpu.pipelines import region_sd as JP
from rich_text_to_image_tpu_torch import schedulers as T
from rich_text_to_image_tpu_torch.pipelines import region_sd as TP
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

NAMES = ["DDIMScheduler", "EulerDiscreteScheduler",
         "DPMSolverMultistepScheduler", "PNDMScheduler"]


@pytest.mark.parametrize("steps", [4, 12, 41])
@pytest.mark.parametrize("name", NAMES[:3])
def test_plan_arrays_equal_jax(name, steps):
    jp = getattr(J, name)().plan(steps)
    tp = getattr(T, name)().plan(steps)
    assert type(tp).__name__ == type(jp).__name__
    fields = [f.name for f in dataclasses.fields(jp)]
    assert fields == [f.name for f in dataclasses.fields(tp)]
    for f in fields:
        a, b = getattr(jp, f), getattr(tp, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_rollout_matches_jax(name, rows):
    steps = 12
    js, ts = getattr(J, name)(), getattr(T, name)()
    jplan, tplan = js.plan(steps), ts.plan(steps)
    rng = np.random.default_rng(rows)
    shape = (rows, 8, 8, 4)
    x0 = rng.standard_normal(shape).astype(np.float32)
    x0 *= getattr(jplan, "init_noise_sigma", 1.0)
    eps = rng.standard_normal((jplan.num_steps, *shape)).astype(np.float32)
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    jst = js.init_state(shape)
    tst = ts.init_state(shape, "cpu")
    scale = np.abs(x0).max()
    for i in range(jplan.num_steps):
        jin = js.scale_model_input(jplan, i, jx)
        tin = ts.scale_model_input(tplan, i, tx)
        np.testing.assert_allclose(tin.numpy(), np.asarray(jin), rtol=0,
                                   atol=1e-6 * scale)
        # a model output that depends on the input, as a UNet's does
        e = eps[i] + 0.1 * np.asarray(jin)
        jx, jst = js.step(jplan, i, jst, jnp.asarray(e), jx)
        tx, tst = ts.step(tplan, i, tst, torch.from_numpy(e), tx)
        scale = max(scale, np.abs(np.asarray(jx)).max())
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                                   atol=1e-6 * scale, err_msg=f"step {i}")
    if name == "DPMSolverMultistepScheduler":
        assert tuple(tst.shape) == shape  # the pair's x0 predictions
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=0,
                                   atol=1e-6 * np.abs(np.asarray(jst)).max())


@pytest.mark.parametrize("name", NAMES)
def test_init_noise_sigma_and_input_scale(name):
    js, ts = getattr(J, name)(), getattr(T, name)()
    jplan, tplan = js.plan(12), ts.plan(12)
    # the pipelines read the plan's sigma, 1.0 where the plan has none
    assert (getattr(tplan, "init_noise_sigma", 1.0)
            == getattr(jplan, "init_noise_sigma", 1.0))
    if name == "EulerDiscreteScheduler":
        assert tplan.init_noise_sigma > 14.0  # sqrt(sigma_max^2 + 1)
        assert tplan.timesteps.dtype == np.float32
        assert not np.all(tplan.timesteps == np.round(tplan.timesteps))
    else:
        assert np.issubdtype(tplan.timesteps.dtype, np.integer)
    if hasattr(js, "init_noise_sigma"):
        assert ts.init_noise_sigma() == js.init_noise_sigma() == 1.0
    x = np.random.default_rng(0).standard_normal((1, 4, 4, 4)).astype(
        np.float32)
    for i in (0, 5, 11):
        np.testing.assert_allclose(
            ts.scale_model_input(tplan, i, torch.from_numpy(x)).numpy(),
            np.asarray(js.scale_model_input(jplan, i, jnp.asarray(x))),
            rtol=1e-7, atol=0)


def test_step_counts():
    """UNet calls a pass: DDIM, Euler and DPM run one a step, PNDM one more
    (its second timestep is repeated)."""
    for name, extra in zip(NAMES, (0, 0, 0, 1)):
        for steps in (4, 12, 41):
            assert getattr(T, name)().plan(steps).num_steps == steps + extra


# ------------------------------------------- the SD passes under each of them
H, PX, STEPS, G = 8, 16, 12, 7.5
PROMPTS = ["a tall tree", "a red rose", "a garden with a rose bush"]


@pytest.fixture(scope="module")
def pipes():
    from torch_port_pipes import tiny_pipes

    jp, tp = tiny_pipes()
    rng = np.random.default_rng(7)
    soft = rng.random((3, 1, H, H)).astype(np.float32) + 0.1
    soft /= soft.sum(axis=0, keepdims=True)
    jp.masks = tp.masks = [m for m in soft]
    lat0 = rng.standard_normal((1, H, H, 4)).astype(np.float32)
    return jp, tp, lat0


def _use(pipes, name):
    jp, tp, lat0 = pipes
    jp.scheduler, tp.scheduler = getattr(J, name)(), getattr(T, name)()
    jp._jit_cache.clear()  # its keys do not name the scheduler
    return jp, tp, lat0


def _rich(pipe, mod, lat, **kw):
    m = np.zeros((1, PX, PX), np.float32)
    m[:, :, :PX // 2] = 1.0
    fmt = {"word_pos": np.array([3]), "font_size": np.array([2.0]),
           "target_RGB": [np.array([0.9, 0.1, 0.1])],
           "guidance_start_step": 999, "color_guidance_weight": 0.5,
           "color_obj_atten": [m],
           "color_obj_atten_all": np.full((1, H, H), 0.5, np.float32)}
    spec = mod.RichControlSpec(guidance_scale=G, use_guidance=True,
                               color_guidance_weight=0.5, **kw)
    return pipe.produce_latents(
        pipe.get_text_embeds(PROMPTS, [""]), height=PX, width=PX,
        num_inference_steps=STEPS, latents=lat, spec=spec,
        text_format_dict=fmt)


@pytest.mark.parametrize("name", NAMES[:3])
def test_plain_pass_matches_jax(pipes, name):
    """produce_attn_maps: the aggregates within 1e-4 of their scale, the
    image within one uint8 step; Euler's float timesteps reach the UNet
    unrounded and its first latent is scaled by the plan's sigma."""
    from torch_port_pipes import close

    jp, tp, lat0 = _use(pipes, name)
    kw = dict(height=PX, width=PX, num_inference_steps=STEPS,
              guidance_scale=G)
    j_img, j_agg = jp.produce_attn_maps([PROMPTS[-1]], [""],
                                        latents=jnp.asarray(lat0), **kw)
    seen = []
    orig = tp.unet.embed_time
    tp.unet.embed_time = lambda t, b, *cond: seen.append(t) or orig(t, b,
                                                                  *cond)
    try:
        t_img, t_agg = tp.produce_attn_maps([PROMPTS[-1]], [""],
                                            latents=lat0, **kw)
    finally:
        del tp.unet.embed_time
    np.testing.assert_array_equal(np.asarray(seen),
                                  tp.scheduler.plan(STEPS).timesteps)
    assert np.abs(t_img.astype(int) - np.asarray(j_img).astype(int)).max() <= 1
    close(t_agg.self_sum, j_agg.self_sum)
    for r, c in j_agg.cross_sums.items():
        close(t_agg.cross_sums[r], c)


@pytest.mark.parametrize("name,inject", [
    ("DDIMScheduler", 0.0), ("DPMSolverMultistepScheduler", 0.4)])
def test_rich_pass_matches_jax(pipes, name, inject):
    """With font-size reweighting and colour guidance; under DPM-Solver++
    with in-batch injection too, so that its state is the stacked pair."""
    from torch_port_pipes import close

    jp, tp, lat0 = _use(pipes, name)
    kw = dict(inject_selfattn=inject, inject_background=inject)
    j_lat = _rich(jp, JP, jnp.asarray(lat0), **kw)
    t_lat = _rich(tp, TP, lat0, **kw)
    close(t_lat, j_lat)


def test_euler_rich_pass_raises_as_in_jax(pipes):
    """The JAX package's rich pass indexes alphas_cumprod with Euler's float
    timesteps and raises IndexError (pipelines/region_sd.py:772); the port
    refuses the same request with a ValueError naming that line."""
    jp, tp, lat0 = _use(pipes, "EulerDiscreteScheduler")
    with pytest.raises(IndexError):
        _rich(jp, JP, jnp.asarray(lat0))
    with pytest.raises(ValueError, match="region_sd.py:772"):
        _rich(tp, TP, lat0)
