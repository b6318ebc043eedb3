"""The JAX package's quality gates on the trained colour fixture, through
the port.

``evaluation.fixtures.load_color_fixture`` rebuilds the trained tiny
pipeline (a VAE whose decode is colour-faithful, a UNet trained on
coloured squares); its parameters are carried into the port with
``weights.load_flax``, and the port's own loader of the same files must
give the same UNet and VAE. The port's ``prompt_to_img`` must then pass the
thresholds of ``tests/test_color_fixture.py``: the committed meta and the
decoder's colour round trip (:26-50), colour guidance steers the
region toward its target (:74-81), so does guidance at half size
(:84-90), the two-region composition with injection and font-size
reweighting steers both regions to their own colours (:166-180), and
encoder reuse, the bfloat16 guidance decode and the half-size decode track
the exact run (:183-200, :203-214). Same latents as the JAX gates (their
``PRNGKey(7)`` draw, passed in), float32 on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.evaluation.fixtures import (fixture_meta,
                                                        load_color_fixture)
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.evaluation import fixtures as TF
from torch_port_pipes import port_of
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def model():
    jp = load_color_fixture()
    tp = port_of(jp)
    h = tp.unet_cfg.sample_size
    lat = np.array(jax.random.normal(jax.random.PRNGKey(7), (1, h, h, 4)))
    return tp, lat, {}


def _run(model, use_guidance, steps=12, weight=1.0, **kw):
    tp, lat, memo = model
    key = ("one", use_guidance, steps, weight, tuple(sorted(kw.items())))
    if key in memo:
        return memo[key]
    px = tp.unet_cfg.sample_size * tp.vae_scale_factor
    h = tp.unet_cfg.sample_size
    mask = np.zeros((1, h, h), np.float32)
    mask[:, :, : h // 2] = 1.0  # left half = the steered region
    tp.masks = [mask, 1.0 - mask]
    mask_px = np.zeros((1, px, px), np.float32)
    mask_px[:, :, : px // 2] = 1.0
    target = np.asarray([[1.0, 0.0, 0.0]], np.float32)  # red
    fmt = {"guidance_start_step": 999, "color_guidance_weight": weight,
           "target_RGB": [target[0]], "color_obj_atten": [mask_px],
           "color_obj_atten_all": mask}
    img = tp.prompt_to_img(
        ["a red square", "a square"], [""], height=px, width=px,
        num_inference_steps=steps, guidance_scale=8.5, latents=lat,
        text_format_dict=fmt, use_guidance=use_guidance, **kw)
    region = img[0][:, : px // 2].astype(np.float32) / 255.0
    memo[key] = float(np.linalg.norm(region - target[0], axis=-1).mean())
    return memo[key]


def _run_two_region(model, use_guidance, steps=12, **kw):
    """Left half 'a red square', right half 'a blue square', with
    self-attention injection and font-size reweighting on; returns the mean
    L2 distances (left->red, left->blue, right->blue, right->red)."""
    tp, lat, memo = model
    key = ("two", use_guidance, steps, tuple(sorted(kw.items())))
    if key in memo:
        return memo[key]
    px = tp.unet_cfg.sample_size * tp.vae_scale_factor
    h = tp.unet_cfg.sample_size
    left = np.zeros((1, h, h), np.float32)
    left[:, :, : h // 2] = 1.0
    right = 1.0 - left
    tp.masks = [left, right, np.zeros_like(left)]
    left_px = np.zeros((1, px, px), np.float32)
    left_px[:, :, : px // 2] = 1.0
    targets = np.asarray([[1, 0, 0], [0, 0, 1]], np.float32)
    fmt = {
        "guidance_start_step": 999, "color_guidance_weight": 1.0,
        "target_RGB": [targets[0], targets[1]],
        "color_obj_atten": [left_px, 1.0 - left_px],
        "color_obj_atten_all": left[0] + right[0],
        "word_pos": np.asarray([2], np.int32),
        "font_size": np.asarray([2.0], np.float32),
    }
    img = tp.prompt_to_img(
        ["a red square", "a blue square", "a square"], [""],
        height=px, width=px, num_inference_steps=steps, guidance_scale=8.5,
        latents=lat, text_format_dict=fmt, use_guidance=use_guidance,
        inject_selfattn=0.3, **kw)
    im = img[0].astype(np.float32) / 255.0
    lt, rt = im[:, : px // 2], im[:, px // 2:]
    memo[key] = tuple(
        float(np.linalg.norm(reg - t, axis=-1).mean())
        for reg, t in ((lt, targets[0]), (lt, targets[1]),
                       (rt, targets[1]), (rt, targets[0])))
    return memo[key]


def test_guidance_steers_toward_target(model):
    d_plain = _run(model, use_guidance=False)
    d_ours = _run(model, use_guidance=True)
    assert d_ours < d_plain - 0.05, (d_ours, d_plain)


def test_gds2_steers(model):
    d_plain = _run(model, use_guidance=False)
    d_gds2 = _run(model, use_guidance=True, guidance_downsample=2)
    assert d_gds2 < d_plain - 0.03, (d_gds2, d_plain)


def test_encoder_reuse_preserves_steering(model):
    d_plain = _run(model, use_guidance=False)
    d_exact = _run(model, use_guidance=True)
    d_er = _run(model, use_guidance=True, encoder_reuse=2,
                encoder_schedule="early")
    assert d_er < d_plain - 0.05, (d_er, d_plain)
    assert abs(d_er - d_exact) < 0.05, (d_er, d_exact)


def test_two_region_composition_steers_both_regions(model):
    pl_r, _, pr_b, _ = _run_two_region(model, use_guidance=False)
    gl_r, gl_b, gr_b, gr_r = _run_two_region(model, use_guidance=True)
    assert gl_r < pl_r - 0.15, (gl_r, pl_r)
    assert gr_b < pr_b - 0.15, (gr_b, pr_b)
    assert gl_b > gl_r + 0.4, (gl_b, gl_r)
    assert gr_r > gr_b + 0.4, (gr_r, gr_b)


@pytest.mark.parametrize("tag,kw,tol", [
    ("er2", dict(encoder_reuse=2, encoder_schedule="early"), 0.05),
    ("bf16g", dict(bf16_guidance=True), 0.05),
    ("gds2", dict(guidance_downsample=2), 0.12),
], ids=["er2", "bf16g", "gds2"])
def test_two_region_turbos_track_exact(model, tag, kw, tol):
    gl_r, _, gr_b, _ = _run_two_region(model, use_guidance=True)
    tl_r, tl_b, tr_b, tr_r = _run_two_region(model, use_guidance=True, **kw)
    assert abs(tl_r - gl_r) < tol and abs(tr_b - gr_b) < tol, (
        tag, (tl_r, tr_b), (gl_r, gr_b))
    assert tl_b > tl_r + 0.4 and tr_r > tr_b + 0.4, (
        tag, (tl_r, tl_b, tr_b, tr_r))


def test_meta_committed():
    meta = TF.fixture_meta(TF.FIXTURE_DIR)
    assert meta["configs"]["unet"] == "FIXTURE_UNET"
    # the trainer's own solid-colour probe must show a faithful decoder
    assert meta["vae_solid_color_roundtrip_mean_abs_drgb"] < 0.08


def test_decode_color_faithful(model):
    """encode -> decode of solid-colour images through the port's VAE keeps
    their mean RGB (``tests/test_color_fixture.py:33-50``)."""
    from rich_text_to_image_tpu_torch.utils.colors import COLORS

    tp = model[0]
    px = tp.unet_cfg.sample_size * tp.vae_scale_factor
    rgbs = np.asarray(list(COLORS.values()), np.float32) / 255.0
    probe = np.stack([np.full((px, px, 3), c, np.float32) * 2 - 1
                      for c in rgbs])
    with torch.no_grad():
        z = tp.vae.encode(torch.from_numpy(probe))
        rt = tp.vae.decode(z / tp.vae_cfg.scaling_factor).numpy()
    err = np.abs(rt - probe).mean() / 2.0  # [0,1] RGB units
    assert err < 0.08, f"decoder not colour-faithful: mean|dRGB|={err:.3f}"


def test_port_fixture_loader_equals_jax_loader():
    """``evaluation.fixtures.load_color_fixture`` reads the npz files into
    the port's modules: the UNet and VAE state dicts equal the JAX loader's
    bridged. The text encoder is each package's own random draw."""
    tp = TF.load_color_fixture(device="cpu")
    jp = load_color_fixture()
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    for mod, params, which in ((tp.unet, jp.unet_params, "unet"),
                               (tp.vae, jp.vae_params, "vae")):
        want = weights.from_flax(np_tree(params), which, mod)
        got = mod.state_dict()
        assert set(got) == set(want)
        for n, t in want.items():
            torch.testing.assert_close(got[n], t, rtol=0, atol=0, msg=n)
    assert tp.unet.dtype == torch.float32
    assert TF.fixture_meta() == fixture_meta()
