"""The port's SDXL pipeline against the JAX package's.

One tiny JAX SDXL pipeline (TINY_XL_UNET, TINY_VAE, two tiny text towers,
the second projected, as in tests/test_pipeline_sdxl.py) and the port's on
its parameters, float32 on the CPU, from the same numpy latents:

  * ``encode_prompt``: the [uncond, prompts...] layout, 64 = 32 + 32 wide,
    the projected pooled rows, zero rows for an empty negative prompt;
  * the plain pass under Euler: the image, the self maps summed over the
    steps from ``agg_start_step`` on and over every attn1 layer at the
    segmentation level, the cross sums, and the refer cache;
  * the rich pass under Euler (the JAX ``_rich_fn`` and
    ``_rich_fn_refpre``): no injection, in-batch injection with the refer
    rows dropped past their last use, background injection alone (the
    refer trajectory frozen at the background step), refer-precompute,
    encoder reuse, with font-size weights and colour guidance, and the
    guidance pooled by 2 — each final latent within 1e-4 of its scale;
  * ``sample``, the single entry, in both branches, with SDXL's
    micro-conditioning (original size, crop corner, target size) at its
    defaults and not; its wrappers, the one-prompt guard, the default size,
    and a refer cache refused under other time ids;
  * the CLI flow for ``--model SDXL`` at the tiny size.

Tolerance: 1e-4 relative to each output's scale (float32 through two
passes whose sums run in another order); uint8 images within 1 step.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.pipelines import region_sdxl as JX
from rich_text_to_image_tpu.pipelines.region_sd import RichControlSpec as JSpec
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.cli import sample as t_cli
from rich_text_to_image_tpu_torch.models.clip import CLIPTextModel
from rich_text_to_image_tpu_torch.models.tokenizer import CLIPTokenizer
from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
from rich_text_to_image_tpu_torch.models.vae import AutoencoderKL
from rich_text_to_image_tpu_torch.pipelines import region_sdxl as TX
from rich_text_to_image_tpu_torch.pipelines.region_sd import RichControlSpec
from torch_port_pipes import close
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

TEXT2 = C.CLIPTextConfig(vocab_size=1000, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         hidden_act="gelu", projection_dim=32)
H, PX, STEPS, G = 16, 32, 6, 5.0
PROMPTS = ["a tall tree", "a red rose", "a garden with a rose bush"]


def xl_port_of(jp, **kw):
    """The port's RegionDiffusionXL on the JAX pipeline ``jp``'s
    parameters."""
    tree = lambda p: jax.tree.map(np.asarray, p)
    pooled = jp.text_encoder_2.cfg.projection_dim
    unet_cfg = dataclasses.replace(
        jp.unet_cfg, projection_class_embeddings_input_dim=(
            pooled + 6 * jp.unet_cfg.addition_time_embed_dim))
    tok = CLIPTokenizer.byte_level()
    return TX.RegionDiffusionXL(
        weights.load_flax(UNet2DCondition(unet_cfg), tree(jp.unet_params),
                          "unet"),
        weights.load_flax(AutoencoderKL(jp.vae_cfg), tree(jp.vae_params),
                          "vae"),
        weights.load_flax(CLIPTextModel(jp.text_encoder.cfg),
                          tree(jp.text_params), "text"),
        weights.load_flax(CLIPTextModel(jp.text_encoder_2.cfg),
                          tree(jp.text2_params), "text"),
        tok, tok, unet_cfg, jp.vae_cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def pipes():
    jp = JX.RegionDiffusionXL.random_init(
        seed=0, unet_cfg=C.TINY_XL_UNET, vae_cfg=C.TINY_VAE,
        text_cfg=C.TINY_TEXT, text2_cfg=TEXT2, dtype=jnp.float32,
        agg_start_step=3)
    tp = xl_port_of(jp, agg_start_step=3)
    rng = np.random.default_rng(5)
    soft = rng.random((3, 1, H, H)).astype(np.float32) + 0.1
    soft /= soft.sum(axis=0, keepdims=True)
    jp.masks = tp.masks = [m for m in soft]
    lat0 = rng.standard_normal((1, H, H, 4)).astype(np.float32)
    return jp, tp, lat0


def test_encode_prompt_layout_matches_jax(pipes):
    jp, tp, _ = pipes
    je, jpool = jp.encode_prompt(["a cat", "a dog"], "")
    te, tpool = tp.encode_prompt(["a cat", "a dog"], "")
    assert te.shape == (3, 77, 64) and tpool.shape == (3, 32)
    assert te[0].abs().max() == 0 and tpool[0].abs().max() == 0
    close(te.numpy(), je)
    close(tpool.numpy(), jpool)
    je2, jp2 = jp.encode_prompt(["a cat"], "ugly")
    te2, tp2 = tp.encode_prompt(["a cat"], ["ugly"])
    assert te2[0].abs().max() > 0
    close(te2.numpy(), je2)
    close(tp2.numpy(), jp2)
    # a prompt's rows do not depend on the others encoded with it
    solo, solo_p = tp.encode_prompt(["a dog"], "")
    np.testing.assert_array_equal(solo[1].numpy(), te[2].numpy())
    np.testing.assert_array_equal(solo_p[1].numpy(), tpool[2].numpy())
    np.testing.assert_array_equal(
        tp._get_add_time_ids((32, 48), (0, 0), (32, 48)),
        jp._get_add_time_ids((32, 48), (0, 0), (32, 48)))


def _steps(pipe, inject_selfattn):
    plan = pipe.scheduler.plan(STEPS)
    gates = plan.timesteps.astype(np.float64) > (1 - inject_selfattn) * 1000
    return tuple(np.nonzero(gates)[0].tolist())


def test_plain_pass_and_refer_cache_match_jax(pipes):
    """Euler's plain pass: the image, the accumulated self maps over all
    attn1 layers at the segmentation level, the cross sums, and the refer
    cache of the injection steps."""
    jp, tp, lat0 = pipes
    steps = _steps(tp, 0.4)
    kw = dict(height=PX, width=PX, num_inference_steps=STEPS,
              guidance_scale=G, ref_capture_steps=steps)
    j_img, j_agg = jp.produce_attn_maps([PROMPTS[-1]], [""],
                                        latents=jnp.asarray(lat0), **kw)
    t_img, t_agg = tp.produce_attn_maps([PROMPTS[-1]], [""], latents=lat0,
                                        **kw)
    assert np.abs(t_img.astype(int) - np.asarray(j_img).astype(int)).max() <= 1
    seg, layers, _ = tp._capture_layout((H, H))
    assert seg == 8 and t_agg.self_count == j_agg.self_count == len(layers)
    # attn1 layers at 8^2: down_blocks.1 (2 x 1), up_blocks.1 (3 x 1)
    assert len(layers) == 5
    close(t_agg.self_sum.numpy(), np.asarray(j_agg.self_sum))
    # summed over 3 steps: each row sums to layers x steps
    np.testing.assert_allclose(t_agg.self_sum.sum(1).numpy(),
                               len(layers) * (STEPS - 3), rtol=1e-4)
    assert set(t_agg.cross_sums) == set(j_agg.cross_sums)
    for r in t_agg.cross_sums:
        close(t_agg.cross_sums[r], j_agg.cross_sums[r])
    assert t_agg.cross_layer_count == j_agg.cross_layer_count
    tc, jc = tp.ref_cache, jp.ref_cache
    assert tc["steps"] == tuple(jc["steps"]) == steps
    np.testing.assert_allclose(tc["fp"], jc["fp"], rtol=1e-5, atol=1e-4)
    close(tc["traj"].reshape(STEPS + 1, H, H * 4).numpy(), jc["traj"])
    assert set(tc["qk"]) == set(jc["qk"])
    n = len(steps)
    for name, (q, k) in tc["qk"].items():
        close(q.numpy(), jc["qk"][name][0][:n])
        close(k.numpy(), jc["qk"][name][1][:n])
    for name, f in tc["resnet"].items():
        close(f.numpy(), jc["resnet"][name][:n])
    assert tp._ref_qk_bytes_per_slot((H, H)) == jp._ref_qk_bytes_per_slot(
        (H, H))


def _fmt(font: bool, color: bool):
    fmt = {}
    if font:
        fmt.update(word_pos=np.array([3, 4]), font_size=np.array([2.5, -0.5]))
    if color:
        m = np.zeros((1, PX, PX), np.float32)
        m[:, :, :PX // 2] = 1.0
        fmt.update(target_RGB=[np.array([0.9, 0.1, 0.1])],
                   guidance_start_step=999, color_guidance_weight=0.5,
                   color_obj_atten=[m],
                   color_obj_atten_all=np.full((1, H, H), 0.5, np.float32))
    return fmt


def _jax_rich(jp, lat0, spec, fmt, ref_cache=None):
    e, p = jp.encode_prompt(PROMPTS, "")
    tid = jnp.asarray(jp._get_add_time_ids((PX, PX), (0, 0), (PX, PX)))
    plan = jp.scheduler.plan(STEPS)
    return np.asarray(jp._sample_rich(
        e, p, tid, (H, H), plan, spec, dict(fmt),
        jnp.asarray(lat0) * plan.init_noise_sigma, (PX, PX),
        return_latents=True, ref_cache=ref_cache))


def _port_rich(tp, lat0, spec, fmt, ref_cache=None):
    e, p = tp.encode_prompt(PROMPTS, "")
    seen = []  # the rows of each UNet decode (every forward, and every
    # launch of the encoder-reuse flow, ends in conv_out)
    hook = tp.unet.conv_out.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].shape[0]))
    try:
        lat = tp.rich_latents(e, p, PX, PX, STEPS, lat0, spec, dict(fmt),
                              ref_cache=ref_cache)
    finally:
        hook.remove()
    return lat.numpy(), seen


CASES = {
    # name: (inject_selfattn, inject_background, encoder_reuse, font, colour,
    #        guidance_downsample, the UNet batches of the port's rich pass)
    "plain": (0.0, 0.0, 1, True, True, 1, [4] * STEPS),
    # injection at steps 0-1 and the background at step 1: the refer rows
    # go after step 1
    "in_batch": (0.3, 0.3, 1, True, True, 1, [6, 6, 4, 4, 4, 4]),
    # background alone: the refer trajectory steps while i < 0.5 * 6, so
    # its rows go at the background step 3, which composites the refer
    # latent frozen at step 2's result
    "background": (0.0, 0.5, 1, False, False, 1, [6, 6, 6, 4, 4, 4]),
    # encoder reuse: two launches a step, [uncond, base, ref_u, ref_c] and
    # the spans
    "encoder_reuse": (0.3, 0.3, 2, True, False, 1, [4, 2] * STEPS),
    "gds2": (0.0, 0.0, 1, False, True, 2, [4] * STEPS),
}


@pytest.mark.parametrize("name", list(CASES))
def test_rich_pass_matches_jax(pipes, name):
    jp, tp, lat0 = pipes
    sa, bg, er, font, color, gds, batches = CASES[name]
    kw = dict(guidance_scale=G, inject_selfattn=sa, inject_background=bg,
              use_guidance=color, color_guidance_weight=0.5,
              encoder_reuse=er, guidance_downsample=gds)
    fmt = _fmt(font, color)
    want = _jax_rich(jp, lat0, JSpec(**kw), fmt)
    got, seen = _port_rich(tp, lat0, RichControlSpec(**kw), fmt)
    assert seen == batches
    close(got, want)


@pytest.mark.parametrize("font,color", [(True, True), (False, False)])
def test_refpre_rich_pass_matches_jax(pipes, font, color):
    """The refer-precompute flow (JAX ``_rich_fn_refpre``): R+2 rows at
    every step, from the plain pass's cache; and its latent within 2e-3 of
    the in-batch flow's (relative to the mean |latent|), as
    tests/test_ref_precompute.py holds the JAX package's."""
    jp, tp, lat0 = pipes
    steps = _steps(tp, 0.3)
    kw = dict(height=PX, width=PX, num_inference_steps=STEPS,
              guidance_scale=G, ref_capture_steps=steps)
    jp.produce_attn_maps([PROMPTS[-1]], [""], latents=jnp.asarray(lat0), **kw)
    tp.produce_attn_maps([PROMPTS[-1]], [""], latents=lat0, **kw)
    spec = dict(guidance_scale=G, inject_selfattn=0.3, inject_background=0.3,
                use_guidance=color, color_guidance_weight=0.5)
    fmt = _fmt(font, color)
    want = _jax_rich(jp, lat0, JSpec(**spec), fmt, jp.ref_cache)
    got, seen = _port_rich(tp, lat0, RichControlSpec(**spec), fmt,
                           tp.ref_cache)
    assert seen == [4] * STEPS
    close(got, want)
    in_batch, _ = _port_rich(tp, lat0, RichControlSpec(**spec), fmt)
    assert np.abs(got - in_batch).max() <= 2e-3 * np.abs(in_batch).mean()


def test_refpre_cache_of_another_run_is_not_taken(pipes):
    """A cache from another seed's latent fails the fingerprint: the
    in-batch flow runs (R+4 rows while the refer trajectory is read)."""
    _, tp, lat0 = pipes
    steps = _steps(tp, 0.3)
    tp.produce_attn_maps([PROMPTS[-1]], [""], height=PX, width=PX,
                         num_inference_steps=STEPS, guidance_scale=G,
                         latents=lat0 + 1.0, ref_capture_steps=steps)
    spec = RichControlSpec(guidance_scale=G, inject_selfattn=0.3,
                           inject_background=0.3)
    _, seen = _port_rich(tp, lat0, spec, {}, tp.ref_cache)
    assert seen == [6, 6, 4, 4, 4, 4]


def test_decode_watermarks_and_tiles(pipes):
    """``decode_latents``: the watermark from 256 px on (none below), the
    tiled and sliced decodes, and ``watermark = None`` opting out."""
    _, tp, _ = pipes
    from rich_text_to_image_tpu_torch.utils.watermark import (
        WATERMARK_BITS, decode_watermark)
    z = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 128, 128, 4)).astype(np.float32)) * 0.3
    img = tp.decode_latents(z)
    assert img.shape == (2, 256, 256, 3) and img.dtype == np.uint8
    assert decode_watermark(img[0])[0] == WATERMARK_BITS
    tp.watermark = None
    raw = tp.decode_latents(z)
    tp.enable_vae_slicing()
    np.testing.assert_array_equal(tp.decode_latents(z), raw)
    tp.disable_vae_slicing()
    tp.watermark = True
    assert tp._vae_tiling is False and tp._vae_slicing is False


def test_cli_flow_for_sdxl_on_cpu(pipes, tmp_path):
    """``run_sample`` with ``--model SDXL`` (Euler, the CLI's default for
    it) at the tiny size: the plain and rich images, the figures and, with
    ``--save_attn``, the maps; and with injection through the refer cache
    and the turbo knobs."""
    _, tp, _ = pipes
    doc = {"ops": [
        {"insert": "a "},
        {"attributes": {"link": "a cat with a hat"}, "insert": "cat"},
        {"insert": " and a "},
        {"attributes": {"color": "#ff0000"}, "insert": "rose"},
        {"insert": " in a "},
        {"attributes": {"size": "60px"}, "insert": "garden"}]}
    for extra in ([], ["--inject_selfattn", "0.3", "--inject_background",
                       "0.3", "--encoder_reuse", "2",
                       "--guidance_downsample", "2", "--bf16_guidance"]):
        run_dir = tmp_path / str(len(extra))
        args = t_cli.make_parser().parse_args(
            ["--model", "SDXL", "--run_dir", str(run_dir), "--sample_steps",
             "4", "--device", "cpu", "--rich_text_json", json.dumps(doc),
             "--num_segments", "3", "--save_attn", *extra])
        t_cli.check_args(args)
        param = {"text_input": doc, "height": PX, "width": PX,
                 "guidance_weight": G, "steps": 4, "noise_index": 1,
                 "negative_prompt": ""}
        default = tp.agg_start_step
        tp.agg_start_step = 1
        try:
            plain, rich, seconds = t_cli.run_sample(tp, args, param)
        finally:
            tp.agg_start_step = default
        assert plain.shape == rich.shape == (1, PX, PX, 3)
        assert rich.std() > 0
        names = sorted(p.name for p in run_dir.iterdir())
        assert names == sorted([
            "average_seed1_attn0.png", "average_seed1_attn1.png", "maps",
            "segmentation_k3_seed1.png", "seed1_plain.png", "seed1_rich.png"])
        assert sorted(p.name for p in (run_dir / "maps").iterdir()) == [
            "crossattn_maps.npy", "selfattn_maps.npy"]
    assert tp.ref_cache is not None  # the injection run took the cache


def test_capture_layout_at_768_takes_the_next_finer_level():
    """At 1024^2 the SDXL capture layout is the JAX package's: all 60
    attn1 layers at 32 rows. A 768^2 latent (96 rows: levels at 96, 48
    and 24) has no level at 32 rows: the JAX ``_capture_layout`` then
    names no layer (region_sdxl.py:301-317) and segments a zero affinity;
    the port takes the 48-row level (the 10 attn1 layers of
    down_blocks.1 and up_blocks.1), as its SD pipeline does."""
    stub_t = TX.RegionDiffusionXL.__new__(TX.RegionDiffusionXL)
    stub_j = JX.RegionDiffusionXL.__new__(JX.RegionDiffusionXL)
    stub_t.unet_cfg = stub_j.unet_cfg = C.SDXL_UNET
    t_res, t_layers, t_cross = stub_t._capture_layout((128, 128))
    j_res, j_layers, j_cross = stub_j._capture_layout((128, 128))
    assert (t_res, tuple(t_layers), t_cross) == (j_res, tuple(j_layers),
                                                 j_cross)
    assert t_res == 32 and len(t_layers) == 60
    j_res, j_layers, _ = stub_j._capture_layout((96, 96))
    t_res, t_layers, _ = stub_t._capture_layout((96, 96))
    assert (j_res, j_layers) == (32, ())
    assert t_res == 48 and len(t_layers) == 10


def test_random_init_draws_on_the_device():
    """``RegionDiffusionXL.random_init`` builds the modules on the meta
    device and draws the weights where they lie (the CPU here, the card
    in the smoke run): the same seed gives the same weights, N(0, 1/fan_in)
    matrices, unit norms and zero biases, in the UNet's dtype; the
    pipeline runs its plain pass."""
    kw = dict(seed=0, unet_cfg=C.TINY_XL_UNET, vae_cfg=C.TINY_VAE,
              text_cfg=C.TINY_TEXT, text2_cfg=TEXT2, device="cpu")
    a = TX.RegionDiffusionXL.random_init(dtype=torch.float32, **kw)
    b = TX.RegionDiffusionXL.random_init(dtype=torch.float32, **kw)
    for x, y in zip(a.unet.state_dict().values(),
                    b.unet.state_dict().values()):
        assert torch.equal(x, y)
    sd = a.unet.state_dict()
    assert abs(sd["conv_in.weight"].std().item() - (4 * 9) ** -0.5) < 0.02
    assert torch.equal(sd["conv_norm_out.weight"],
                       torch.ones_like(sd["conv_norm_out.weight"]))
    assert sd["add_embedding.linear_1.bias"].abs().max() == 0
    assert a.text_encoder_2.text_projection.weight.dtype == torch.float32
    img, agg = a.produce_attn_maps(["a cat"], [""], height=PX, width=PX,
                                   num_inference_steps=2)
    assert img.shape == (1, PX, PX, 3) and img.std() > 0
    bf = TX.RegionDiffusionXL.random_init(dtype=torch.bfloat16, **kw)
    assert bf.unet.dtype == torch.bfloat16 and bf.vae.decoder.conv_in.weight \
        .dtype == torch.float32


# --------------------------------------------------------------- sample()
MICRO = dict(original_size=(48, 24), crops_coords_top_left=(4, 8),
             target_size=(24, 40))


def _sampled(pipe, rich: bool, latents, **kw):
    """``pipe.sample`` with the decode the identity (the final latent) and
    the UNet batches of each forward."""
    prompts = PROMPTS if rich else [PROMPTS[-1]]
    seen = []
    mods = ([pipe.unet.conv_out] if isinstance(pipe, TX.RegionDiffusionXL)
            else [])
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].shape[0])) for m in mods]
    decode = pipe.decode_latents
    pipe.decode_latents = lambda lat: np.asarray(lat)
    try:
        out = pipe.sample(prompts, "", height=PX, width=PX,
                          num_inference_steps=STEPS, guidance_scale=G,
                          run_rich_text=rich, latents=latents, **kw)
    finally:
        pipe.decode_latents = decode
        for h in hooks:
            h.remove()
    return np.asarray(out), seen


@pytest.mark.parametrize("micro", [False, True], ids=["default", "micro"])
@pytest.mark.parametrize("rich", [False, True], ids=["plain", "rich"])
def test_sample_matches_jax(pipes, rich, micro):
    """``sample`` in both branches against the JAX package's, at the
    default micro-conditioning and at another original size, crop corner
    and target size: the final latent within 1e-4 of its scale; the plain
    branch's aggregates too. The micro-conditioning moves the latent."""
    jp, tp, lat0 = pipes
    # both on the fixture's masks (the CLI test leaves its own on the port)
    soft = np.random.default_rng(5).random((3, 1, H, H)).astype(
        np.float32) + 0.1
    jp.masks = tp.masks = list(soft / soft.sum(axis=0, keepdims=True))
    kw = dict(inject_selfattn=0.3, inject_background=0.3) if rich else {}
    kw.update(MICRO if micro else {})
    want, _ = _sampled(jp, rich, jnp.asarray(lat0), **kw)
    got, _ = _sampled(tp, rich, lat0, **kw)
    close(got, want)
    if not rich:
        close(tp.attn_aggregates.self_sum.numpy(),
              np.asarray(jp.attn_aggregates.self_sum))
    if micro:
        base, _ = _sampled(tp, rich, lat0,
                           **{k: v for k, v in kw.items() if k not in MICRO})
        assert np.abs(got - base).max() > 1e-3 * np.abs(base).max()


def test_sample_wrappers_and_defaults(pipes):
    """``produce_attn_maps`` and ``prompt_to_img`` are ``sample``'s
    branches to the bit; the plain branch takes one prompt; height and
    width default to ``default_sample_size`` latent pixels, as JAX's."""
    jp, tp, lat0 = pipes
    kw = dict(height=PX, width=PX, num_inference_steps=2, guidance_scale=G,
              latents=lat0)
    img, agg = tp.produce_attn_maps([PROMPTS[-1]], "", **kw)
    assert agg is tp.attn_aggregates
    np.testing.assert_array_equal(img, tp.sample([PROMPTS[-1]], "", **kw))
    np.testing.assert_array_equal(
        tp.prompt_to_img(PROMPTS, "", inject_selfattn=0.3, **kw),
        tp.sample(PROMPTS, "", run_rich_text=True, inject_selfattn=0.3, **kw))
    for call in (lambda: tp.sample(PROMPTS[:2], ""),
                 lambda: tp.produce_attn_maps(PROMPTS[:2], "", **kw)):
        with pytest.raises(ValueError, match="exactly one prompt"):
            call()
    assert tp.default_sample_size == jp.default_sample_size == H
    assert tp.vae_scale_factor == jp.vae_scale_factor == PX // H
    img = tp.sample(PROMPTS[-1], num_inference_steps=1)
    assert img.shape == (1, PX, PX, 3)


def test_refer_cache_is_refused_across_micro_conditioning(pipes):
    """A refer cache from the plain branch under the default time ids is
    taken by a rich call under the same ones (R+2 = 4 rows a step) and
    refused under another crop corner (the in-batch flow's R+4 = 6 rows
    while the refer trajectory is read); the fingerprints differ only in
    the time ids."""
    _, tp, lat0 = pipes
    steps = _steps(tp, 0.3)
    rich = dict(inject_selfattn=0.3, inject_background=0.3)
    _sampled(tp, False, lat0, ref_capture_steps=steps)
    cache = tp.ref_cache
    _, same = _sampled(tp, True, lat0, ref_cache=cache, **rich)
    _, other = _sampled(tp, True, lat0, ref_cache=cache,
                        crops_coords_top_left=(0, 8), **rich)
    assert same == [4] * STEPS
    assert other == [6, 6, 4, 4, 4, 4]
    fp = cache["fp"]
    _sampled(tp, False, lat0, ref_capture_steps=steps,
             crops_coords_top_left=(0, 8))
    moved = [i for i, (a, b) in enumerate(zip(fp, tp.ref_cache["fp"]))
             if a != b]
    assert moved == [len(fp) - 2, len(fp) - 1]  # the time ids' sums
