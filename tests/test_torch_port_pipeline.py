"""The slice as a whole: the port's RegionDiffusion against the JAX
package's at the tiny configs, on bridged weights and the same numpy
latents, plus the port's CLI flow.

Plain pass: latents and the capture aggregates; then the rich pass with the
JAX package's masks, font-size reweighting and colour guidance, to the
final latents. Both sides float32 on the CPU. Tolerance: 1e-4 relative to
each array's scale — 13 UNet calls and the PNDM multistep in float32, sums
in another order (max |d| seen ~2e-6 relative).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.ops.resize import resize_bicubic as j_resize
from rich_text_to_image_tpu.pipelines import region_sd as J
from rich_text_to_image_tpu.utils import richtext
from rich_text_to_image_tpu.utils import token_maps as j_tm
from rich_text_to_image_tpu_torch.cli import sample as t_cli
from rich_text_to_image_tpu_torch.models import unet as T_unet
from rich_text_to_image_tpu_torch.pipelines import region_sd as T
from torch_port_pipes import tiny_pipes
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS = 12  # 13 plan steps, past agg_start_step
H, PX = 8, 16  # TINY latent and pixel sizes
DOC = {"ops": [
    {"insert": "a "},
    {"attributes": {"link": "a tall tree"}, "insert": "garden"},
    {"insert": " with a "},
    {"attributes": {"color": "#ff0000", "size": "60px"}, "insert": "rose"},
    {"insert": " bush"},
]}


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


@pytest.fixture(scope="module")
def pipes():
    return tiny_pipes(agg_start_step=3)


@pytest.fixture(scope="module")
def plain(pipes):
    """Both plain passes on the same latents: (jax out, port out, inputs)."""
    jp, tp = pipes
    parsed = richtext.parse_json(DOC)
    lat0 = np.random.default_rng(0).standard_normal((1, H, H, 4)).astype(
        np.float32)
    emb_j = jp.get_text_embeds([parsed.base_text_prompt], [""])
    emb_t = tp.get_text_embeds([parsed.base_text_prompt], [""])
    seg, self_layers, cross_by_res = jp._capture_layout((H, H))
    plan = jp.scheduler.plan(STEPS)
    fn = jp._plain_fn((H, H), plan.num_steps, seg, self_layers,
                      tuple(sorted(cross_by_res.items())))
    j_out = fn(jp.unet_params, jnp.asarray(lat0), emb_j,
               J._plan_arrays(plan), jnp.float32(8.5))
    t_out = tp._plain_loop(torch.from_numpy(lat0), emb_t, STEPS, 8.5)
    return j_out, t_out, dict(parsed=parsed, lat0=lat0, emb_j=emb_j,
                              emb_t=emb_t, cross_by_res=cross_by_res,
                              self_layers=self_layers)


def test_text_embeds_match(plain):
    _, _, d = plain
    _close(d["emb_t"], d["emb_j"])


def test_plain_pass_latents_and_aggregates_match(plain):
    (j_lat, j_self, j_cross), (t_lat, t_self, t_cross, layers, by_res), d = plain
    assert layers == d["self_layers"]
    _close(t_lat, j_lat)
    _close(t_self, j_self)
    assert float(t_self.sum()) > 0
    for (r, _), jc in zip(sorted(by_res.items()), j_cross):
        assert float(jc.sum()) > 0  # accumulated after agg_start_step
        _close(t_cross[r], jc)


def test_rich_pass_matches_jax(pipes, plain):
    """produce_latents with the JAX package's masks, font-size reweighting
    and colour guidance, to the final latents."""
    jp, tp = pipes
    (_, j_self, j_cross), _, d = plain
    parsed = d["parsed"]
    tok = jp.tokenizer._tokenize
    prompts, region_ids, base = richtext.get_region_diffusion_input(tok,
                                                                    parsed)
    fmt = richtext.get_attention_control_input(tok, base, parsed)
    fmt, color_ids = richtext.get_gradient_guidance_input(
        tok, base, parsed, fmt, color_guidance_weight=0.5)
    assert fmt["word_pos"] is not None and parsed.use_grad_guidance
    agg = j_tm.AttnAggregates(
        self_sum=np.asarray(j_self), self_count=len(d["self_layers"]),
        cross_sums={r: np.asarray(c) for (r, _), c in
                    zip(sorted(d["cross_by_res"].items()), j_cross)},
        cross_layer_count=sum(len(v) for v in d["cross_by_res"].values()))
    seg = dict(segment_threshold=0.25, num_segments=3, n_init=5)
    cmasks = j_tm.get_token_maps(agg, color_ids[:-1], (H, H), 5, **seg)
    fmt["color_obj_atten"] = [np.asarray(j_resize(m, (PX, PX)))
                              for m in cmasks[:-1]]
    fmt["color_obj_atten_all"] = sum(np.asarray(m) for m in cmasks[:-1])
    masks = j_tm.get_token_maps(agg, region_ids[:-1], (H, H), 5, **seg)
    jp.masks = tp.masks = masks
    spec = dict(guidance_scale=8.5, use_guidance=True,
                color_guidance_weight=0.5)
    j_lat = jp.produce_latents(
        jp.get_text_embeds(prompts, [""]), height=PX, width=PX,
        num_inference_steps=STEPS, latents=jnp.asarray(d["lat0"]),
        spec=J.RichControlSpec(**spec), text_format_dict=fmt)
    t_lat = tp.produce_latents(
        tp.get_text_embeds(prompts, [""]), height=PX, width=PX,
        num_inference_steps=STEPS, latents=d["lat0"],
        spec=T.RichControlSpec(**spec), text_format_dict=fmt)
    _close(t_lat, j_lat)


def test_injection_raises(pipes):
    """Injection runs through the in-batch flow now (its parity is held in
    tests/test_torch_port_injection.py); what still raises is a source row
    with no destination. The prompt-to-prompt controls, which raised too,
    are held against the JAX package below."""
    _, tp = pipes
    tp.masks = [np.ones((1, H, H), np.float32)]
    img = tp.prompt_to_img(["a cat"], height=PX, width=PX,
                           num_inference_steps=2, inject_selfattn=0.3,
                           inject_background=0.3)
    assert img.shape == (1, PX, PX, 3) and img.dtype == np.uint8
    x, ctx = torch.zeros((1, H, H, 4)), torch.zeros((1, 77, 32))
    with pytest.raises(ValueError):
        tp.unet(x, 1, ctx, controls=T_unet.UNetControls(inject_src=0))


def test_cross_mapper_control_matches_jax(pipes):
    """The pipeline's UNet with the Replace mapper of a word swap (the
    ``cross_mapper`` control, which raised until prompt-to-prompt was
    ported) and the base prompt's cross probabilities, against JAX's."""
    from rich_text_to_image_tpu.models import unet as J_unet
    from rich_text_to_image_tpu_torch.utils.seq_aligner import (
        get_replacement_mapper)

    jp, tp = pipes
    base, edit = "a cat on a table", "a tiger on a table"
    mapper = get_replacement_mapper(base, edit, tp.tokenizer)
    emb = tp.get_text_embeds([base, edit], [""]).numpy()
    x = np.random.default_rng(4).standard_normal((1, H, H, 4)).astype(
        np.float32)
    _, aux = jp.unet.apply(jp.unet_params, jnp.asarray(x), jnp.int32(500),
                           jnp.asarray(emb[1:2]),
                           capture=J_unet.CaptureSpec(cross_full=True))
    probs = {n: np.array(p) for n, p in aux["cross_probs_full"].items()}
    mix = np.ones(77, np.float32)
    eps_j, _ = jp.unet.apply(
        jp.unet_params, jnp.asarray(x), jnp.int32(500), jnp.asarray(emb[2:3]),
        controls=J_unet.UNetControls(
            inject_cross={n: jnp.asarray(p) for n, p in probs.items()},
            cross_mapper=jnp.asarray(mapper), cross_mix=jnp.asarray(mix)))
    with torch.no_grad():
        eps_t, _ = tp.unet(
            torch.from_numpy(x), 500, torch.from_numpy(emb[2:3]),
            controls=T_unet.UNetControls(
                inject_cross={n: torch.from_numpy(p)
                              for n, p in probs.items()},
                cross_mapper=torch.from_numpy(mapper),
                cross_mix=torch.from_numpy(mix)))
    _close(eps_t, eps_j)


@pytest.mark.parametrize("px_h,px_w,extra", [
    (PX, PX, []), (48, 48, []), (PX, 32, []), (32, PX, []),
    (PX, PX, ["--inject_selfattn", "0.3", "--inject_background", "0.3",
              "--no_ref_precompute"]),
    (PX, PX, ["--inject_selfattn", "0.3", "--inject_background", "0.3"]),
], ids=["16x16", "48x48", "16x32", "32x16", "16x16-inject",
        "16x16-inject-refpre"])
def test_cli_flow_runs_on_cpu(pipes, tmp_path, px_h, px_w, extra):
    """The CLI's run_sample at the tiny config: images of the right shape,
    written as PNG; at the square size of the parity tests, at one whose
    latent (24 rows) has its segmentation level elsewhere, at two
    non-square sizes (the tiny VAE halves the size, and the UNet needs
    latent sides in multiples of 8), and with injection through the
    in-batch and the refer-precompute flow."""
    _, tp = pipes
    plain_img, rich_img, seconds = _run_cli(tp, tmp_path, px_h, px_w, extra)
    assert plain_img.shape == rich_img.shape == (1, px_h, px_w, 3)
    assert plain_img.dtype == np.uint8
    assert rich_img.std() > 0
    # the figures' seconds are kept apart from the token-map stage's
    assert set(seconds) == {"plain_pass", "token_maps", "figures",
                            "rich_pass"}
    assert seconds["figures"] > 0 and seconds["token_maps"] > 0
    # the images, and the figures that every token-map call writes
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "average_seed1_attn0.png", "average_seed1_attn1.png",
        "seed1_plain.png", "seed1_rich.png", "segmentation_k3_seed1.png"]
    refpre = "--inject_selfattn" in extra and "--no_ref_precompute" not in extra
    assert (tp.ref_cache is not None) == refpre


def _run_cli(tp, run_dir, px_h, px_w, extra):
    """check_args, then run_sample at px_h x px_w with the CLI's flags
    ``extra`` and the scheduler they name."""
    text = json.dumps(DOC)
    args = t_cli.make_parser().parse_args(
        ["--run_dir", str(run_dir), "--sample_steps", "4", "--device", "cpu",
         "--rich_text_json", text, "--num_segments", "3", *extra])
    t_cli.check_args(args)
    param = {"text_input": json.loads(text), "height": px_h, "width": px_w,
             "guidance_weight": 8.5, "steps": 4, "noise_index": 1,
             "negative_prompt": ""}
    default = tp.scheduler
    tp.scheduler = t_cli.make_scheduler(args.scheduler) or default
    try:
        return t_cli.run_sample(tp, args, param)
    finally:
        tp.scheduler = default


@pytest.mark.parametrize("argv", [
    ["--inject_selfattn", "0.3"], ["--encoder_reuse", "2"],
    ["--bf16_guidance"], ["--guidance_downsample", "2"],
    ["--inject_background", "0.3"], ["--bf16_vae"],
    ["--scheduler", "ddim"], ["--scheduler", "dpm"],
    ["--encoder_reuse", "2", "--encoder_schedule", "uniform",
     "--inject_selfattn", "0.3", "--no_ref_precompute"],
])
def test_cli_accepts_ported_flags(pipes, tmp_path, argv):
    """Flags the port's CLI turned away before this slice: each passes
    check_args and runs the CLI flow at 16x16 (``--bf16_vae`` is accepted
    and not read, as in the JAX CLI's SD branch)."""
    _, tp = pipes
    plain_img, rich_img, _ = _run_cli(tp, tmp_path, PX, PX, argv)
    assert plain_img.shape == rich_img.shape == (1, PX, PX, 3)
    assert np.isfinite(rich_img.astype(np.float64)).all()
    assert rich_img.std() > 0


@pytest.mark.parametrize("argv", [
    ["--model", "SDXL", "--mesh", "auto"], ["--scheduler", "euler"],
    ["--mesh", "auto"], ["--save_attn", "--mesh", "2,4"],
    ["--model", "SD", "--scheduler", "euler", "--bf16_vae"],
])
def test_cli_rejects_unported_flags(argv):
    """What the CLI still refuses: ``--mesh`` with any model, and Euler
    under SD, whose rich pass fails in the JAX package."""
    with pytest.raises(SystemExit,
                       match="region_sd.py:772" if "euler" in argv else
                       "--mesh"):
        t_cli.check_args(t_cli.make_parser().parse_args(argv))


@pytest.mark.parametrize("argv", [
    ["--model", "SDXL"], ["--save_attn"], ["--model", "AnimeXL"],
    ["--model", "SDXL", "--scheduler", "euler", "--bf16_vae"],
])
def test_cli_takes_sdxl_and_save_attn(argv):
    t_cli.check_args(t_cli.make_parser().parse_args(argv))
