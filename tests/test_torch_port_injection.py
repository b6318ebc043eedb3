"""Self-attention and resnet-feature injection in the port against the JAX
package: the UNet's controls and captures on bridged parameters, and the
rich pass's in-batch reference flow.

Both sides run in float32 on the CPU on the same numpy inputs. Tolerance:
1e-4 relative to each output's scale (float32 through a few dozen layers, or
13 UNet calls with the PNDM multistep, with sums in another order).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.models import unet as J
from rich_text_to_image_tpu.models.init_utils import fast_init
from rich_text_to_image_tpu.pipelines import region_sd as JP
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.cli import sample as t_cli
from rich_text_to_image_tpu_torch.models import unet as T
from rich_text_to_image_tpu_torch.pipelines import region_sd as TP
from torch_port_pipes import tiny_pipes
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

RES = T.INJECT_RESNET_NAME


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


@pytest.fixture(scope="module")
def unets():
    """(JAX UNet, its params, the port's UNet on the same parameters, a
    4-row input, contexts, and the reference row's captured (Q,K) and resnet
    feature from the JAX side as numpy)."""
    ju = J.UNet2DCondition(C.TINY_UNET, dtype=jnp.float32)
    params = fast_init(ju, 0, jnp.zeros((1, 8, 8, 4)), jnp.int32(0),
                       jnp.zeros((1, 77, 32)))
    tu = weights.load_flax(T.UNet2DCondition(C.TINY_UNET),
                           jax.tree.map(np.asarray, params), "unet")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((4, 77, 32)).astype(np.float32)
    _, aux = ju.apply(params, jnp.asarray(x[:1]), jnp.int32(700),
                      jnp.asarray(ctx[:1]),
                      capture=J.CaptureSpec(qk=True, resnet=frozenset({RES})))
    qk = {n: (np.array(q), np.array(k))  # writable copies for torch
          for n, (q, k) in aux["self_qk"].items()}
    feat = np.array(aux["resnet_hidden"][RES])
    return ju, params, tu, x, ctx, qk, feat


def _run_both(unets, j_controls, t_controls, rows=slice(0, 4)):
    ju, params, tu, x, ctx, _, _ = unets
    eps_j, _ = ju.apply(params, jnp.asarray(x[rows]), jnp.int32(700),
                        jnp.asarray(ctx[rows]), controls=j_controls)
    with torch.no_grad():
        eps_t, _ = tu(torch.from_numpy(x[rows]), 700,
                      torch.from_numpy(ctx[rows]), controls=t_controls)
    return np.asarray(eps_j), eps_t.numpy()


def test_qk_and_resnet_captures_match_jax(unets):
    _, _, tu, x, ctx, qk, feat = unets
    with torch.no_grad():
        _, aux = tu(torch.from_numpy(x[:1]), 700, torch.from_numpy(ctx[:1]),
                    capture=T.CaptureSpec(qk=True, resnet=frozenset({RES})))
    assert set(aux["self_qk"]) == set(qk) and len(qk) == 16
    for n, (q, k) in qk.items():
        assert aux["self_qk"][n][0].shape == q.shape  # [B, H, S, hd]
        _close(aux["self_qk"][n][0], q)
        _close(aux["self_qk"][n][1], k)
    assert set(aux["resnet_hidden"]) == {RES}
    assert aux["resnet_hidden"][RES].shape == feat.shape  # [B, h, w, C]
    _close(aux["resnet_hidden"][RES], feat)


@pytest.mark.parametrize("gate", [None, True, False, "tensor"])
def test_in_batch_injection_matches_jax(unets, gate):
    """Rows 2:4 take row 1's (Q, K) at every attn1 and its resnet feature."""
    jg = None if gate is None else jnp.bool_(gate in (True, "tensor"))
    tg = torch.tensor(True) if gate == "tensor" else gate
    eps_j, eps_t = _run_both(
        unets,
        J.UNetControls(inject_gate=jg, inject_src=1, inject_dst=(2, 4)),
        T.UNetControls(inject_gate=tg, inject_src=1, inject_dst=(2, 4)))
    _close(eps_t, eps_j)
    plain_j, _ = _run_both(unets, None, None)
    moved = np.abs(eps_j[2:] - plain_j[2:]).max()
    assert (moved == 0) if gate is False else (moved > 1e-3)
    _close(eps_t[:2], plain_j[:2])  # the other rows are left alone


@pytest.mark.parametrize("layout", ["BHSD", "BSC"])
@pytest.mark.parametrize("mode", ["all_rows", "all_rows_gated", "row_range"])
def test_stored_qk_and_resnet_injection_matches_jax(unets, layout, mode):
    """A stored reference (Q, K), in both storage layouts, and a stored
    resnet feature: into every row (with and without a gate) or into a row
    range."""
    _, _, _, _, _, qk, feat = unets
    if layout == "BSC":  # pre-split storage: [B, S, H*hd]
        qk = {n: tuple(t.transpose(0, 2, 1, 3).reshape(
            t.shape[0], t.shape[2], -1) for t in pair)
            for n, pair in qk.items()}
    kw = {"all_rows": {}, "all_rows_gated": {"inject_gate": True},
          "row_range": {"inject_gate": True, "inject_dst": (1, 3)}}[mode]
    jkw = dict(kw)
    if "inject_gate" in jkw:
        jkw["inject_gate"] = jnp.bool_(True)
    eps_j, eps_t = _run_both(
        unets,
        J.UNetControls(
            inject_qk={n: tuple(map(jnp.asarray, p)) for n, p in qk.items()},
            inject_resnet={RES: jnp.asarray(feat)}, **jkw),
        T.UNetControls(
            inject_qk={n: tuple(map(torch.from_numpy, p))
                       for n, p in qk.items()},
            inject_resnet={RES: torch.from_numpy(feat)}, **kw),
        rows=slice(1, 4))
    _close(eps_t, eps_j)
    plain_j, _ = _run_both(unets, None, None, rows=slice(1, 4))
    assert np.abs(eps_j - plain_j).max() > 1e-3


def test_resnet_injection_alone_matches_jax(unets):
    feat = unets[6]
    eps_j, eps_t = _run_both(
        unets, J.UNetControls(inject_resnet={RES: jnp.asarray(feat)}),
        T.UNetControls(inject_resnet={RES: torch.from_numpy(feat)}))
    _close(eps_t, eps_j)


@pytest.mark.parametrize("kw", [
    dict(inject_cross={}), dict(cross_mapper=torch.zeros(77)),
    dict(cross_mix=torch.zeros(77)),
])
def test_prompt_to_prompt_controls_still_raise(unets, kw):
    tu = unets[2]
    with pytest.raises(NotImplementedError):
        tu(torch.zeros((1, 8, 8, 4)), 1, torch.zeros((1, 77, 32)),
           controls=T.UNetControls(**kw))
    with pytest.raises(NotImplementedError):
        tu(torch.zeros((1, 8, 8, 4)), 1, torch.zeros((1, 77, 32)),
           capture=T.CaptureSpec(cross_full=True))


# ------------------------------------------------------------ the rich pass
H, PX, STEPS = 8, 16, 12


@pytest.fixture(scope="module")
def pipes():
    jp, tp = tiny_pipes(agg_start_step=10)
    rng = np.random.default_rng(5)
    soft = rng.random((3, 1, H, H)).astype(np.float32) + 0.1
    soft /= soft.sum(axis=0, keepdims=True)
    jp.masks = tp.masks = [m for m in soft]
    lat0 = rng.standard_normal((1, H, H, 4)).astype(np.float32)
    return jp, tp, lat0


@pytest.mark.parametrize("selfattn,background,font", [
    (0.3, 0.3, True), (0.3, 0.0, False), (0.0, 0.3, False)])
def test_rich_pass_with_injection_matches_jax(pipes, selfattn, background,
                                              font):
    """The in-batch reference flow (R+4 rows, both trajectories through one
    scheduler step, background injection) against the JAX produce_latents
    without a ref cache."""
    jp, tp, lat0 = pipes
    prompts = ["a tall tree", "a red rose", "a garden with a rose bush"]
    fmt = ({"word_pos": np.array([3, 4]), "font_size": np.array([2.5, 0.5])}
           if font else {})
    spec = dict(guidance_scale=8.5, inject_selfattn=selfattn,
                inject_background=background)
    j_lat = jp.produce_latents(
        jp.get_text_embeds(prompts, [""]), height=PX, width=PX,
        num_inference_steps=STEPS, latents=jnp.asarray(lat0),
        spec=JP.RichControlSpec(**spec), text_format_dict=fmt)
    t_lat = tp.produce_latents(
        tp.get_text_embeds(prompts, [""]), height=PX, width=PX,
        num_inference_steps=STEPS, latents=lat0,
        spec=TP.RichControlSpec(**spec), text_format_dict=fmt)
    _close(t_lat, j_lat)
    off = tp.produce_latents(
        tp.get_text_embeds(prompts, [""]), height=PX, width=PX,
        num_inference_steps=STEPS, latents=lat0,
        spec=TP.RichControlSpec(guidance_scale=8.5), text_format_dict=fmt)
    assert float((t_lat - off).abs().max()) > 1e-3  # injection did something


def test_rich_batch_is_r_plus_4(pipes):
    _, tp, lat0 = pipes
    seen = []
    hook = tp.unet.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].shape[0]))
    try:
        tp.produce_latents(
            tp.get_text_embeds(["a", "b", "c"], [""]), height=PX, width=PX,
            num_inference_steps=2, latents=lat0,
            spec=TP.RichControlSpec(inject_selfattn=0.3))
    finally:
        hook.remove()
    assert seen == [6, 6, 6]  # R = 2 spans: [uncond, base, ref_u, ref_c, 2]


def test_cli_injection_needs_no_ref_precompute(pipes, tmp_path):
    """With the default flag set the injection flags run the refer-precompute
    flow, as in the JAX CLI: the plain pass keeps a refer cache and the rich
    pass runs R+2 rows a step; ``--no_ref_precompute`` keeps the in-batch
    flow of R+4 rows."""
    _, tp, _ = pipes
    text = json.dumps({"ops": [
        {"insert": "a "}, {"attributes": {"link": "a tall tree"},
                           "insert": "garden"},
        {"insert": " with a "}, {"attributes": {"color": "#ff0000"},
                                 "insert": "rose"}]})
    param = {"text_input": json.loads(text), "height": PX, "width": PX,
             "guidance_weight": 8.5, "steps": 3, "noise_index": 1,
             "negative_prompt": ""}
    for flags, rows in (([], 4), (["--no_ref_precompute"], 6)):
        args = t_cli.make_parser().parse_args(
            ["--run_dir", str(tmp_path), "--device", "cpu",
             "--num_segments", "3", "--inject_selfattn", "0.3",
             "--inject_background", "0.3", *flags])
        t_cli.check_args(args)
        seen = []
        hook = tp.unet.register_forward_pre_hook(
            lambda mod, inp: seen.append(inp[0].shape[0]))
        try:
            t_cli.run_sample(tp, args, param, save=False)
        finally:
            hook.remove()
        # R = 2 spans (the footnote and the colour); PNDM: 4 calls a pass
        assert seen == [2] * 4 + [rows] * 4, (flags, seen)
        assert (tp.ref_cache is not None) == (not flags)
