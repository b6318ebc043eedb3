"""The benchmark's counts against hand-worked shapes: the self-attention
calls of one sample and their roofline bound, the FLOPs of the reference's
modules (the same count as the program's own counter at the tiny sizes),
and the per-layer readers on made-up readings."""

from __future__ import annotations

import importlib.util
import json

import pytest
import torch
from bench_tiny import BENCH, tiny_cfg

from benchmark import flops as F
from benchmark.reference.check import sample_inputs


def _cell(cfg_name, traffic):
    cfg = json.loads((BENCH / "configs" / f"{cfg_name}.json").read_text())
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    return cfg, tr, sample_inputs(tr)


def test_sd_attention_calls_of_one_sample():
    cfg, tr, inp = _cell("sd15-512", "footnote")
    calls = {(B, H, S, d, cap): n for n, B, H, S, d, cap
             in F.attn_calls(cfg, tr, inp)}
    # PNDM's 51 steps; 5 attn1 layers at each of 64^2, 32^2, 16^2, 1 at 8^2
    assert calls[(2, 8, 4096, 40, False)] == 255
    assert calls[(3, 8, 4096, 40, False)] == 255
    # the capture: the five 32^2 layers at the last plain step
    assert calls[(2, 8, 1024, 80, True)] == 5
    assert calls[(2, 8, 1024, 80, False)] == 250
    assert calls[(3, 8, 1024, 80, False)] == 255
    assert calls[(2, 8, 256, 160, False)] == 255
    assert calls[(2, 8, 64, 160, False)] == 51
    assert len(calls) == 9


def test_sdxl_attention_calls_of_one_sample():
    cfg, tr, inp = _cell("sdxl-1024", "footnote-inject")
    calls = {(B, H, S, d, cap): n for n, B, H, S, d, cap
             in F.attn_calls(cfg, tr, inp)}
    # Euler's 50 steps; 10 attn1 at 64^2 (10 heads), 60 at 32^2 (20 heads)
    assert calls[(2, 10, 4096, 64, False)] == 500
    assert calls[(3, 10, 4096, 64, False)] == 500
    # every 32^2 attn1 captured on steps 10..49
    assert calls[(2, 20, 1024, 64, True)] == 60 * 40
    assert calls[(2, 20, 1024, 64, False)] == 60 * 10
    assert calls[(3, 20, 1024, 64, False)] == 60 * 50


def test_roofline_bound_by_hand():
    cfg, tr, inp = _cell("sd15-512", "footnote")
    B, H, S, d = 2, 8, 4096, 40
    fl = 4 * B * H * S * S * d  # QK^T and PV
    by = 4 * B * H * S * d * 2  # q, k, v, o in bfloat16
    one = max(fl / 989e12, by / 3.35e12)
    assert one == pytest.approx(43.43e-6, rel=1e-3)  # bound by the products
    cap = max(4 * 2 * 8 * 1024 * 1024 * 80 / 989e12,
              (4 * 2 * 8 * 1024 * 80 * 2 + 1024 * 1024 * 4) / 3.35e12)
    total = F.attn_bound_seconds(cfg, tr, inp)
    assert total > 510 * one + 5 * cap
    assert total < 0.05


def test_unet_flops_match_the_programs_counter_at_tiny_sizes():
    from types import SimpleNamespace

    from benchmark.harness import port_configs
    from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
    from rich_text_to_image_tpu_torch.utils import flops as pf

    cfg = tiny_cfg(False)
    ucfg, _, _ = port_configs(cfg)
    model = SimpleNamespace(unet_cfg=ucfg, unet=UNet2DCondition(ucfg))
    # the program's counter runs at the UNet's sample size, 8 latent rows:
    # 16 pixels under the tiny VAE's one halving
    ours = F.unet_flops(dict(cfg, pipeline=dict(cfg["pipeline"], height=16,
                                                width=16)), 2)
    assert ours == pytest.approx(pf.unet_fwd_flops(model, 2, False), rel=1e-9)


def test_a_linear_and_an_attention_by_hand():
    from benchmark.reference.nets import Attention

    with torch.device("meta"):
        att = Attention(64, 4)
        x = torch.empty(2, 16, 64)
    from benchmark.reference.nets import NO_CONTROLS

    got = F.count(lambda: att(x, None, NO_CONTROLS, {}))
    proj = 4 * 2 * (2 * 16 * 64 * 64)  # q, k, v, out
    core = 2 * (2 * 2 * 4 * 16 * 16 * 16)  # two products, head dim 16
    assert got == proj + core


def test_sample_flops_add_up():
    cfg, tr, inp = _cell("sd15-512", "color")
    pl = F.plan(cfg, tr, inp)
    assert pl["steps"] == 51 and pl["rich_rows"] == 3
    assert len(pl["guided"]) == 51  # every PNDM timestep is below 999
    cfg_t = tiny_cfg(False)  # 12 PNDM steps: 13 in the plan, all guided
    total = F.sample_flops(cfg_t, tr, inp)
    # plain [neg, base] and rich [neg, colour span, base] encoded alone
    parts = (13 * (F.unet_flops(cfg_t, 2) + F.unet_flops(cfg_t, 3))
             + 5 * F.text_flops(cfg_t["text_encoder"])
             + 2 * F.decode_flops(cfg_t) + 13 * F.guided_flops(cfg_t, 1))
    assert total == pytest.approx(parts, rel=1e-12)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_readers_on_made_up_readings():
    samples = [{"seconds": {"plain_pass": 1.0, "token_maps": 0.1,
                            "rich_pass": 2.0}},
               {"seconds": {"plain_pass": 3.0, "token_maps": 0.3,
                            "rich_pass": 4.0}}]
    ctx = dict(samples=samples, window_span_s=8.0, flops_per_sample=989e12,
               peak_flops=989e12, attn_bound_s=0.5, attn_core_s=2.0,
               busy_s=3.0, window_s=4.0, guided_ms=[240.0, 250.0])
    assert _reader("plain_pass_s")(ctx) == 2.0
    assert _reader("rich_pass_s")(ctx) == 3.0
    assert _reader("token_maps_s")(ctx) == pytest.approx(0.2)
    assert _reader("mfu")(ctx) == pytest.approx(25.0)
    assert _reader("attn_roofline")(ctx) == pytest.approx(25.0)
    assert _reader("idle_share")(ctx) == pytest.approx(25.0)
    assert _reader("guided_step_ms")(ctx) == 245.0
    # nothing to read: nothing returned, never 0
    empty = dict(ctx, guided_ms=[], attn_core_s=0.0, window_s=0.0)
    for name in ("guided_step_ms", "attn_roofline", "idle_share"):
        assert _reader(name)(empty) is None
