"""The tracer's spans and counters on the sample path, with the tiny SD and
SDXL pipelines of the port on the CPU.

``cli/sample.run_sample`` with the tracer on gives one ``unet`` span and
one ``unet_calls`` count a sampler evaluation (PNDM's extra one included),
2 rows in the plain pass and R+2 in the rich pass; two ``decode`` spans;
one ``guided_step`` (with its forward and backward) a colour-guided step;
one ``attn_self`` span a self-attention layer and forward, on the path
that ran it; the UNet's blocks inside each ``unet`` span; every span
inside the root span ``sample``. The stage seconds keep their keys, and
the images are bit for bit those of the tracer off.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rich_text_to_image_tpu_torch.cli import sample as cli
from rich_text_to_image_tpu_torch.models import config as C
from rich_text_to_image_tpu_torch.pipelines.region_sd import RegionDiffusion
from rich_text_to_image_tpu_torch.pipelines.region_sdxl import (
    RegionDiffusionXL)
from rich_text_to_image_tpu_torch.utils import tracing
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

DOC = {"ops": [
    {"insert": "a "},
    {"attributes": {"link": "a cat with a hat"}, "insert": "cat"},
    {"insert": " and a "},
    {"attributes": {"color": "#ff0000"}, "insert": "rose"},
    {"insert": " in a garden"}]}
TEXT2 = dataclasses.replace(C.TINY_TEXT, hidden_act="gelu", projection_dim=32)
STEPS = 4
PATHS = {"flash_attention", "flash_attention_avg_probs",
         "attention_with_probs", "cross_attention"}


@pytest.fixture(scope="module")
def pipes():
    sd = RegionDiffusion.random_init(
        unet_cfg=C.TINY_UNET, vae_cfg=C.TINY_VAE, text_cfg=C.TINY_TEXT,
        device="cpu", dtype=torch.float32, agg_start_step=1)
    xl = RegionDiffusionXL.random_init(
        unet_cfg=C.TINY_XL_UNET, vae_cfg=C.TINY_VAE, text_cfg=C.TINY_TEXT,
        text2_cfg=TEXT2, device="cpu", dtype=torch.float32, agg_start_step=1)
    return {"SD": (sd, 16), "SDXL": (xl, 32)}


def _run(pipe, px, model, extra):
    args = cli.make_parser().parse_args(
        ["--model", model, "--device", "cpu", "--sample_steps", str(STEPS),
         "--num_segments", "3", "--rich_text_json", json.dumps(DOC),
         *extra])
    cli.check_args(args)
    param = {"text_input": DOC, "height": px, "width": px,
             "guidance_weight": 7.5, "steps": STEPS, "noise_index": 1,
             "negative_prompt": ""}
    return cli.run_sample(pipe, args, param, save=False)


@pytest.mark.parametrize("model,extra", [
    ("SD", []),
    ("SD", ["--inject_selfattn", "0.3", "--inject_background", "0.3"]),
    ("SDXL", []),
], ids=["sd", "sd-refpre", "sdxl"])
def test_run_sample_spans_and_counters(pipes, model, extra):
    pipe, px = pipes[model]
    tracing.disable()
    tracing.report()
    plain_off, rich_off, secs_off = _run(pipe, px, model, extra)
    assert tracing.report() == {"spans": [], "counters": {}}
    with tracing.collect():
        plain_on, rich_on, secs_on = _run(pipe, px, model, extra)
    rep = tracing.report()
    assert np.array_equal(plain_on, plain_off)
    assert np.array_equal(rich_on, rich_off)
    assert list(secs_on) == list(secs_off) == [
        "plain_pass", "figures", "token_maps", "rich_pass"]

    spans = rep["spans"]
    by_id = {s["id"]: s for s in spans}
    named = {}
    for s in spans:
        named.setdefault(s["name"], []).append(s)
    (root,) = named["sample"]
    for s in spans:
        assert s["sample"] == root["id"]
        assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] <= (
            root["end_ns"])

    def under(s, name):
        while s["parent"] is not None:
            s = by_id[s["parent"]]
            if s["name"] == name:
                return True
        return False

    # one UNet call a sampler evaluation, each pass: 2 rows, then R+2
    plan = pipe.scheduler.plan(STEPS)
    S = plan.num_steps
    R = len(pipe.masks) - 1
    assert R == 2
    flow = "refpre" if extra else "plain"
    unets = named["unet"]
    assert len(unets) == 2 * S
    assert [u["attrs"] for u in unets] == (
        [{"rows": 2, "key": True, "pass": "plain", "flow": flow}] * S
        + [{"rows": R + 2, "key": True, "pass": "rich", "flow": flow}] * S)
    assert rep["counters"]["unet_calls"] == {"rows=2": S,
                                             f"rows={R + 2}": S}
    for u in unets:
        loop = "plain_loop" if u["attrs"]["pass"] == "plain" else "rich_loop"
        assert under(u, loop)
    assert [len(named[n]) for n in ("plain_loop", "rich_loop",
                                    "capture_sums", "text_encode",
                                    "plain_pass", "token_maps",
                                    "rich_pass")] == [1, 1, 1, 2, 1, 1, 1]

    # the UNet's top-level blocks, inside every call
    L = len(pipe.unet_cfg.block_out_channels)
    blocks = ([f"unet.down.{i}" for i in range(L)] + ["unet.mid"]
              + [f"unet.up.{i}" for i in range(L)])
    for b in blocks:
        assert len(named[b]) == 2 * S and all(under(s, "unet")
                                              for s in named[b])

    # self-attention: one span a layer and forward, on a named path
    n_attn1 = sum(getattr(m, "layer_name", "").endswith(".attn1")
                  for m in pipe.unet.modules())
    assert len(named["attn_self"]) == n_attn1 * 2 * S
    assert {s["attrs"]["path"] for s in named["attn_self"]} <= PATHS
    assert all(under(s, "unet") for s in named["attn_self"])

    # two decodes, and a guided step for each gated step of the colour span
    assert len(named["decode"]) == 2
    gated = int((plan.timesteps.astype(np.int64) < 999).sum())
    assert gated > 0
    assert len(named["guided_step"]) == gated
    assert rep["counters"]["guided_steps"] == {"": gated}
    for part in ("guided_forward", "guided_backward"):
        assert [by_id[s["parent"]]["name"] for s in named[part]] == [
            "guided_step"] * gated
    assert all(under(s, "rich_loop") for s in named["guided_step"])
