"""The port's throughput program (``rich_text_to_image_tpu_torch/bench.py``)
against the repository's root ``bench.py``, the JAX package's.

The root ``bench.py`` is loaded from its file: its top level imports only
the standard library. On the CPU:

  * ``_argv`` gives the JAX program's flags for both models and both
    configurations, and the port's parser and ``check_args`` take each;
  * ``_e2e_flops`` of the port against the JAX program's on the tiny pipes
    with the same masks, at encoder-reuse strides 1 and 2: within
    [1.0, 1.2], the band ``test_torch_port_flops.py`` holds one forward to
    (the port counts products only; 1.109 and 1.113 here);
  * ``_run`` on a tiny port pipeline at 64^2 px, 2 steps: a positive rate,
    no MFU on the CPU, and the rich image of its timed run equal to the
    CLI's ``run_sample`` on the same pipeline and seed; on a tiny SDXL
    pipeline the turbo configuration's bfloat16 decode and the refer cache;
  * ``_emit`` prints the JAX record's keys and values plus ``device``;
  * ``main`` prints a 0.0 record for a model that fails and marks it failed.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from rich_text_to_image_tpu_torch import bench as TB
from rich_text_to_image_tpu_torch.cli import sample as t_cli
from rich_text_to_image_tpu_torch.models import config as TC
from rich_text_to_image_tpu_torch.pipelines.region_sdxl import (
    RegionDiffusionXL)
from torch_port_pipes import tiny_pipes
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = [("sd15", False), ("sd15", True), ("sdxl", False), ("sdxl", True)]
IDS = ["sd15-turbo", "sd15-exact", "sdxl-turbo", "sdxl-exact"]


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JB = _jax_bench()


@pytest.fixture(scope="module")
def pipes():
    return tiny_pipes()


@pytest.mark.parametrize("kind,exact", KINDS, ids=IDS)
def test_argv_matches_jax_and_the_cli_takes_it(kind, exact):
    argv, hw = TB._argv(kind, exact)
    assert (argv, hw) == JB._argv(kind, exact)
    args = t_cli.make_parser().parse_args(argv)
    t_cli.check_args(args)
    assert args.device == "cuda" and args.sample_steps == 50
    assert args.encoder_reuse == (1 if exact else 2)
    assert args.bf16_vae == (kind == "sdxl" and not exact)


@pytest.mark.parametrize("stride", [1, 2])
def test_e2e_flops_against_jax(pipes, stride):
    jp, tp = pipes
    # two span regions and the background, on both pipelines
    masks = [np.full((1, 8, 8), 1 / 3, np.float32)] * 3
    jp.masks, tp.masks = list(masks), list(masks)
    port = TB._e2e_flops(tp, "sd15", 50, stride)
    ratio = port / JB._e2e_flops(jp, "sd15", 50, stride)
    assert 1.0 <= ratio <= 1.2, ratio
    if stride > 1:  # the skipped down path is counted out
        assert port < TB._e2e_flops(tp, "sd15", 50, 1)


def _cli_images(model, kind, exact, steps, size):
    """The CLI's ``run_sample`` of the bench's flags at ``steps`` and
    ``size``, the seed and rich text its defaults."""
    argv, _ = TB._argv(kind, exact)
    args = t_cli.make_parser().parse_args(argv)
    param = {"text_input": json.loads(args.rich_text_json), "height": size,
             "width": size, "guidance_weight": args.guidance_weight,
             "steps": steps, "noise_index": args.seed,
             "negative_prompt": ""}
    plain, rich, _ = t_cli.run_sample(model, args, param, save=False)
    return plain, rich


@pytest.mark.parametrize("exact", [False, True], ids=["turbo", "exact"])
def test_run_times_the_cli_flow(pipes, exact):
    _, tp = pipes
    detail = {}
    rate, mfu = TB._run("sd15", exact, model=tp, repeats=1, steps=2, size=64,
                        detail=detail)
    assert rate > 0 and mfu is None and detail["flops"] is None
    assert len(detail["times"]) == 1 and rate == 60.0 / detail["times"][0]
    assert set(detail["seconds"]) == {"plain_pass", "token_maps", "figures",
                                      "rich_pass"}
    # nothing launches a kernel on the CPU, and no injection: no cache
    assert detail["launches"] == {} and detail["peak_bytes"] is None
    assert detail["cache_slots"] == detail["cache_bytes"] == 0
    # the default rich text's one footnote span: R = 1
    assert len(tp.masks) == 2
    plain, rich = _cli_images(tp, "sd15", exact, 2, 64)
    assert detail["images"][0].shape == (1, 64, 64, 3)
    np.testing.assert_array_equal(detail["images"][0], plain)
    np.testing.assert_array_equal(detail["images"][1], rich)


def test_run_sets_sdxl_as_the_flags_build_it():
    xl = RegionDiffusionXL.random_init(
        seed=0, unet_cfg=TC.TINY_XL_UNET, vae_cfg=TC.TINY_VAE,
        text_cfg=TC.TINY_TEXT, text2_cfg=TC.CLIPTextConfig(
            vocab_size=1000, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=2, hidden_act="gelu",
            projection_dim=32), dtype=torch.float32, device="cpu")
    for exact, dtype in ((False, torch.bfloat16), (True, torch.float32)):
        detail = {}
        rate, mfu = TB._run("sdxl", exact, model=xl, repeats=1, steps=2,
                            size=32, detail=detail)
        assert rate > 0 and mfu is None
        assert xl.vae_dtype == dtype
        # injection 0.2 of 2 Euler steps: the first step's slot
        assert detail["cache_slots"] == 1 and detail["cache_bytes"] > 0
        plain, rich = _cli_images(xl, "sdxl", exact, 2, 32)
        np.testing.assert_array_equal(detail["images"][1], rich)


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = fn(*args)
    return rec, json.loads(buf.getvalue())


@pytest.mark.parametrize("turbo,exact", [
    ((12.3456, 0.05678), (10.1111, 0.04444)),
    ((12.3456, None), None), ((0.0, None), None)],
    ids=["both", "turbo-only", "failed"])
def test_emit_prints_the_jax_record_and_the_device(turbo, exact,
                                                   monkeypatch):
    monkeypatch.setattr(TB, "_device",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    for kind, metric in TB.METRICS:
        rec, line = _printed(TB._emit, metric, kind, turbo, exact)
        _, want = _printed(JB._emit, metric, kind, turbo, exact)
        assert rec == line
        assert line == dict(want, device="NVIDIA H100 80GB HBM3, 700.00 W")


def test_device_is_none_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(TB.shutil, "which", lambda name: None)
    assert TB._device() is None


def test_main_records_a_failed_model(monkeypatch):
    def run(kind, exact):
        if kind == "sdxl":
            raise RuntimeError("out of memory")
        return (30.0, 0.1) if exact else (33.0, 0.09)

    monkeypatch.setattr(TB, "_run", run)
    monkeypatch.setattr(TB, "_device", lambda: None)
    monkeypatch.setattr(TB, "FAILED", [])
    with contextlib.redirect_stdout(io.StringIO()):
        records = TB.main()
    assert TB.FAILED == ["sdxl"]
    assert [r["metric"] for r in records] == [m for _, m in TB.METRICS]
    assert records[0]["value"] == 33.0 and records[0]["value_exact"] == 30.0
    assert records[1]["value"] == 0.0 and "value_exact" not in records[1]
