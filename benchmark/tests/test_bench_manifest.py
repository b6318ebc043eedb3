"""``BENCHMARK.json`` against the contract's shape, and every configuration,
traffic mix, cell and per-layer metric found by its name. A configuration
of the ``unet`` family (SD-1.5, SDXL) runs at its published sizes and its
cells have the UNet comparison's limits; one of another family may list
cuts under ``reduced`` and its cells have that family's ``LIMITS``."""

from __future__ import annotations

import json
import re

import pytest
from bench_tiny import BENCH, ROOT

from benchmark import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def unet_family(cfg: dict) -> bool:
    return cfg.get("family", "unet") == "unet"


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entries_have_just_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        if unet_family(json.loads((ROOT / c["file"]).read_text())):
            assert c["reduced"] == []
        else:
            assert len(c["reduced"]) <= 16
            assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c["cfg"]["name"] == c["cell"]["config"]
    assert set(c["traffic"]) >= {"rich_text", "flags", "negative_prompt"}
    limits = set(c["limits"]["limits"])
    family_limits = set(harness.family(c["cfg"]).LIMITS)
    if unet_family(c["cfg"]):
        assert limits >= {"text_rel", "plain_step_rel", "maps_rel",
                          "rich_step_rel", "decode_rel", "inputs_max_abs"}
        assert ("guided_rel" in limits) == (c["cell"]["traffic"] == "color")
        assert limits <= family_limits
    else:
        assert limits == family_limits
    for m in c["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    e2e = {m["name"] for m in c["e2e"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]


def test_configs_run_at_the_published_widths():
    sd = json.loads((BENCH / "configs" / "sd15-512.json").read_text())
    xl = json.loads((BENCH / "configs" / "sdxl-1024.json").read_text())
    assert sd["unet"]["block_out_channels"] == [320, 640, 1280, 1280]
    assert xl["unet"]["transformer_layers_per_block"] == [1, 2, 10]
    assert xl["text_encoder_2"]["hidden_size"] == 1280
    assert sd["precision"]["unet"] == xl["precision"]["unet"] == "bfloat16"
    assert {sd["pipeline"]["sampler"], xl["pipeline"]["sampler"]} == {
        "pndm", "euler"}
    unet, vae, texts = harness.port_configs(sd)
    assert unet.heads_per_level == (8, 8, 8, 8)
    assert texts["text_encoder"].projection_dim is None
    unet, vae, texts = harness.port_configs(xl)
    assert unet.heads_per_level == (5, 10, 20)
    assert texts["text_encoder_2"].projection_dim == 1280


def test_the_cli_flags_of_each_traffic_parse():
    for cell in CELLS:
        c = harness.load_cell(cell)
        args = harness.cli_args(c["cfg"], c["traffic"])
        assert args.sample_steps == 50
        assert args.inject_selfattn == c["traffic"]["flags"]["inject_selfattn"]
