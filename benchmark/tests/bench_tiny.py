"""Tiny cells for the benchmark's CPU tests: the committed configurations
and traffic with the widths cut to the sizes the program's own CPU tests
use (its ``TINY_*`` configs), float32 throughout, 12 steps (past the
capture's start at step 10) and 32x32 pixels."""

from __future__ import annotations

import io
import json
import sys
import time
import types
from contextlib import redirect_stdout
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

BENCH = ROOT / "benchmark"
LIMITS = {"text_rel": 1e-4, "plain_step_rel": 1e-4, "maps_rel": 1e-4,
          "rich_step_rel": 1e-4, "decode_rel": 1e-4, "inputs_max_abs": 0.0}


def tiny_cfg(xl: bool) -> dict:
    name = "sdxl-1024" if xl else "sd15-512"
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    small_text = dict(vocab_size=1000, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=2)
    if xl:
        cfg["unet"].update(
            sample_size=16, block_out_channels=[32, 64, 64],
            attention_head_dim=[2, 2, 2], transformer_layers_per_block=[1, 1, 2],
            cross_attention_dim=64, norm_num_groups=8, addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=8 * 6 + 32)
        cfg["text_encoder_2"].update(small_text, projection_dim=32)
    else:
        cfg["unet"].update(
            sample_size=8, block_out_channels=[32, 64, 64, 64],
            attention_head_dim=[2, 2, 2, 2], cross_attention_dim=32,
            norm_num_groups=8)
    cfg["vae"].update(block_out_channels=[16, 32], layers_per_block=1,
                      norm_num_groups=8)
    cfg["text_encoder"].update(small_text)
    cfg["pipeline"].update(height=32, width=32, steps=12)
    cfg["precision"]["unet"] = "float32"
    return cfg


def tiny_cell(traffic: str, xl: bool = False) -> dict:
    limits = dict(LIMITS)
    if traffic == "color":
        limits["guided_rel"] = 1e-4
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return dict(
        name=f"tiny-{traffic}", cell={"chips": 1}, cfg=tiny_cfg(xl),
        traffic=json.loads((BENCH / "traffic" / f"{traffic}.json").read_text()),
        limits={"guided_steps": 3, "steps_checked": 6, "limits": limits},
        e2e=spec["end_to_end"], per_layer=[])


def run_tiny(cell: dict, seed: int = 2 ** 31 + 12345, seconds: float = 0.0,
             trace: int = 0):
    """``run_cell`` on the CPU (the look for a card skipped); returns (rc,
    the result line as a dict, or None)."""
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.run_cell(cell, args, time.perf_counter(),
                              torch.device("cpu"))
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None)
