"""A tiny cell of the ``flux`` family for the CPU tests: the committed
FLUX.1-dev configuration cut to 1 double and 2 single blocks of 2 heads of
32 (RoPE axes [8, 12, 12]), a 2-layer T5 of 128 tokens, a 2-level VAE,
float32 throughout, 12 steps at 64x64 pixels."""

from __future__ import annotations

import json

from bench_tiny import BENCH, ROOT

CONFIG = BENCH / "configs" / "flux1-dev-1024.json"
LIMITS = {"text_rel": 1e-4, "pooled_rel": 1e-4, "plain_step_rel": 1e-4,
          "maps_rel": 1e-4, "rich_step_rel": 1e-4, "decode_rel": 1e-4,
          "inputs_max_abs": 0.0}


def tiny_cfg() -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg["transformer"].update(
        num_layers=1, num_single_layers=2, attention_head_dim=32,
        num_attention_heads=2, joint_attention_dim=32,
        pooled_projection_dim=32, axes_dims_rope=[8, 12, 12])
    cfg["text_encoder"].update(vocab_size=1000, hidden_size=32,
                               intermediate_size=64, num_hidden_layers=2,
                               num_attention_heads=2)
    cfg["text_encoder_2"].update(vocab_size=600, d_model=32, d_kv=8,
                                 d_ff=64, num_layers=2, num_heads=4)
    cfg["vae"].update(block_out_channels=[16, 32], layers_per_block=1,
                      norm_num_groups=8)
    cfg["pipeline"].update(height=64, width=64, steps=12,
                           max_sequence_length=128)
    cfg["precision"].update(transformer="float32", text_encoder_2="float32")
    return cfg


def tiny_cell(traffic: str = "footnote") -> dict:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return dict(
        name="tiny-flux", cell={"chips": 1}, cfg=tiny_cfg(),
        traffic=json.loads((BENCH / "traffic" / f"{traffic}.json")
                           .read_text()),
        limits={"steps_checked": 6, "limits": dict(LIMITS)},
        e2e=spec["end_to_end"], per_layer=[])
