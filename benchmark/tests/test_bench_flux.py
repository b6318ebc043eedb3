"""The ``flux`` family: the work of a FLUX.1-dev sample at the published
widths (read on the meta device), a traced tiny run on the CPU through the
family's spans and recorder with every number at its limit and every
per-layer metric that has something to read, and the weights' rule for RMS
norms and T5's queries."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from bench_tiny import run_tiny
from flux_tiny import tiny_cell

from benchmark import harness
from benchmark import trace as T

CELL = "flux1-dev-1024-footnote"


def test_the_work_of_a_sample():
    c = harness.load_cell(CELL)
    fam = harness.family(c["cfg"])
    fl, bound, calls = fam.work(c["cfg"], c["traffic"])
    # 50 steps at 1 row and at R + 1 = 2, 7.438e13 a row-step; three
    # prompts through T5 and CLIP-L; two decodes
    assert fl == pytest.approx(1.119322e16, rel=1e-6)
    assert calls == [(2090, 1, 24, 4608, 128, False),
                     (760, 1, 24, 4608, 128, True),
                     (2850, 2, 24, 4608, 128, False)]
    # every call bound by its tensor operations at these shapes
    ops = sum(n * 4.0 * B * H * S * S * d for n, B, H, S, d, _ in calls)
    assert bound == pytest.approx(ops / 989e12, rel=1e-9)


def test_a_traced_tiny_run(monkeypatch):
    cell = tiny_cell()
    spec = harness.load_cell(CELL)
    cell["per_layer"] = [m for m in spec["per_layer"]
                         if m["name"] != "guided_step_ms"]
    profiled = T.profiled
    monkeypatch.setattr(T, "profiled",
                        lambda fn, cpu=True: profiled(fn, cpu=True))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rc, res = run_tiny(cell, trace=1)
    assert rc == 0 and res["correct"], res["checks"]
    assert set(res["checks"]) == set(harness.family(cell["cfg"]).LIMITS)
    for k, v in res["checks"].items():
        assert v["value"] <= 1e-4, (k, v)
    # no device on the CPU: nothing inside attn1_core to time
    assert set(res["metrics"]) == {"plain_pass_s", "rich_pass_s",
                                   "token_maps_s", "mfu", "idle_share"}


def test_clip_pooled_rows_have_a_number_of_their_own():
    fam = harness.family(harness.load_cell(CELL)["cfg"])
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(2, 512, 64, generator=g)
    pooled = torch.randn(2, 8, generator=g)
    one = torch.ones(1, 2, 2, 1)
    common = dict(maps=[one], images=[one], masks=np.zeros(3))
    ref = dict(common, text=[rows[:1], rows[1:], pooled[:1], pooled[1:]],
               plain_next={0: one}, rich_next={0: one}, guided={})
    sub = dict(common, text=[rows[:1], rows[1:], 1.01 * pooled[:1],
                             1.01 * pooled[1:]],
               plain_next=[one], rich_next=[one])
    rec = {"plain": {"lat": [0 * one] * 2}, "rich": {"lat": [0 * one] * 2}}
    nums = fam.compare(sub, ref, rec)
    assert set(nums) == set(fam.LIMITS)
    assert nums["pooled_rel"] == pytest.approx(0.01)
    # the same 1% among T5's rows: 16 pooled values against 65,536
    assert nums["text_rel"] < 2e-4


def test_rms_norms_are_ones_and_t5_queries_scaled():
    cfg = tiny_cell()["cfg"]
    fam = harness.family(cfg)
    state = fam.draw_state(cfg, 11, torch.device("cpu"))
    t = state["transformer"]
    assert torch.equal(t["transformer_blocks.0.attn.norm_q.weight"],
                       torch.ones(32))
    assert torch.equal(state["text_encoder_2"][
        "encoder.final_layer_norm.weight"], torch.ones(32))
    e = state["text_encoder_2"]
    q = e["encoder.block.0.layer.0.SelfAttention.q.weight"]
    k = e["encoder.block.0.layer.0.SelfAttention.k.weight"]
    # k at N(0, 1/d_model), q at N(0, 1/(d_model d_kv)), d_kv 8
    assert 1.5 < float(k.std() / q.std()) < 4.5
