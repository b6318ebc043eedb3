"""The plain reference against the program at tiny sizes on the CPU, the
whole run after the look for a card, and the faults ``correct`` has to
catch: a sampler step that returns its state unchanged, half of a UNet
batch left out with the mean of the rest in its place, and an answer
altered where it is produced. The control (the reference one precision
lower: fp8 UNet products) fails at least one number. (One card: no
exchange between chips to leave out.)"""

from __future__ import annotations

import pytest
import torch
from bench_tiny import run_tiny, tiny_cell

from benchmark import control, harness
from benchmark.reference.check import compare, evaluate

CASES = [("footnote", False), ("color", False), ("footnote-inject", True)]


@pytest.mark.parametrize("traffic,xl", CASES,
                         ids=[f"{t}-{'sdxl' if x else 'sd'}" for t, x in CASES])
def test_reference_agrees_with_the_program(traffic, xl):
    rc, res = run_tiny(tiny_cell(traffic, xl))
    assert rc == 0 and res is not None
    assert res["correct"], res["checks"]
    checks = res["checks"]
    assert checks["inputs_max_abs"]["value"] == 0.0
    for k, v in checks.items():
        assert v["value"] <= 1e-5, (k, v)
    assert ("guided_rel" in checks) == (traffic == "color")
    assert res["attempted"] == 1
    assert set(res["metrics"]) == {"images_per_min", "peak_mem_gib",
                                   "setup_s"}
    assert list(res)[-1] == "checks"


def _pndm_unchanged(monkeypatch):
    from rich_text_to_image_tpu_torch.schedulers.pndm import PNDMScheduler

    orig = PNDMScheduler.step

    def step(self, plan, i, state, eps, sample):
        _, st = orig(self, plan, i, state, eps, sample)
        return sample.float(), st

    monkeypatch.setattr(PNDMScheduler, "step", step)


def _half_batch(monkeypatch):
    from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition

    orig = UNet2DCondition.forward

    def forward(self, *a, **kw):
        # the captures still come from every row; the second half of the
        # rows' predictions is the mean of the first half's
        eps, aux = orig(self, *a, **kw)
        n = max(eps.shape[0] // 2, 1)
        rest = eps[:n].mean(0, keepdim=True).expand(eps.shape[0] - n,
                                                     *eps.shape[1:])
        return torch.cat([eps[:n], rest]), aux

    monkeypatch.setattr(UNet2DCondition, "forward", forward)


def _altered_answer(monkeypatch):
    from rich_text_to_image_tpu_torch.models.vae import AutoencoderKL

    orig = AutoencoderKL.decode
    monkeypatch.setattr(AutoencoderKL, "decode",
                        lambda self, z: orig(self, z) + 0.02)


FAULTS = {"state_unchanged": _pndm_unchanged, "half_batch": _half_batch,
          "answer_altered": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    rc, res = run_tiny(tiny_cell("footnote"))
    assert rc == 0 and res is not None
    assert not res["correct"], res["checks"]


def test_the_control_fails_a_number():
    cell = tiny_cell("color")
    line = control.readings(cell, 7, torch.device("cpu"), True)
    lim = cell["limits"]["limits"]
    assert all(line["program"][k] <= lim[k] for k in lim), line
    assert any(line["control"][k] > lim[k] for k in lim), line
    # fp8 rounding of the UNet moves both passes' steps by far more than
    # float32 rounding does
    for k in ("plain_step_rel", "rich_step_rel"):
        assert line["control"][k] > 100 * max(line["program"][k], 1e-9)


def test_evaluate_twice_reads_the_same():
    cell = tiny_cell("footnote")
    dev = torch.device("cpu")
    rec, s = control.record_one(cell["cfg"], cell["traffic"], 5, dev)
    from benchmark.reference.check import Reference
    from benchmark.weights import draw_state

    ref = Reference(cell["cfg"], draw_state(cell["cfg"], 5, dev), dev)
    a = evaluate(ref, rec, cell["traffic"], s)
    b = evaluate(ref, rec, cell["traffic"], s)
    assert compare(a, b, rec) == {k: 0.0 for k in compare(a, b, rec)}
    assert harness.guided_sample(rec, 5, 12) == []
