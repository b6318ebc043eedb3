"""The window's arithmetic with the sample replaced by a sleep: samples
run back to back, none starts after ``--seconds``, every one started is
finished and counted, and the rate is all samples over all the time; the
checked sample is drawn uniformly among them."""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch
from bench_tiny import ROOT  # noqa: F401  (puts the repository on the path)

from benchmark import harness


class _Recorder:
    def __init__(self):
        self.started = []

    def start(self):
        self.started.append(True)

    def stop(self):
        return {"n": len(self.started)}


def _window(monkeypatch, seconds, sample_s, seed=1):
    import rich_text_to_image_tpu_torch.cli.sample as cli

    calls = []

    def fake(model, args, param, save=True):
        calls.append(param["noise_index"])
        time.sleep(sample_s)
        return None, None, {"plain_pass": sample_s / 2, "token_maps": 0.0,
                            "rich_pass": sample_s / 2}

    monkeypatch.setattr(cli, "run_sample", fake)
    model = types.SimpleNamespace(device=torch.device("cpu"))
    cfg = {"pipeline": {"height": 8, "width": 8, "guidance_scale": 1.0,
                        "steps": 3}}
    traffic = {"rich_text": {"ops": []}}
    out = harness.run_window(model, None, cfg, traffic, seed, seconds,
                             _Recorder())
    return out, calls


@pytest.mark.parametrize("seconds,sample_s,want", [
    (0.0, 0.02, 1),     # the first sample always runs
    (0.05, 0.04, 2),    # the second starts at 0.04 < 0.05 and finishes
    (0.25, 0.06, 5),    # starts at 0, .06, .12, .18, .24; none at .30
])
def test_samples_and_overshoot(monkeypatch, seconds, sample_s, want):
    (samples, rec, check_i, peak), calls = _window(monkeypatch, seconds,
                                                   sample_s)
    assert len(samples) == want == len(calls)
    assert all(s["start"] < seconds or s["index"] == 0 for s in samples)
    assert samples[-1]["end"] >= min(seconds, samples[-1]["end"])
    assert len(set(calls)) == want  # each sample its own seed
    span = samples[-1]["end"] - samples[0]["start"]
    assert span == pytest.approx(want * sample_s, rel=0.5)
    assert rec is not None and 0 <= check_i < want and peak == 0


def test_rate_is_all_samples_over_all_the_time():
    samples = [dict(start=0.0, end=1.0), dict(start=1.0, end=3.5)]
    span = samples[-1]["end"] - samples[0]["start"]
    assert 60.0 * len(samples) / span == pytest.approx(34.2857, rel=1e-4)


def test_the_checked_sample_is_uniform_over_the_window():
    # the reservoir's draws alone: sample i replaces the kept one with
    # probability 1/(i+1)
    n, counts = 4, np.zeros(4)
    for seed in range(4000):
        rng = np.random.default_rng(harness.derive(seed, "check"))
        kept = None
        for i in range(n):
            if rng.random() * (i + 1) < 1.0:
                kept = i
        counts[kept] += 1
    assert (np.abs(counts / counts.sum() - 0.25) < 0.03).all()


def test_sample_seeds_are_fixed_by_the_run_seed():
    a = [harness.sample_seed(2 ** 31 + 7, i) for i in range(4)]
    assert a == [harness.sample_seed(2 ** 31 + 7, i) for i in range(4)]
    assert len(set(a)) == 4 and all(0 <= s < 2 ** 48 for s in a)
    assert a != [harness.sample_seed(2 ** 31 + 8, i) for i in range(4)]
