"""A whole run of a cell on the card: the result line's keys and the
comparison passing. Needs a CUDA card; run it there with
``python -m pytest benchmark/tests/test_bench_card.py -m cuda``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from bench_tiny import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels run only there")


@pytest.mark.cuda
def test_a_short_run_of_the_first_cell(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sd15-512-footnote",
         "--seed", str(2 ** 31 + 99), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert set(res["metrics"]) == {"images_per_min", "peak_mem_gib",
                                   "setup_s"}


def test_without_a_card_the_run_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "sd15-512-footnote", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible to this process")
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")
