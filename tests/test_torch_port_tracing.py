"""The port's tracing hooks (``utils/tracing.py``), after the tracing cases
of ``tests/test_viz_and_tracing.py``: the phase timer sums by name and
resets, and ``device_trace`` writes a Chrome trace (here of the CPU
activity) that holds the phases' spans. The JAX package's timer is held to
the same contract beside it."""

import json
import os
import time

import pytest
import torch

from rich_text_to_image_tpu.utils import tracing as JT
from rich_text_to_image_tpu_torch.utils import tracing as TT


@pytest.mark.parametrize("mod", [TT, JT], ids=["port", "jax"])
def test_phase_timer_accumulates_and_resets(mod):
    mod.phase_report(reset=True)
    for _ in range(2):
        with mod.phase("a"):
            time.sleep(0.01)
    with mod.phase("b", annotate=False, do_sync=False):
        pass
    kept = mod.phase_report(reset=False)
    assert set(kept) == {"a", "b"} and kept["a"] >= 0.02
    assert mod.phase_report(reset=True) == kept
    assert mod.phase_report() == {}


def test_sync_without_a_card_is_a_no_op():
    TT.sync()  # CUDA never started here: nothing to wait for


def test_device_trace_writes_the_phases_spans(tmp_path):
    TT.phase_report()
    with TT.device_trace(str(tmp_path / "trace")) as path:
        with TT.phase("rich_pass"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert os.path.dirname(path) == str(tmp_path / "trace")
    assert path.endswith(".pt.trace.json") and os.path.getsize(path) > 0
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "rich_pass" for e in events)
    assert set(TT.phase_report()) == {"rich_pass"}
