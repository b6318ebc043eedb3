"""The port's tracer (``utils/tracing.py``), after the tracing cases of
``tests/test_viz_and_tracing.py``: the phase timer sums by name and resets,
and ``device_trace`` writes a Chrome trace (here of the CPU activity) that
holds the phases' spans; the JAX package's timer is held to the same
contract beside it. Then the tracer's record: nothing while off, spans
nested by parent and sample while on, counters, the profiler's clock, CUDA
events only where there is a card, and ``cli/sample.py --trace_dir``."""

import json
import os
import time

import pytest
import torch

from rich_text_to_image_tpu.utils import tracing as JT
from rich_text_to_image_tpu_torch.utils import tracing as TT
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)


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


# ------------------------------------------------------ the tracer's record
@pytest.fixture
def clean_tracer():
    """The tracer off and empty around a test."""
    TT.disable()
    TT.report()
    yield
    TT.disable()
    TT.report()


def _profiled_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.profiler.kineto_results.events()


def test_off_records_nothing_and_opens_no_range(clean_tracer):
    def work():
        TT.count("calls", rows=2)
        with TT.span("outer", rows=2):
            with TT.span("inner", device=True) as sp:
                torch.ones(4) + 1
        return sp

    events = _profiled_names(work)
    assert TT.report() == {"spans": [], "counters": {}}
    assert not {"outer", "inner"} & {e.name() for e in events}
    # the shared no-op object: no allocation for a span that is off
    assert TT.span("a") is TT.span("b", device=True, path="x")


def test_on_nests_parents_and_samples(clean_tracer):
    with TT.collect():
        with TT.span("before"):
            pass
        for _ in range(2):
            with TT.span("sample"):
                with TT.span("loop", flow="plain", **{"pass": "rich"}):
                    with TT.span("unet", inherit=("pass", "flow"), rows=3):
                        with TT.span("attn_self", path="flash_attention"):
                            pass
    rep = TT.report()
    spans = rep["spans"]
    assert [s["name"] for s in spans] == ["before"] + [
        "attn_self", "unet", "loop", "sample"] * 2
    by_id = {s["id"]: s for s in spans}
    assert spans[0]["parent"] is None and spans[0]["sample"] is None
    for k in (0, 4):
        attn, unet, loop, root = spans[1 + k:5 + k]
        assert (attn["parent"], unet["parent"], loop["parent"],
                root["parent"]) == (unet["id"], loop["id"], root["id"], None)
        assert {attn["sample"], unet["sample"], loop["sample"]} == {
            root["id"]} and root["sample"] == root["id"]
        assert unet["attrs"] == {"rows": 3, "pass": "rich", "flow": "plain"}
        assert attn["attrs"] == {"path": "flash_attention"}
        for s in (attn, unet, loop):
            up = by_id[s["parent"]]
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] <= (
                up["end_ns"])
    assert spans[1]["sample"] != spans[5]["sample"]
    assert "device_ms" not in spans[2]


def test_counters_count_and_reset_clears(clean_tracer):
    TT.enable()
    for rows in (2, 2, 5):
        TT.count("unet_calls", rows=rows)
    TT.count("guided_steps")
    TT.count("guided_steps", n=2)
    with TT.span("x"):
        pass
    kept = TT.report(reset=False)
    assert kept["counters"] == {"unet_calls": {"rows=2": 2, "rows=5": 1},
                                "guided_steps": {"": 3}}
    assert TT.report(reset=True) == kept
    assert TT.report() == {"spans": [], "counters": {}}


def test_spans_share_the_profilers_clock(clean_tracer):
    """The host times of a span bracket, to within 50 us, the range the
    CPU profiler records for it: the two lie on one timeline."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, TT.collect():
        for i in range(20):
            with TT.span(f"span{i}"):
                torch.randn(32, 32) @ torch.randn(32, 32)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()}
    spans = TT.report()["spans"]
    assert len(spans) == 20
    slack = 50_000  # ns
    for s in spans:
        ev = ranges[s["name"]]
        assert s["start_ns"] - slack <= ev.start_ns()
        assert ev.start_ns() + ev.duration_ns() <= s["end_ns"] + slack


def test_device_span_without_a_card_records_no_event(clean_tracer):
    with TT.collect():
        with TT.span("decode", device=True) as sp:
            torch.ones(8).sum()
    (s,) = TT.report()["spans"]
    assert s["name"] == "decode" and "device_ms" not in s
    assert sp.seconds >= 0


def test_timed_span_reads_the_clock_with_the_tracer_off(clean_tracer):
    with TT.span("plain_pass", timed=True) as sp:
        time.sleep(0.01)
    assert sp.seconds >= 0.01
    assert TT.report()["spans"] == []


def test_a_span_left_by_an_exception_closes(clean_tracer):
    with TT.collect():
        with pytest.raises(ValueError):
            with TT.span("sample"):
                with TT.span("unet"):
                    raise ValueError("stop")
        with TT.span("after"):
            pass
    spans = TT.report()["spans"]
    assert [s["name"] for s in spans] == ["unet", "sample", "after"]
    assert spans[2]["parent"] is None and spans[2]["sample"] is None


def test_phase_lands_in_the_record(clean_tracer):
    TT.phase_report()
    with TT.collect():
        with TT.span("sample"):
            with TT.phase("rich_pass"):
                time.sleep(0.005)
    spans = TT.report()["spans"]
    assert [s["name"] for s in spans] == ["rich_pass", "sample"]
    assert spans[0]["parent"] == spans[1]["id"]
    took = (spans[0]["end_ns"] - spans[0]["start_ns"]) / 1e9
    assert TT.phase_report()["rich_pass"] == pytest.approx(took)


def test_cli_trace_dir_writes_the_trace_and_the_report(
        clean_tracer, tmp_path, monkeypatch):
    """``cli/sample.py --trace_dir DIR`` (the tiny SD pipeline in place of
    the CLI's full-size one): a Chrome trace holding the program's spans
    and the tracer's report beside it, both with the root span ``sample``;
    the tracer is off again afterwards."""
    from rich_text_to_image_tpu_torch.cli import sample as cli
    from rich_text_to_image_tpu_torch.models import config as C
    from rich_text_to_image_tpu_torch.pipelines.region_sd import (
        RegionDiffusion)

    pipe = RegionDiffusion.random_init(
        unet_cfg=C.TINY_UNET, vae_cfg=C.TINY_VAE, text_cfg=C.TINY_TEXT,
        device="cpu", dtype=torch.float32, agg_start_step=1)
    monkeypatch.setattr(cli, "build_model", lambda args: pipe)
    trace_dir = tmp_path / "trace"
    cli.main(["--device", "cpu", "--sample_steps", "2", "--height", "16",
              "--width", "16", "--num_segments", "3", "--run_dir",
              str(tmp_path / "out"), "--trace_dir", str(trace_dir)])
    (trace,) = trace_dir.glob("*.pt.trace.json")
    (spans,) = trace_dir.glob("*.spans.json")
    assert spans.name == trace.name.replace(".pt.trace.json", ".spans.json")
    with open(trace, encoding="utf-8") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"sample", "plain_pass", "rich_pass", "unet", "decode",
            "attn_self", "unet.mid"} <= names
    with open(spans, encoding="utf-8") as f:
        rep = json.load(f)
    (root,) = [s for s in rep["spans"] if s["name"] == "sample"]
    assert all(s["sample"] == root["id"] for s in rep["spans"])
    assert sum(rep["counters"]["unet_calls"].values()) == sum(
        s["name"] == "unet" for s in rep["spans"]) > 0
    assert TT.report() == {"spans": [], "counters": {}}
    with TT.span("after"):
        pass
    assert TT.report()["spans"] == []
