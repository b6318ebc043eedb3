"""The readings of ``scripts/port_trace_cell.py``, on made-up tracer reports
and profiler events: the means over a window's spans, and the device's
operations laid on the program's spans by their launch times (the union
of the UNet's, its launches, the self-attention's device time, the idle
gaps by the innermost program span), each ``None`` where its spans are
missing."""

import importlib.util
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


@pytest.fixture(scope="module")
def cell():
    spec = importlib.util.spec_from_file_location(
        "port_trace_cell", os.path.join(ROOT, "scripts", "port_trace_cell.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Ev:
    def __init__(self, name, start, dur, dev=CPU, corr=0):
        self._n, self._s, self._d, self._dev, self._c = (name, start, dur,
                                                         dev, corr)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c


def span(name, start, end, sid, parent=None, sample=1, **extra):
    return dict(name=name, id=sid, parent=parent, sample=sample, attrs={},
                start_ns=start, end_ns=end, **extra)


def test_replay_share_of_graphable_units(cell):
    assert cell.replay_share({}) is None
    assert cell.replay_share({"unet_graph": {}}) is None
    assert cell.replay_share({"unet_graph": {
        "how=eager": 33, "how=capture": 33, "how=replay": 264}}) == 0.8
    assert cell.replay_share({"unet_calls": {"rows=2": 4},
                              "unet_graph": {"how=eager": 66}}) == 0.0


def test_window_read_means_and_counts(cell):
    rep = {"spans": [
        span("unet", 0, 30_000_000, 2, 1), span("unet", 40_000_000,
                                                 50_000_000, 3, 1),
        span("decode", 60_000_000, 70_000_000, 4, 1, device_ms=8.0),
        span("decode", 70_000_000, 80_000_000, 5, 1, device_ms=6.0),
        span("sample", 0, 90_000_000, 1)],
        "counters": {"unet_calls": {"rows=2": 1, "rows=3": 1}}}
    r = cell.window_read(rep)
    assert r["samples"] == 1
    assert r["unet_host_ms"] == pytest.approx(20.0)
    assert r["decode_ms"] == pytest.approx(7.0)
    assert r["spans_a_sample"]["unet"] == 2
    assert r["host_s_a_sample"]["sample"] == pytest.approx(0.09)
    assert r["counters_a_sample"] == {"unet_calls": {"rows=2": 1.0,
                                                     "rows=3": 1.0}}
    empty = cell.window_read({"spans": [span("sample", 0, 1, 1)],
                              "counters": {}})
    assert empty["unet_host_ms"] is None and empty["decode_ms"] is None


def _profile():
    spans = [
        span("sample", 0, 1000, 1),
        span("unet", 100, 500, 2, 1),
        span("unet.up.1", 150, 450, 3, 2),
        span("attn_self", 200, 250, 4, 3),
        span("unet", 600, 800, 5, 1),
        span("decode", 850, 950, 6, 1),
    ]
    events = [
        Ev("sample", 0, 1000),  # the benchmark's own range
        Ev("cudaLaunchKernel", 160, 5, corr=1),
        Ev("cudaLaunchKernel", 210, 5, corr=2),
        Ev("cudaLaunchKernel", 300, 5, corr=3),
        Ev("cudaLaunchKernel", 610, 5, corr=4),
        Ev("cudaLaunchKernel", 860, 5, corr=5),
        Ev("gemm", 170, 50, CUDA, 1),
        Ev("attn_fwd_kernel", 220, 60, CUDA, 2),
        Ev("conv", 320, 80, CUDA, 3),
        Ev("norm", 640, 40, CUDA, 4),
        Ev("vae_conv", 880, 100, CUDA, 5),
        # device-side mirrors of host ranges, not operations
        Ev("unet", 170, 230, CUDA), Ev("unet_forward", 170, 230, CUDA),
    ]
    return events, spans


def test_program_read_lays_operations_on_spans(cell):
    events, spans = _profile()
    r = cell.program_read(events, spans, 0, 1000)
    assert r["n_unet"] == 2 and r["n_attn_self"] == 1
    assert r["n_device_ops"] == 5 and r["n_unlaunched"] == 0
    # union of the ops launched inside unet spans: 170..280, 320..400,
    # 640..680
    assert r["unet_busy_s"] * 1e9 == pytest.approx(110 + 80 + 40)
    assert r["unet_device_ms"] == pytest.approx(1e3 * 230e-9 / 2)
    assert r["unet_launches"] == pytest.approx(4 / 2)
    assert r["attn_self_s"] * 1e9 == pytest.approx(60)
    assert r["busy_s"] * 1e9 == pytest.approx(110 + 80 + 40 + 100)
    by_span = {k: round(v * 1e9) for k, v in r["device_s_by_span"]}
    assert by_span == {"unet.up.1": 130, "attn_self": 60, "unet": 40,
                       "decode": 100}
    gaps = {k.split(" (")[0]: round(v * 1e9) for k, v in r["idle_gaps"]}
    # each gap named by the innermost program span of the launch that
    # ended it: 0..170 (at 160), 280..320 (300), 400..640 (610), 680..880
    # (860), and the window's end
    assert gaps == {"unet.up.1": 170 + 40, "unet": 240, "decode": 200,
                    "end of the window": 20}


def test_program_read_without_program_spans(cell):
    events, _ = _profile()
    r = cell.program_read(events, [], 0, 1000)
    assert r["n_unet"] == 0
    assert r["unet_device_ms"] is None and r["unet_launches"] is None
    assert r["attn_self_s"] == 0
    assert {k.split(" (")[0] for k, _ in r["idle_gaps"]} <= {
        "outside the spans", "end of the window"}
