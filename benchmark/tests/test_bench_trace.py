"""The reading of a profiled sample, on made-up profiler events: busy time
as the union of device intervals, the kernels launched inside the
``attn1_core`` spans whatever their names, and the idle gaps labelled by
the span around the launch that ended them."""

from __future__ import annotations

import torch
from bench_tiny import ROOT  # noqa: F401  (puts the repository on the path)

from benchmark import trace as T

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


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


def test_read_busy_attention_and_gaps():
    ev = [
        Ev("sample", 0, 1000),
        Ev("unet_forward", 0, 600),
        Ev("attn1_core", 100, 100),
        Ev("cudaLaunchKernel", 110, 5, corr=1),
        Ev("cudaLaunchKernel", 150, 5, corr=2),
        Ev("cudaLaunchKernel", 300, 5, corr=3),
        Ev("vae_decode", 700, 200),
        Ev("cudaLaunchKernel", 800, 5, corr=4),
        Ev("any_kernel_name", 120, 50, CUDA, 1),
        Ev("another_one", 160, 60, CUDA, 2),   # overlaps the first
        Ev("gemm", 310, 90, CUDA, 3),
        Ev("conv", 850, 100, CUDA, 4),
    ]
    r = T.read(ev, 0, 1000)
    assert round(r["busy_s"] * 1e9) == (220 - 120) + 90 + 100
    assert round(r["attn_core_s"] * 1e9) == 50 + 60  # launched inside it
    assert round(r["window_s"] * 1e9) == 1000 and r["n_unlaunched"] == 0
    gaps = {k.split(" (")[0]: round(v * 1e9) for k, v in r["idle_gaps"]}
    assert gaps["attn1_core"] == 120           # 0..120, launched at 110
    assert gaps["unet_forward"] == 310 - 220   # launched at 300
    assert gaps["vae_decode"] == 850 - 400
    assert gaps["end of the window"] == 50
    assert r["device_ops"][0][0] == "conv"


def test_innermost_of_nested_spans():
    spans = sorted([(0, 100, "a"), (10, 20, "b"), (30, 60, "c"),
                    (40, 50, "d")], key=lambda x: (x[0], -x[1]))
    got = T.innermost(spans, [5, 15, 25, 45, 55, 99, 150])
    assert got == ["a", "b", "a", "d", "c", "a", "outside the spans"]
