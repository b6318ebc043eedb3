#!/usr/bin/env python3
"""What the port's tracer (``utils/tracing``) reads of a benchmark cell, on
the card.

    python3 scripts/port_trace_cell.py --workload <cell> --seed <n> \
        [--samples 3] [--rounds 2]

The cell's pipeline is built as ``benchmark/run.py`` builds it (weights
drawn on the card from the seed, the program's constructors, one warm-up
sample of the cell's shapes). Then:

1. The tracer's cost: ``rounds`` pairs of windows of ``samples`` samples
   back to back, one window with the tracer off and one with it on (with
   its ``record_function`` ranges, as ``cli/sample.py --trace_dir`` runs),
   in turns (off first in even rounds), the same sample seeds in both;
   images a minute of each window.
2. From the windows with the tracer on: ``unet_host_ms``, the host
   milliseconds of a ``unet`` span (one UNet call, nothing synchronised
   inside; ``dit_host_ms`` of a ``dit`` span, one FLUX.1 transformer call,
   in a cell of the ``flux`` family), and ``decode_ms``, the CUDA-event
   milliseconds of a ``decode`` span, means over the spans; the spans,
   counters and host seconds of each span name a sample.
3. One more sample profiled with the host's and the card's activity, the
   tracer on without ranges (``enable(annotate=False)``) and the
   benchmark's span hooks installed, so that the benchmark's reading
   (``benchmark/trace.read``: busy time, ``attn_roofline``) sees what it
   sees without the tracer. The program's spans are laid on the profile by
   their host times (the profiler's clock): ``unet_device_ms``, the device
   busy time (union) of the operations launched inside ``unet`` spans over
   their number; ``unet_launches``, those operations over the same number;
   ``attn_self_roofline``, the attention bound of ``attn_roofline`` (the
   family's ``work``) over the device time of the operations launched
   inside ``attn_self`` spans; in a ``flux`` cell ``dit_device_ms``,
   ``dit_launches`` and ``attn_joint_roofline`` the same over ``dit`` and
   ``attn_joint`` spans; the device time and the
   idle gaps by the innermost program span (of the launch, and of the
   launch that ended the gap).

Beside them: the share of the UNet's graphable units that replayed a CUDA
graph in the windows (the ``unet_graph`` counter, ``how=replay`` over all),
and ``peak_mem_gib`` (``max_memory_allocated``, as the benchmark reads it)
with ``max_memory_reserved`` over the windows, which counts the graphs'
memory pool as well.

The last line of standard output is the result as JSON; the log goes to
standard error. Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------- readings
def _mean(v):
    return sum(v) / len(v) if v else None


def replay_share(counters: dict):
    """The share of the UNet's graphable units that replayed a graph
    (``unet_graph``: ``how`` = replay, capture or eager), None where the
    counter is missing."""
    by = counters.get("unet_graph", {})
    total = sum(by.values())
    return by.get("how=replay", 0) / total if total else None


def window_read(rep: dict, call: str = "unet") -> dict:
    """The tracer's report of whole samples: the means over its spans (the
    denoiser's calls being the spans ``call``), and what a sample holds
    (spans by name, counters, host seconds by name)."""
    by = defaultdict(list)
    for s in rep["spans"]:
        by[s["name"]].append(s)
    n = len(by["sample"])

    def dur_ms(s):
        return (s["end_ns"] - s["start_ns"]) / 1e6

    def dev_ms(name):
        return _mean([s["device_ms"] for s in by[name] if "device_ms" in s])

    return dict(
        samples=n,
        **{f"{call}_host_ms": _mean([dur_ms(s) for s in by[call]]),
           f"{call}_event_ms": dev_ms(call)}, decode_ms=dev_ms("decode"),
        guided_step_ms=dev_ms("guided_step"),
        spans_a_sample={k: len(v) / n for k, v in sorted(by.items())}
        if n else {},
        host_s_a_sample={k: sum(dur_ms(s) for s in v) / 1e3 / n
                         for k, v in sorted(by.items())} if n else {},
        counters_a_sample={k: {kk: c / n for kk, c in sorted(v.items())}
                           for k, v in sorted(rep["counters"].items())}
        if n else {})


def _inside(intervals):
    """Whether a time lies in one of ``intervals`` (disjoint)."""
    iv = sorted(intervals)
    starts = [s for s, _ in iv]

    def test(t):
        j = bisect.bisect_right(starts, t) - 1
        return j >= 0 and iv[j][0] <= t <= iv[j][1]
    return test


def program_read(events, spans, t0: int, t1: int, call: str = "unet",
                 attn: str = "attn_self") -> dict:
    """The device's operations in [t0, t1) (ns) of a profile against the
    program's spans (``tracing.report()["spans"]``, host times on the
    profiler's clock): each operation belongs to the spans around its
    launch; ``call`` names the denoiser's call spans, ``attn`` its
    attention spans. Device events that mirror a host range (the
    benchmark's span names, the program's) are not operations."""
    import torch

    from benchmark import trace as T

    cuda = torch.autograd.DeviceType.CUDA
    names = {s["name"] for s in spans}
    iv = [(s["start_ns"], s["end_ns"], s["name"]) for s in spans
          if s["end_ns"] > t0 and s["start_ns"] < t1]
    iv.sort(key=lambda x: (x[0], -x[1]))
    device, launches = [], {}
    for ev in events:
        name, s = ev.name(), ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == cuda:
            if (e > t0 and s < t1 and not T._annotation(name)
                    and name not in names):
                device.append((max(s, t0), min(e, t1), ev.correlation_id()))
        elif name.startswith(("cuda", "cu")) and ev.correlation_id():
            launches[ev.correlation_id()] = s
    of = {k: [(s, e) for s, e, n in iv if n == k] for k in (call, attn)}
    in_unet, in_attn = _inside(of[call]), _inside(of[attn])
    launched = [launches.get(c) for _, _, c in device]
    labels = T.innermost(iv, [t if t is not None else s
                              for (s, _, _), t in zip(device, launched)])
    unet_ops, attn_ns, by_span, unlaunched = [], 0, defaultdict(int), 0
    for (s, e, _), t, label in zip(device, launched, labels):
        if t is None:
            unlaunched += 1
            continue
        by_span[label] += e - s
        if in_unet(t):
            unet_ops.append((s, e))
        if in_attn(t):
            attn_ns += e - s
    busy = T._union([(s, e) for s, e, _ in device])
    # idle gaps, labelled by the innermost program span around the launch
    # of the operation that ended each
    first = {}
    for (s, _, _), t in zip(device, launched):
        first.setdefault(s, t)
    edges = [(t0, t0)] + [tuple(b) for b in busy] + [(t1, t1)]
    holes = [(a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]
    hole_labels = T.innermost(iv, [first.get(b) or b for _, b in holes])
    gaps = defaultdict(lambda: [0, 0])
    for (a, b), label in zip(holes, hole_labels):
        label = ("end of the window" if b == t1 else label
                 if first.get(b) is not None else "unlaunched")
        gaps[label][0] += 1
        gaps[label][1] += b - a
    n_unet = len(of[call])
    unet_busy_s = sum(e - s for s, e in T._union(unet_ops)) / 1e9
    return {
        f"n_{call}": n_unet, f"n_{attn}": len(of[attn]),
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        f"{call}_busy_s": unet_busy_s, f"{call}_ops": len(unet_ops),
        f"{attn}_s": attn_ns / 1e9,
        f"{call}_device_ms": 1e3 * unet_busy_s / n_unet if n_unet else None,
        f"{call}_launches": len(unet_ops) / n_unet if n_unet else None,
        "n_device_ops": len(device), "n_unlaunched": unlaunched,
        "device_s_by_span": [[k, v / 1e9] for k, v in sorted(
            by_span.items(), key=lambda x: -x[1])[:12]],
        "idle_gaps": [[f"{k} ({n} gaps)", v / 1e9] for k, (n, v) in sorted(
            gaps.items(), key=lambda x: -x[1][1])[:12]]}


# --------------------------------------------------------------------- run
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--samples", type=int, default=3)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    import torch

    from benchmark import harness as H
    from benchmark import trace as T
    from benchmark.weights import derive
    from rich_text_to_image_tpu_torch.cli.sample import run_sample
    from rich_text_to_image_tpu_torch.utils import tracing

    cell = H.load_cell(args.workload)
    cfg, traffic = cell["cfg"], cell["traffic"]
    fam = H.family(cfg)
    # the program's spans of one denoiser call and of its attention
    call, attn = getattr(fam, "PROGRAM_SPANS", ("unet", "attn_self"))
    dev = torch.device("cuda", 0)
    state = fam.draw_state(cfg, args.seed, dev)
    model = fam.build_model(cfg, state, dev)
    del state
    cargs = H.cli_args(cfg, traffic)
    steps = cfg["pipeline"]["steps"]

    def sample(seed, n_steps=steps):
        run_sample(model, cargs, H.sample_param(cfg, traffic, seed, n_steps),
                   save=False)
        torch.cuda.synchronize()

    sample(derive(args.seed, "warmup"),
           cfg["pipeline"]["agg_start_step"] + H.WARMUP_STEPS_PAST_CAPTURE)
    log(f"set-up {time.perf_counter() - t_start:.3f} s; hardware "
        + json.dumps(H.hardware()))

    # ---- the tracer's cost, and its reading of whole samples
    torch.cuda.reset_peak_memory_stats(dev)
    rates, reports = {"off": [], "on": []}, []
    for r in range(args.rounds):
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            if mode == "on":
                tracing.report()
                tracing.enable()
            a = time.perf_counter()
            for i in range(args.samples):
                sample(H.sample_seed(args.seed, i))
            b = time.perf_counter()
            tracing.disable()
            if mode == "on":
                reports.append(tracing.report())
            rates[mode].append(60.0 * args.samples / (b - a))
            log(f"round {r}, tracer {mode}: {args.samples} samples in "
                f"{b - a:.4f} s, {rates[mode][-1]:.4f} images/min")
    ratios = [on / off for on, off in zip(rates["on"], rates["off"])]
    merged = {"spans": [s for rep in reports for s in rep["spans"]],
              "counters": {}}
    for rep in reports:
        for k, v in rep["counters"].items():
            for kk, c in v.items():
                merged["counters"].setdefault(k, {})
                merged["counters"][k][kk] = merged["counters"][k].get(
                    kk, 0) + c
    win = window_read(merged, call)
    share = replay_share(merged["counters"])
    del merged, reports
    gib = float(1 << 30)
    memory = dict(peak_mem_gib=torch.cuda.max_memory_allocated(dev) / gib,
                  max_memory_reserved_gib=(
                      torch.cuda.max_memory_reserved(dev) / gib))
    log(f"unet_graph replay share {share}; memory of the windows "
        + json.dumps(memory))

    # ---- one sample profiled, the program's spans laid on it
    hooks = fam.spans(model)
    clock = {}

    def profiled_sample():
        clock["start"] = time.time_ns()
        with torch.autograd.profiler.record_function("sample"):
            sample(derive(args.seed, "profiled"))
        clock["end"] = time.time_ns()

    tracing.report()
    tracing.enable(annotate=False)
    _, events = T.profiled(profiled_sample)
    tracing.disable()
    hooks.remove()
    rep = tracing.report()
    t0 = t1 = None
    for ev in events:
        if ev.name() == "sample" and ev.device_type() != (
                torch.autograd.DeviceType.CUDA):
            t0, t1 = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    old = T.read(events, t0, t1)
    new = program_read(events, rep["spans"], t0, t1, call, attn)
    del events
    root = next(s for s in rep["spans"] if s["name"] == "sample")
    bound = fam.work(cfg, traffic)[1]
    out = dict(
        workload=args.workload, seed=args.seed,
        device=torch.cuda.get_device_name(dev),
        power_limit=H.hardware().get("power.limit"),
        images_per_min_off=rates["off"], images_per_min_on=rates["on"],
        on_over_off=ratios, on_over_off_median=statistics.median(ratios),
        **{f"{call}_host_ms": win[f"{call}_host_ms"],
           f"{call}_device_ms": new[f"{call}_device_ms"],
           f"{call}_launches": new[f"{call}_launches"],
           f"{attn}_roofline": (100.0 * bound / new[f"{attn}_s"]
                                if new[f"{attn}_s"] > 0 else None)},
        decode_ms=win["decode_ms"], unet_graph_replay_share=share, **memory,
        attn_roofline=(100.0 * bound / old["attn_core_s"]
                       if old["attn_core_s"] > 0 else None),
        window=win,
        profiled=dict(
            new, window_s=(t1 - t0) / 1e9, hooks_busy_s=old["busy_s"],
            hooks_idle_gaps=old["idle_gaps"],
            clock_us=dict(sample_span_start=(root["start_ns"] - t0) / 1e3,
                          sample_span_end=(t1 - root["end_ns"]) / 1e3,
                          host_clock_start=(t0 - clock["start"]) / 1e3)))
    log("idle gaps of the profiled sample by innermost program span: "
        + json.dumps(new["idle_gaps"]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
