"""Spans around the calls into each layer, set from the benchmark's own
files, and the reading of one profiled sample.

Spans (``torch.profiler.record_function``), opened and closed by hooks on
the pipeline object and its modules, never by edits to the program:

  plain_pass / rich_pass   ``produce_attn_maps`` / ``prompt_to_img``
  token_maps               ``utils.token_maps.get_token_maps``
  text_encode              the text towers' forwards
  unet_forward             the UNet's forward
  attn1_core               inside every self-attention module, from the end
                           of ``to_v`` to the start of ``to_out``: the
                           attention itself, whatever kernel runs it
  vae_decode               the VAE decoder's forward
  guided_step              ``_guided``

``read`` takes the raw events of ``torch.profiler`` (Kineto's, without
building the profiler's tree): device intervals (kernels, copies, sets),
their launches, and the spans; it returns the device's busy time, the
kernels launched inside ``attn1_core``, the device operations that took
most time and the idle gaps labelled by the innermost span around the
launch that ended them.
"""

from __future__ import annotations

import bisect

import torch
from torch.autograd.profiler import record_function

SPAN_NAMES = ("plain_pass", "rich_pass", "token_maps", "text_encode",
              "unet_forward", "attn1_core", "vae_decode", "guided_step")


class Spans:
    """Installs the spans on ``model``; ``remove()`` takes them off."""

    def __init__(self, model):
        import rich_text_to_image_tpu_torch.utils.token_maps as tm

        self._undo = []
        self._wrap(model, "produce_attn_maps", "plain_pass")
        self._wrap(model, "prompt_to_img", "rich_pass")
        self._wrap(model, "_guided", "guided_step")
        self._wrap(tm, "get_token_maps", "token_maps")
        texts = [model.text_encoder] + (
            [model.text_encoder_2] if hasattr(model, "text_encoder_2") else [])
        for t in texts:
            self._around(t, t, "text_encode")
        self._around(model.unet, model.unet, "unet_forward")
        self._around(model.vae.decoder, model.vae.decoder, "vae_decode")
        for m in model.unet.modules():
            if getattr(m, "layer_name", "").endswith(".attn1"):
                self._around(m.to_v, m.to_out[0], "attn1_core", after=True)

    def _wrap(self, obj, name, span):
        orig = getattr(obj, name)
        had = name in vars(obj)

        def wrapped(*a, **k):
            with record_function(span):
                return orig(*a, **k)

        setattr(obj, name, wrapped)
        self._undo.append(lambda: setattr(obj, name, orig) if had
                          else delattr(obj, name))

    def _around(self, first, last, span, after=False):
        """A span from ``first``'s forward (its end, with ``after``) to the
        end of ``last``'s forward (its start, with ``after``)."""
        stack = []

        def open_(*_):
            rf = record_function(span)
            rf.__enter__()
            stack.append(rf)

        def close(*_):
            if stack:
                stack.pop().__exit__(None, None, None)

        if after:
            hs = [first.register_forward_hook(open_),
                  last.register_forward_pre_hook(close)]
        else:
            hs = [first.register_forward_pre_hook(open_),
                  last.register_forward_hook(close)]
        self._undo += [h.remove for h in hs]

    def remove(self):
        for undo in reversed(self._undo):
            undo()
        self._undo = []


def profiled(fn, cpu: bool = True):
    """Run ``fn()`` under the profiler, CUDA and, with ``cpu``, the host's
    operators and spans; returns (its result, the raw events). Without the
    host side the profiler adds little time; with it, every operator is
    recorded and a host-bound sample runs slower."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts, record_shapes=False,
                 with_stack=False) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof.profiler.kineto_results.events()


def _annotation(name: str) -> bool:
    """A span mirrored on the device's timeline, not device work."""
    return name in SPAN_NAMES or name == "sample"


def busy(events, t0_ns: int, t1_ns: int) -> dict:
    """The union of the device's operations inside [t0, t1)."""
    iv, kinds = [], {}  # kinds: the commonest operation names, for the log
    for ev in events:
        if (ev.device_type() == torch.autograd.DeviceType.CUDA
                and not _annotation(ev.name())):
            s, e = ev.start_ns(), ev.start_ns() + ev.duration_ns()
            if e > t0_ns and s < t1_ns:
                iv.append((max(s, t0_ns), min(e, t1_ns)))
            k = ev.name().split("<")[0].split("(")[0][:40]
            kinds[k] = kinds.get(k, 0) + 1
    top = dict(sorted(kinds.items(), key=lambda x: -x[1])[:5])
    return dict(busy_s=sum(e - s for s, e in _union(iv)) / 1e9,
                window_s=(t1_ns - t0_ns) / 1e9, n_device_ops=len(iv),
                kinds=top)


def innermost(spans, times):
    """The name of the innermost span around each time; ``spans`` are
    nested intervals (start, end, name) sorted by (start, -end)."""
    out = [None] * len(times)
    stack, j = [], 0
    for i in sorted(range(len(times)), key=lambda i: times[i]):
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else "outside the spans"
    return out


def _union(iv):
    """Merged [start, end) intervals of a list."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(events, t0_ns: int, t1_ns: int) -> dict:
    """The device's time inside [t0, t1) (host clock, ns), from raw
    profiler events."""
    spans, launches, device = [], {}, []
    for ev in events:
        name, s = ev.name(), ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if e > t0_ns and s < t1_ns and not _annotation(name):
                device.append((max(s, t0_ns), min(e, t1_ns), name,
                               ev.correlation_id()))
        elif name in SPAN_NAMES:
            spans.append((s, e, name))
        elif name.startswith(("cuda", "cu")) and ev.correlation_id():
            launches[ev.correlation_id()] = s
    busy = _union([(s, e) for s, e, _, _ in device])
    busy_ns = sum(e - s for s, e in busy)
    spans.sort(key=lambda x: (x[0], -x[1]))
    attn_iv = [(s, e) for s, e, n in spans if n == "attn1_core"]
    attn_iv.sort()
    starts = [s for s, _ in attn_iv]

    def in_attn(t):
        j = bisect.bisect_right(starts, t) - 1
        return j >= 0 and attn_iv[j][0] <= t <= attn_iv[j][1]

    attn_ns, by_op, unlaunched = 0, {}, 0
    for s, e, name, corr in device:
        by_op[name] = by_op.get(name, 0) + (e - s)
        t = launches.get(corr)
        unlaunched += t is None
        if t is not None and in_attn(t):
            attn_ns += e - s
    # idle gaps, labelled by the span around the launch that ended each
    first = {}
    for s, e, name, corr in device:
        if s not in first:
            first[s] = launches.get(corr)
    edges = [(t0_ns, t0_ns)] + [tuple(b) for b in busy] + [(t1_ns, t1_ns)]
    holes = [(prev_end, nxt) for (_, prev_end), (nxt, _)
             in zip(edges, edges[1:]) if nxt > prev_end]
    names = innermost(spans, [first.get(b) or b for _, b in holes])
    gaps = {}
    for (a, b), name in zip(holes, names):
        label = ("end of the window" if b == t1_ns
                 else name if first.get(b) is not None else "unlaunched")
        n, tot = gaps.get(label, (0, 0))
        gaps[label] = (n + 1, tot + b - a)
    top = sorted(by_op.items(), key=lambda x: -x[1])[:10]
    return dict(
        window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy_ns / 1e9,
        attn_core_s=attn_ns / 1e9, n_device_ops=len(device),
        n_unlaunched=unlaunched,
        n_attn_spans=len(attn_iv),
        device_ops=[[n[:160], v / 1e9] for n, v in top],
        idle_gaps=[[f"{k} ({n} gaps)", v / 1e9] for k, (n, v) in sorted(
            gaps.items(), key=lambda x: -x[1][1])[:10]])
