"""The port's tracer: spans, counters, the phase timer and a device trace.

Counterpart of ``rich_text_to_image_tpu/utils/tracing.py``, grown into one
record of where a sample's time goes.

* :func:`span` marks a block of the program. Off (the default) it is one
  flag check and a shared no-op object: no clock is read, nothing is
  allocated, no profiler range is opened. On (:func:`enable`, or inside
  :func:`collect`) it records its name, its id, the id of the span that
  opened it, the id of its sample (the root span ``sample``; children
  inherit it) and its attrs, with its host start and end; while a profiler
  runs it also opens a ``torch.profiler.record_function`` of its name, so
  that it shows in the profiler's trace. With ``device=True`` it also
  records a CUDA event pair where the card is in use, read only when the
  report is taken.
* :func:`count` adds to a counter, under the same on/off rule.
* :func:`report` hands out the closed spans and the counters as plain data.
* :func:`phase` (seconds summed by name, the card drained at both ends,
  read by :func:`phase_report`) is a span that synchronises.
* :func:`device_trace` records a block under ``torch.profiler`` into a
  Chrome trace.

Host times are ``time.time_ns()``: the wall clock that ``torch.profiler``
converts its host events to (its approximate clock is calibrated against
it), so a span's start and end lie on the profiler trace's timeline, beside
the device's events.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import socket
import time
from typing import Iterator

import torch

_PHASES: dict[str, float] = {}

_ON = False
_ANNOTATE = True
_OPEN: list = []    # the recorded spans now open, innermost last
_CLOSED: list = []  # the recorded spans closed since the last report
_COUNTS: dict[str, dict[str, int]] = {}
_IDS = itertools.count(1)


def sync() -> None:
    """Wait for every queued kernel of the card (nothing to wait for where
    CUDA was never started, as in a CPU run)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ------------------------------------------------------------------ on / off
def enable(annotate: bool = True) -> None:
    """Record spans and counters from now on. With ``annotate=False`` the
    spans open no ``record_function`` range even while a profiler runs, so
    that a profile labelled by ranges of its own holds the same events as
    with the tracer off; the spans still lie on its timeline by their host
    times."""
    global _ON, _ANNOTATE
    _ON, _ANNOTATE = True, bool(annotate)


def enabled() -> bool:
    """Whether spans and counters are being recorded."""
    return _ON


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`report`."""
    global _ON
    _ON = False


@contextlib.contextmanager
def collect(annotate: bool = True) -> Iterator[None]:
    """The tracer on for the block, then as it was."""
    was = (_ON, _ANNOTATE)
    enable(annotate)
    try:
        yield
    finally:
        if was[0]:
            enable(was[1])
        else:
            disable()


# --------------------------------------------------------------------- spans
class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "device", "sync", "annotate", "id",
                 "parent", "sample", "start_ns", "end_ns", "seconds",
                 "_rf", "_events")

    def __init__(self, name, attrs, device, sync_, annotate):
        self.name, self.attrs = name, attrs
        self.device, self.sync, self.annotate = device, sync_, annotate
        self.id = self.parent = self.sample = self._rf = self._events = None
        self.seconds = None

    def __enter__(self):
        if self.sync:
            sync()
        if _ON:
            up = _OPEN[-1] if _OPEN else None
            self.id = next(_IDS)
            self.parent = up.id if up is not None else None
            self.sample = (self.id if self.name == "sample"
                           else up.sample if up is not None else None)
            _OPEN.append(self)
        if self.annotate:
            self._rf = torch.profiler.record_function(self.name)
        self.start_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__enter__()
        if self.device and self.id is not None and (
                torch.cuda.is_initialized()):
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self.sync:
            sync()
        self.end_ns = time.time_ns()
        self.seconds = (self.end_ns - self.start_ns) / 1e9
        if self.id is not None:
            # a span left open by an exception below is closed with it
            while _OPEN and _OPEN.pop() is not self:
                pass
            _CLOSED.append(self)
        return False

    def as_dict(self) -> dict:
        out = dict(name=self.name, id=self.id, parent=self.parent,
                   sample=self.sample, attrs=dict(self.attrs),
                   start_ns=self.start_ns, end_ns=self.end_ns)
        if self._events is not None:
            self._events[1].synchronize()
            out["device_ms"] = self._events[0].elapsed_time(self._events[1])
        return out


def span(name: str, device: bool = False, timed: bool = False,
         inherit: tuple = (), **attrs):
    """A span of the program (a context manager); see the module's
    docstring. ``timed`` makes the span read the clock even with the
    tracer off, into its ``seconds`` once closed. ``inherit`` names attrs
    taken, where the span does not set them, from the innermost open span
    that has them."""
    if not _ON:
        if not timed:
            return _OFF
        return _Span(name, attrs, False, False, False)
    if inherit:
        for k in inherit:
            if k not in attrs:
                for up in reversed(_OPEN):
                    if k in up.attrs:
                        attrs[k] = up.attrs[k]
                        break
    return _Span(name, attrs, device, False,
                 _ANNOTATE and torch._C._autograd._profiler_enabled())


def count(name: str, n: int = 1, **key) -> None:
    """Add ``n`` to counter ``name`` under ``key`` (``rows=3`` reads
    ``"rows=3"``; no key reads ``""``), while the tracer is on."""
    if not _ON:
        return
    k = ",".join(f"{a}={v}" for a, v in sorted(key.items()))
    by = _COUNTS.setdefault(name, {})
    by[k] = by.get(k, 0) + n


def report(reset: bool = True) -> dict:
    """``{"spans": [...], "counters": {name: {key: n}}}``: the spans closed
    and the counts made since the last reset, as plain data. A span reads
    ``name``, ``id``, ``parent``, ``sample``, ``attrs``, ``start_ns`` and
    ``end_ns`` (host, ``time.time_ns()``), and ``device_ms`` where it
    recorded CUDA events (the report waits for them)."""
    out = {"spans": [s.as_dict() for s in _CLOSED],
           "counters": {k: dict(v) for k, v in _COUNTS.items()}}
    if reset:
        _CLOSED.clear()
        _COUNTS.clear()
    return out


# --------------------------------------------------------------------- phase
@contextlib.contextmanager
def phase(name: str, annotate: bool = True,
          do_sync: bool = True) -> Iterator[None]:
    """Add the seconds of the block to phase ``name``; with ``annotate``
    the block is a ``torch.profiler.record_function`` span of that name,
    with ``do_sync`` the device is drained before and after it. A span
    that drains the card, recorded like any other while the tracer is
    on."""
    sp = _Span(name, {}, False, do_sync, annotate)
    with sp:
        yield
    _PHASES[name] = _PHASES.get(name, 0.0) + sp.seconds


def phase_report(reset: bool = True) -> dict[str, float]:
    """{phase: seconds} summed since the last reset."""
    out = dict(_PHASES)
    if reset:
        _PHASES.clear()
    return out


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[str]:
    """Record the block under ``torch.profiler`` (CPU activity, and CUDA
    where there is a card) and write it as a Chrome trace into ``logdir``,
    named as TensorBoard's profiler plugin reads it; yields the file's
    path."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}.pt.trace.json")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield path
        sync()
    prof.export_chrome_trace(path)
