"""Profiling and tracing hooks.

Counterpart of ``rich_text_to_image_tpu/utils/tracing.py``: a phase timer
that waits for the device at both ends of a phase, whose spans also show in
a profiler trace, and a context that records a device trace. The timer
keeps process-wide sums by phase name until :func:`phase_report` reads
them, as the JAX package's does.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterator

import torch

_PHASES: dict[str, float] = {}


def sync() -> None:
    """Wait for every queued kernel of the card (nothing to wait for where
    CUDA was never started, as in a CPU run)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase(name: str, annotate: bool = True,
          do_sync: bool = True) -> Iterator[None]:
    """Add the seconds of the block to phase ``name``; with ``annotate``
    the block is a ``torch.profiler.record_function`` span of that name,
    with ``do_sync`` the device is drained before and after it."""
    if do_sync:
        sync()
    t0 = time.perf_counter()
    cm = (torch.profiler.record_function(name) if annotate
          else contextlib.nullcontext())
    with cm:
        yield
    if do_sync:
        sync()
    _PHASES[name] = _PHASES.get(name, 0.0) + (time.perf_counter() - t0)


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
