"""Profiling and timing helpers.

Port of ``lagomorph_tpu/profiling.py``: :func:`trace` records a
``torch.profiler`` trace (host activity, and the card's kernels where
there is a card) as a Chrome trace that TensorBoard and Perfetto read;
:func:`device_time` times a call with a warm-up, synchronising CUDA after
each call whose outputs lie on the card (launches return before the card
finishes); :class:`Timer` accumulates the wall time of named sections.

:func:`span` marks a section of the program: it always counts the
section's entries (:func:`counters`), and while a profiler records it
records the section as a ``record_function`` range, which the profiler
keeps in the same session as the card's activity, so that spans and
kernels lie on one clock.  The atlas builder's spans carry the prefix
``lt.``: ``lt.iteration`` (a minibatch, ``LDDMMAtlasBuilder.iteration``),
``lt.stage`` (its host read, padding and copy to the device, with the bytes
put counted under ``lt.stage.bytes``), ``lt.step`` (the atlas step),
``lt.loss`` (its forward: ``lt.shoot``, the hoisted shooting, with
``lt.substep`` around each substep of its per-substep loop and
``lt.shoot.general`` on a tripped flag, and ``lt.warp``, the atlas warp),
``lt.backward``, ``lt.descend``, ``lt.allsum`` (the exchange between
processes), ``lt.update_atlas`` (the atlas's update) and the host reads of
the card, ``lt.read.flag``, ``lt.read.tier``, ``lt.read.loss`` and
``lt.read.reg``.  Counts that are not spans: ``fluid.route.<route>``,
one a fluid solve by the route it takes (``ops.fluid.fluid_operator``).
The kernels' launches are counted by the kernels themselves
(``ops.kernels.launch_counts``).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "device_time", "Timer", "span", "add", "counters", "reset_counters"]

_COUNTS: dict = {}
_LOCK = threading.Lock()  # the staging threads and autograd's count too
_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager over a section named ``name``: adds 1 to its count
    and, while a profiler records (on any thread), records it as a
    ``torch.profiler.record_function`` range; otherwise it is one shared
    ``nullcontext``.

    >>> with lagomorph_tpu_torch.profiling.span("lt.step"):
    ...     step(...)
    """
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + 1
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def add(name: str, k) -> None:
    """Add ``k`` to the count ``name`` (a count that is not a span's, such
    as ``lt.stage.bytes``)."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + k


def counters() -> dict:
    """A copy of every count, by name, since the last :func:`reset_counters`."""
    with _LOCK:
        return dict(_COUNTS)


def reset_counters() -> None:
    """Clear every count."""
    with _LOCK:
        _COUNTS.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block into a new
    ``<pid>.<ns>.pt.trace.json`` file of ``logdir`` (made if missing):

    >>> with lagomorph_tpu_torch.profiling.trace("traces/step"):
    ...     step(...)
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(logdir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def _synchronize(out):
    """Wait for the card when ``out`` (a tensor, or a tuple, list or dict
    of them) holds a CUDA tensor."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _synchronize(o)
    elif isinstance(out, dict):
        for o in out.values():
            _synchronize(o)


def device_time(fn, *args, warmup: int = 1, iters: int = 3, **kwargs):
    """Median wall time in seconds of ``fn(*args, **kwargs)`` over
    ``iters`` calls after ``warmup`` (at least one), each call ending when
    the card has finished its outputs."""
    for _ in range(max(warmup, 1)):
        _synchronize(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _synchronize(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


class Timer:
    """Accumulating section timer for training loops; each section is also
    a :func:`span` of its name.

    >>> t = Timer()
    >>> with t("data"):
    ...     batch = next(loader)
    >>> with t("step"):
    ...     out = step(batch); torch.cuda.synchronize()
    >>> t.summary()
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_s": v / self.counts[k]}
            for k, v in self.totals.items()
        }
