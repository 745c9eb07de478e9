"""Profiling and timing helpers.

Port of ``lagomorph_tpu/profiling.py``: :func:`trace` records a
``torch.profiler`` trace (host activity, and the card's kernels where
there is a card) as a Chrome trace that TensorBoard and Perfetto read;
:func:`device_time` times a call with a warm-up, synchronising CUDA after
each call whose outputs lie on the card (launches return before the card
finishes); :class:`Timer` accumulates the wall time of named sections.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "device_time", "Timer"]


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
    """Accumulating section timer for training loops.

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
