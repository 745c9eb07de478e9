"""One process's run of a cell: set-up, the measured window, the trace and
the comparison with the reference.

The program under test is ``lagomorph_tpu_torch.lddmm.LDDMMAtlasBuilder``,
driven by ``builder.epoch()``, with the data path the traffic names
(``keep_data_on_device``, default true; ``loader_workers``, default 0;
``loader_mode``, default ``"thread"``).  The
harness wraps the builder instance's ``iteration`` (and its epoch-end
``update_base_image``) to time each return: a return follows the builder's
``float(loss)`` read, so it is synchronous.  Nothing here is imported by the
program.
"""
from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from . import check
from .inputs import Inputs


class StopWindow(Exception):
    """Raised from the iteration wrapper once the window has closed."""


class Subjects:
    """The builder's dataset: ``n`` subjects of which this process holds
    its own (``dataset[i]`` a host array ``(1, *spatial)``)."""

    def __init__(self, n, items):
        self.n, self.items = n, items

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.items[i]


class Probe:
    """The harness's wrapper on one builder instance: the host time of each
    iteration's return, the window's close, the warm-up epoch's snapshots
    for the comparison, and a span around each iteration and epoch end."""

    def __init__(self, builder, inputs, rank, world, stop_fds):
        self.b, self.rank, self.world, self.stop_fds = builder, rank, world, stop_fds
        self.rows = [len(idx) for idx in inputs.minibatches()]  # this process's
        self.global_rows = inputs.global_rows()  # the global minibatch's
        self.phase = "warmup"
        self.snaps = {"losses": [], "m_after": [], "accum": {}}
        self.times, self.subjects = [], []
        self.deadline, self.close, self.stop_at = None, None, None
        self.attempted = self.failed = 0
        self.hold = False  # a traced run's window holds its whole stretch
        self._iteration, self._update = builder.iteration, builder.update_base_image
        builder.iteration = self.iteration
        builder.update_base_image = self.update_base_image

    def update_base_image(self, force=False):
        with torch.profiler.record_function("portbench::update_base_image"):
            return self._update(force)

    def iteration(self, batch_index, staged=None):
        if self.phase == "window":
            self.attempted += 1
        with torch.profiler.record_function("portbench::iteration"):
            try:
                out = self._iteration(batch_index, staged)
            except Exception:
                self.failed += 1
                raise
        t = time.perf_counter()
        if not all(np.isfinite(out)):
            self.failed += 1
        if self.phase == "warmup":
            self._snapshot(batch_index, out)
        elif self.phase == "window":
            self.subjects.append(self.global_rows[batch_index])
            self._tick(t)
        return out

    def _snapshot(self, bi, out):
        """Keep what the followed iterations produced, on the host in the
        program's precision (a copy in float64 on the device would raise
        the peak)."""
        b, s = self.b, self.snaps
        s["losses"].append(float(out[0]))
        k = len(s["losses"])
        if k <= check.FOLLOWED:
            m = b.ms[bi]  # the device tensor, or the host array when streamed
            m = m.detach().cpu() if isinstance(m, torch.Tensor) else torch.from_numpy(np.array(m))
            s["m_after"].append(m[:self.rows[bi]])
        if k in (1, check.FOLLOWED):
            s["accum"][k] = b._image_grad_accum.detach().cpu()
        if k == 1:
            self.first_return = time.perf_counter()

    def start(self, seconds):
        self.phase = "window"
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + seconds

    def _tick(self, t):
        self.times.append(t)
        done = len(self.times)
        if self.rank == 0 and self.close is None and t >= self.deadline and not self.hold:
            # every rank stops at the same iteration: the others see the
            # mark at their next return at the latest, since that return
            # waits on rank 0's next all-reduce
            self.close = done
            self.stop_at = done + (2 if self.world > 1 else 0)
            for fd in self.stop_fds:
                os.write(fd, str(self.stop_at).encode() + b"\n")
        elif self.rank > 0 and self.stop_at is None:
            try:
                data = os.read(self.stop_fds[0], 64)
            except BlockingIOError:
                data = b""
            if data:
                self.stop_at = int(data.split()[0])
        if self.stop_at is not None and done >= self.stop_at:
            self.phase = "after"
            raise StopWindow


def _fallback_counter(lddmm):
    """Count the iterations whose hoisted shooting re-ran the general
    integration (``profile_atlas.py``'s wrapper, commit 7d81de2)."""
    general = lddmm._expmap_general
    count = [0]

    def counted(*a, **kw):
        count[0] += 1
        return general(*a, **kw)

    lddmm._expmap_general = counted
    return count, general


def build_builder(lt, cfg, traffic, inputs, device, image_dtype=None):
    """The builder of the cell's configuration over ``inputs``, resuming
    from their atlas and momenta, on the traffic's data path, initialised."""
    items, ms = {}, []
    for idx in inputs.minibatches():
        m = []
        for blk in inputs.blocks(idx):
            img = inputs.images(blk).cpu().numpy()
            for k, i in enumerate(blk):
                items[i] = img[k]
            m.append(inputs.momenta(blk).cpu().numpy())
        ms.append(np.concatenate(m))
    builder = lt.LDDMMAtlasBuilder(
        Subjects(inputs.n, items), I0=inputs.atlas().cpu().numpy(), ms=ms, num_epochs=1,
        batch_size=int(cfg["batch_size"]), lddmm_steps=int(cfg["lddmm_steps"]),
        lddmm_integration_steps=int(cfg["lddmm_integration_steps"]),
        image_update_freq=int(cfg["image_update_freq"]), reg_weight=float(cfg["reg_weight"]),
        learning_rate_pose=float(cfg["learning_rate_m"]),
        learning_rate_image=float(cfg["learning_rate_I"]),
        metric=lt.FluidMetric((cfg["fluid_alpha"], cfg["fluid_beta"], cfg["fluid_gamma"])),
        momentum_preconditioning=bool(cfg["precondition_momentum"]),
        gradient_checkpointing=bool(cfg["gradient_checkpointing"]),
        keep_data_on_device=bool(traffic.get("keep_data_on_device", True)),
        loader_workers=int(traffic.get("loader_workers", 0)),
        loader_mode=str(traffic.get("loader_mode", "thread")),
        image_dtype=image_dtype, device=device, progress_bar=False,
        dtype=np.dtype(cfg["dtype"]))
    builder.initialize()
    return builder


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rank(cfg, traffic, seed, seconds, trace, device, rank=0, world=1, stop_fds=(),
             t_start=None, plant=None):
    """One process's part of a run.  Returns its statistics (a dict):
    the window's iteration times, set-up seconds, peak memory, the traced
    stretch's events, fallbacks, and the comparison's readings.  ``plant``:
    a fault (:mod:`.faults`) planted in the program, for the control."""
    t_start = time.perf_counter() if t_start is None else t_start
    import lagomorph_tpu_torch as lt
    from lagomorph_tpu_torch import lddmm

    if device.type == "cuda":
        from lagomorph_tpu_torch.ops.kernels import _build

        _build.library()
    marks = {"imported": time.perf_counter()}
    fault = plant() if plant is not None else None
    inputs = Inputs(cfg, traffic, seed, rank, world, device)
    builder = build_builder(lt, cfg, traffic, inputs, device,
                            image_dtype=getattr(fault, "image_dtype", None))
    if fault is not None:
        fault.apply(builder)
    probe = Probe(builder, inputs, rank, world, stop_fds)
    fallbacks, general = _fallback_counter(lddmm)
    try:
        marks["built"] = time.perf_counter()  # inputs made, copied to the host, builder built
        builder._epoch = 0
        builder.epoch()  # warm-up: every shape of the cell, and the followed steps
        probe.snaps["I1"] = builder.I.detach().cpu()
        marks["first_iteration"] = probe.first_return
        if trace:  # the profiler's own start-up belongs to set-up
            _Stretch(device, probe).stop(export=False)
        _sync(device)
        t_window = marks["warm"] = time.perf_counter()
        fallbacks[0] = 0
        stretch = None
        probe.start(seconds)
        probe.hold = bool(trace)
        epoch = 0
        try:
            while True:
                if trace and epoch == 1:
                    stretch = _Stretch(device, probe)
                if stretch is not None and epoch == 1 + int(traffic["trace_epochs"]):
                    stretch.stop()
                    probe.hold = False
                builder._epoch = 1 + epoch
                builder.epoch()
                epoch += 1
        except StopWindow:
            pass
        _sync(device)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        stats = {
            "rank": rank, "setup_s": t_window - t_start, "t0": probe.t0,
            "times": probe.times, "subjects": probe.subjects, "close": probe.close,
            "attempted": probe.attempted,
            # the rows each step computes: a process's own, or padded to the batch
            "rows": probe.rows if world == 1 else [inputs.batch] * len(probe.global_rows),
            "failed": probe.failed, "memory_peak_bytes": int(peak), "fallbacks": fallbacks[0],
            "setup_marks": {k: v - t_start for k, v in marks.items()},
        }
        if stretch is not None:
            stats["trace"] = stretch.events()
        snaps = probe.snaps
    finally:
        lddmm._expmap_general = general
        if fault is not None:
            fault.undo()
    # the program's state is freed before the reference runs
    builder.close_loaders()  # a streamed traffic's staging threads and workers
    del builder, probe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    stats["checks"] = check.readings(cfg, inputs, snaps, rank, world)
    stats["reference_s"] = time.perf_counter() - t_ref
    return stats


class _Stretch:
    """``torch.profiler`` over whole epochs of the window, fenced by device
    synchronisations (inside ``portbench::fence`` spans, which the readers
    leave out)."""

    def __init__(self, device, probe):
        from torch.profiler import ProfilerActivity, profile

        self.device, self.probe = device, probe
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        _sync(device)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.i0 = len(probe.times)
        self.t0 = time.perf_counter()
        self.path = None

    def stop(self, export=True):
        with torch.profiler.record_function("portbench::fence"):
            _sync(self.device)
        self.t1 = time.perf_counter()
        self.i1 = len(self.probe.times)
        self.prof.stop()
        if export:
            import tempfile

            fd, self.path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
            os.close(fd)
            self.prof.export_chrome_trace(self.path)
        self.prof = None

    def events(self):
        from .tracing import load_trace

        try:
            ev = load_trace(self.path)
        finally:
            os.remove(self.path)
        ev["iterations"] = self.i1 - self.i0
        ev["window_s"] = self.t1 - self.t0
        ev["first"], ev["last"] = self.i0, self.i1  # the window's iterations it spans
        return ev
