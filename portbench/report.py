"""From each process's statistics to the run's result line."""
from __future__ import annotations

from . import manifest
from .tracing import breakdown, busy_and_gaps


def untraced_iter_s(intervals, first, last):
    """The mean seconds an iteration of the window took outside the traced
    stretch, which spans the window's iterations ``first`` to ``last - 1``:
    every return-to-return interval but those the profiler ran in and the
    one after, which holds its stop.  None where no such interval is left."""
    rest = intervals[:first] + intervals[last + 1:]
    return sum(rest) / len(rest) if rest else None


class Context:
    """What a per-layer metric's reader gets: the traced stretch (``trace``:
    its device operations, host operations, iterations and seconds; None
    in an untraced run) and its device busy microseconds, the seconds an
    iteration of the window took untraced (``iter_s``), the window's
    fallbacks, the configuration, the subjects of each minibatch of an
    epoch (``rows``: the stretch holds whole epochs), and the work
    functions by name."""

    def __init__(self, stats, cfg):
        self.trace = stats.get("trace")
        self.fallbacks = stats["fallbacks"]
        self.cfg = cfg
        self.rows = stats.get("rows", [])
        self.work = manifest.work
        self.iter_s = None
        if self.trace is not None:
            self.busy_us, _ = busy_and_gaps(self.trace["device"])
            self.iter_s = untraced_iter_s(intervals(stats), self.trace["first"],
                                          self.trace["last"])

    def per_step(self, cost):
        """The mean over an epoch's minibatches of the configuration's
        ``roofline`` functions' ``cost(bytes, ops)`` a step, summed over
        their calls."""
        if not self.rows:
            return None
        total = 0.0
        for b in self.rows:
            cfg = dict(self.cfg, batch_size=b)
            total += sum(n * cost(*self.work(f)(cfg)) for f, n in self.cfg["roofline"].items())
        return total / len(self.rows)


def intervals(stats):
    """The window's return-to-return intervals (seconds), the first from
    the window's start."""
    times = stats["times"][:stats["close"]]
    return [b - a for a, b in zip([stats["t0"]] + times[:-1], times)]


def summarize(stats, cfg, per_layer):
    """One process's compact summary: the window (rank 0's), the per-layer
    metrics and breakdown of a traced run, busy and window seconds."""
    out = {k: stats[k] for k in ("rank", "setup_s", "attempted", "failed", "memory_peak_bytes",
                                 "checks", "fallbacks", "setup_marks", "reference_s")}
    if stats["rank"] == 0:
        times = stats["times"][:stats["close"]]
        out["window_s"] = times[-1] - stats["t0"]
        out["iterations"] = len(times)
        out["subjects"] = sum(stats["subjects"][:stats["close"]])
        out["intervals"] = intervals(stats)
    if "trace" in stats:
        ctx = Context(stats, cfg)
        values = {}
        for m in per_layer:
            v = manifest.reader(m["name"])(ctx)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        out["per_layer"] = values
        out["busy_s"] = ctx.busy_us * 1e-6
        out["traced_s"] = stats["trace"]["window_s"]
        out["breakdown"] = breakdown(stats["trace"])
        out["iter_s"] = {"traced": stats["trace"]["window_s"] / stats["trace"]["iterations"],
                         "untraced": ctx.iter_s}
    return out


class Run:
    """What an end-to-end metric's reader gets: rank 0's window (its
    iterations, the subjects of their global minibatches, their
    return-to-return intervals, its seconds), the peak memory of the
    fullest device and the set-up seconds."""

    def __init__(self, summaries):
        r0 = summaries[0]
        self.iterations, self.intervals = r0["iterations"], r0["intervals"]
        self.subjects = r0["subjects"]
        self.window_s, self.setup_s = r0["window_s"], r0["setup_s"]
        self.memory_peak_bytes = max(s["memory_peak_bytes"] for s in summaries)
