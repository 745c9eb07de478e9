"""Reading a ``torch.profiler`` Chrome trace: the device's operations, the
host's operations and runtime calls, the device's busy time as the union
of its operations' intervals, its idle gaps, and the breakdown the result
line carries.

``device_ops`` and the busy-union loop are frozen copies of
``chip_smoke.py``'s ``device_events`` and ``trace_run`` (commit 7d81de2).
"""
from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def device_ops(events):
    """The device's kernels, copies and sets among ``events``, by start."""
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                  key=lambda e: e["ts"])


def load_trace(path):
    """``{"device": [[name, ts_us, dur_us], ...], "host": [[cat, name, ts_us,
    dur_us], ...]}`` of the Chrome trace at ``path``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [[e["name"], float(e["ts"]), float(e["dur"])] for e in device_ops(events)]
    host = sorted(([e["cat"], e["name"], float(e["ts"]), float(e.get("dur", 0.0))]
                   for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS),
                  key=lambda e: e[2])
    return {"device": dev, "host": host}


def busy_and_gaps(dev):
    """``(busy_us, [(start_us, end_us), ...])``: the union of the device
    operations' intervals, and the idle gaps between them."""
    if not dev:
        return 0.0, []
    busy, gaps, end = 0.0, [], dev[0][1]
    for _, start, dur in dev:
        stop = start + dur
        if start > end:
            gaps.append((end, start))
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy, gaps


def host_spans(host, gaps):
    """For each gap ``(t0, t1)`` (sorted, disjoint), the name of the
    shortest host operation that spans it (what the host was doing while
    the device idled), or ``"host idle"``: one sweep over ``host``, sorted
    by start."""
    names, active, k = [], [], 0
    for t0, t1 in gaps:
        while k < len(host) and host[k][2] <= t0:
            active.append(host[k])
            k += 1
        # an operation that ends before this gap ends spans no later gap
        active = [e for e in active if e[2] + e[3] >= t1]
        best = min(active, key=lambda e: e[3], default=None)
        names.append(best[1] if best else "host idle")
    return names


def breakdown(trace, top=10):
    """The device operations that took most time and the longest idle
    gaps summed by the host operation that spans them, in seconds."""
    per = {}
    for name, _, dur in trace["device"]:
        per[name] = per.get(name, 0.0) + dur * 1e-6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    _, gaps = busy_and_gaps(trace["device"])
    by_host = {}
    for (t0, t1), name in zip(gaps, host_spans(trace["host"], gaps)):
        by_host[name] = by_host.get(name, 0.0) + (t1 - t0) * 1e-6
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in idle]}
