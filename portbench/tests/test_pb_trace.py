"""The trace arithmetic on a synthetic Chrome trace: the device's busy time
as the union of its operations, its idle gaps and the host operation that
spans each, the breakdown, and the per-layer readers."""
import json

import pytest

from portbench import manifest, report, tracing

EVENTS = [
    # device: a kernel of the port, an overlapping glue kernel, a copy, NCCL
    {"ph": "X", "cat": "kernel", "name": "void lagomorph::k1(float)", "ts": 100, "dur": 50},
    {"ph": "X", "cat": "kernel", "name": "at::native::add", "ts": 120, "dur": 60},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 300, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce", "ts": 400, "dur": 100},
    # host: an iteration spanning everything, a sync inside the first gap,
    # the closing fence, whose sync and the one after it the counter leaves out
    {"ph": "X", "cat": "user_annotation", "name": "portbench::iteration", "ts": 50, "dur": 600},
    {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 170, "dur": 140},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 200, "dur": 100},
    {"ph": "X", "cat": "user_annotation", "name": "portbench::fence", "ts": 600, "dur": 20},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 605, "dur": 10},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize", "ts": 700, "dur": 10},
    {"ph": "i", "cat": "kernel", "name": "an instant", "ts": 0},
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    json.dump({"traceEvents": EVENTS}, open(path, "w"))
    tr = tracing.load_trace(str(path))
    tr.update(iterations=2, window_s=1000e-6, first=1, last=3)
    return tr


def test_load_and_busy(trace):
    assert [e[0] for e in trace["device"]] == ["void lagomorph::k1(float)", "at::native::add",
                                               "Memcpy DtoH", "ncclDevKernel_AllReduce"]
    busy, gaps = tracing.busy_and_gaps(trace["device"])
    assert busy == 80 + 10 + 100  # [100, 180], [300, 310], [400, 500]
    assert gaps == [(180, 300), (310, 400)]
    assert tracing.host_spans(trace["host"], gaps) == ["aten::item", "portbench::iteration"]


def test_breakdown(trace):
    b = tracing.breakdown(trace)
    assert b["device_ops"][0] == ["ncclDevKernel_AllReduce", pytest.approx(100e-6)]
    assert dict(b["idle_gaps"]) == {"aten::item": pytest.approx(120e-6),
                                    "portbench::iteration": pytest.approx(90e-6)}


# the window: iterations 1 and 2 traced (0.6 ms each), 3 holds the
# profiler's stop, the rest 0.4 ms
STATS = {"fallbacks": 3, "t0": 0.0, "close": 6, "rows": [2, 1],
         "times": [0.0004, 0.0010, 0.0016, 0.0030, 0.0034, 0.0038, 0.0042]}


def _ctx(trace, cfg=None):
    return report.Context(dict(STATS, trace=trace), cfg or {})


def test_untraced_iteration():
    assert report.intervals(STATS) == pytest.approx([4e-4, 6e-4, 6e-4, 1.4e-3, 4e-4, 4e-4])
    assert _ctx(None).iter_s is None
    assert report.untraced_iter_s([1.0, 2.0, 2.0, 9.0, 1.0], 1, 3) == 1.0
    assert report.untraced_iter_s([2.0, 2.0], 0, 1) is None


def test_readers(trace):
    ctx = _ctx(trace)
    assert manifest.reader("host_syncs_per_iter")(ctx) == 0.5  # one of two, per 2 iterations
    assert manifest.reader("glue_ms_per_iter")(ctx) == pytest.approx((60 + 10 + 100) * 1e-3 / 2)
    # busy 95 us an iteration over the untraced 400 us
    assert manifest.reader("device_idle_share")(ctx) == pytest.approx(100 * (1 - 95 / 400))
    assert manifest.reader("fallbacks")(ctx) == 3.0


def test_rooflines(trace):
    cfg = {"shape": [4, 4, 4], "batch_size": 2, "lddmm_integration_steps": 5,
           "roofline": {"compose_fwd": 2}}
    ctx = _ctx(trace, cfg)
    # an epoch of a minibatch of 2 and one of 1: the work averaged over both
    work = [manifest.work("compose_fwd")(dict(cfg, batch_size=b)) for b in (2, 1)]
    need = sum(2 * max(nb / 3.35e12, ops / 67e12) * 1e3 for nb, ops in work) / 2
    busy_ms_per_iter = 190e-3 / 2
    assert manifest.reader("step_roofline")(ctx) == pytest.approx(100 * need / busy_ms_per_iter)
    ops = sum(2 * ops for _, ops in work) / 2
    assert manifest.reader("step_mfu")(ctx) == pytest.approx(100 * ops / (67e12 * 400e-6))


def test_readers_find_nothing_to_read():
    ctx = report.Context({"fallbacks": 0}, {})
    for name in ("host_syncs_per_iter", "glue_ms_per_iter", "device_idle_share",
                 "step_roofline", "step_mfu"):
        assert manifest.reader(name)(ctx) is None
    empty = {"device": [], "host": [], "iterations": 2, "window_s": 1.0, "first": 1, "last": 3}
    ctx = _ctx(empty)
    for name in ("step_roofline", "step_mfu", "device_idle_share"):
        assert manifest.reader(name)(ctx) is None


def test_end_to_end_readers():
    summaries = [{"iterations": 4, "subjects": 30, "intervals": [0.010] * 19 + [0.050],
                  "window_s": 0.25, "setup_s": 7.5, "memory_peak_bytes": 2**30},
                 {"memory_peak_bytes": 3 * 2**30}]
    run = report.Run(summaries)
    assert manifest.reader("subjects_per_s")(run) == 30 / 0.25
    assert manifest.reader("peak_mem_gib")(run) == 3.0
    assert manifest.reader("setup_s")(run) == 7.5
    # statistics.quantiles(n=20)'s last cut of 19 tens and one fifty
    assert manifest.reader("iter_ms_p95")(run) == pytest.approx(48.0)
