"""The readers of the program's spans (``lt.*``, from
``lagomorph_tpu_torch.profiling.span``) on a synthetic trace, checked by
hand: ``host_reads_per_iter``, ``read_idle_ms_per_iter`` and
``host_issue_ms_per_iter``; each reads nothing from a trace without the
program's spans, as a program without them leaves."""
import json

import pytest

from portbench import manifest, report, tracing

READERS = ("host_reads_per_iter", "read_idle_ms_per_iter", "host_issue_ms_per_iter")

DEVICE = [
    {"ph": "X", "cat": "kernel", "name": "void lagomorph::k1(float)", "ts": 100, "dur": 100},
    {"ph": "X", "cat": "kernel", "name": "at::native::add", "ts": 300, "dur": 50},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 400, "dur": 10},
    {"ph": "X", "cat": "kernel", "name": "void lagomorph::k2(float)", "ts": 600, "dur": 100},
    {"ph": "X", "cat": "kernel", "name": "at::native::mul", "ts": 900, "dur": 50},
]
# the harness's spans around the program's: two iterations, [50, 500] and
# [550, 1000]; device gaps [200, 300], [350, 400], [410, 600], [700, 900]
HARNESS = [
    {"ph": "X", "cat": "user_annotation", "name": "portbench::iteration", "ts": 40, "dur": 470},
    {"ph": "X", "cat": "user_annotation", "name": "portbench::iteration", "ts": 540, "dur": 470},
]
PROGRAM = [
    {"ph": "X", "cat": "user_annotation", "name": "lt.iteration", "ts": 50, "dur": 450},
    {"ph": "X", "cat": "user_annotation", "name": "lt.step", "ts": 60, "dur": 300},
    # a read whose gap opens inside it ([200, 300] opens at 200): counts
    {"ph": "X", "cat": "user_annotation", "name": "lt.read.flag", "ts": 150, "dur": 100},
    # the gap [350, 400] opens at 350, before this read starts: does not count
    {"ph": "X", "cat": "user_annotation", "name": "lt.read.loss", "ts": 360, "dur": 30},
    # [410, 600] opens at 410 inside this read: counts whole
    {"ph": "X", "cat": "user_annotation", "name": "lt.read.reg", "ts": 400, "dur": 20},
    {"ph": "X", "cat": "user_annotation", "name": "lt.iteration", "ts": 550, "dur": 450},
    # [700, 900] opens at 700, after this read ends: does not count
    {"ph": "X", "cat": "user_annotation", "name": "lt.read.tier", "ts": 620, "dur": 70},
    # a read on another thread overlapping the one above: the union counts
    {"ph": "X", "cat": "user_annotation", "name": "lt.read.tier", "ts": 650, "dur": 45},
    {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 410, "dur": 5},
]


def _ctx(tmp_path, events):
    path = tmp_path / "t.json"
    json.dump({"traceEvents": events}, open(path, "w"))
    tr = tracing.load_trace(str(path))
    tr.update(iterations=2, window_s=1000e-6, first=1, last=3)
    stats = {"fallbacks": 0, "t0": 0.0, "close": 4, "rows": [2],
             "times": [0.001, 0.002, 0.003, 0.004]}
    return report.Context(dict(stats, trace=tr), {})


def test_host_reads_count_the_read_spans(tmp_path):
    ctx = _ctx(tmp_path, DEVICE + HARNESS + PROGRAM)
    assert manifest.reader("host_reads_per_iter")(ctx) == 5 / 2


def test_read_idle_counts_only_gaps_that_open_in_a_read(tmp_path):
    ctx = _ctx(tmp_path, DEVICE + HARNESS + PROGRAM)
    # [200, 300] (in lt.read.flag) and [410, 600] (in lt.read.reg)
    assert manifest.reader("read_idle_ms_per_iter")(ctx) == pytest.approx((100 + 190) * 1e-3 / 2)


def test_host_issue_subtracts_the_reads_from_the_iterations(tmp_path):
    ctx = _ctx(tmp_path, DEVICE + HARNESS + PROGRAM)
    # first iteration 450 less 100 + 30 + 20; second 450 less [620, 695]
    assert manifest.reader("host_issue_ms_per_iter")(ctx) == pytest.approx(
        ((450 - 150) + (450 - 75)) * 1e-3 / 2)


def test_a_read_span_straddling_an_iteration_counts_its_inside(tmp_path):
    events = DEVICE + [
        {"ph": "X", "cat": "user_annotation", "name": "lt.iteration", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "lt.read.flag", "ts": 180, "dur": 50},
    ]
    ctx = _ctx(tmp_path, events)
    assert manifest.reader("host_issue_ms_per_iter")(ctx) == pytest.approx(80e-3 / 2)


def test_nothing_to_read_without_the_programs_spans(tmp_path):
    ctx = _ctx(tmp_path, DEVICE + HARNESS)
    for name in READERS:
        assert manifest.reader(name)(ctx) is None
    ctx = report.Context({"fallbacks": 0}, {})
    for name in READERS:
        assert manifest.reader(name)(ctx) is None
    # spans but no device operation: no idle to read
    ctx = _ctx(tmp_path, HARNESS + PROGRAM)
    assert manifest.reader("read_idle_ms_per_iter")(ctx) is None
    assert manifest.reader("host_reads_per_iter")(ctx) == 5 / 2
