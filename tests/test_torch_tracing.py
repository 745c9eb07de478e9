"""The port's spans and counters (``profiling.span``), on the CPU:

* ``span`` with no profiler recording is one shared null context and still
  counts; ``add`` counts what is not a span;
* a traced epoch of a tiny atlas builder (16³ b2, 32² b4) holds every span
  of the path it takes, each nested in its parent, four host reads
  (``lt.read.*``) an iteration on the fast path, four ``lt.substep`` a
  shoot on the 3D per-substep path (the 2D ``beta == 0`` shoot is one
  launch of K8, without them), and ``counters()`` agrees with the trace,
  the staged bytes included;
* momenta that leave the unit regime trip the shooting's flag: one
  ``lt.shoot.general`` an iteration;
* ``Timer``'s sections are spans;
* the counts lose nothing when threads count at once.
"""
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import profiling

torch.set_num_threads(2)

PARAMS = (0.1, 0.0, 0.01)
READS = ("lt.read.flag", "lt.read.tier", "lt.read.loss", "lt.read.reg")
# each span of the builder's fast path, and the span it lies in
PARENT = {
    "lt.stage": "lt.iteration", "lt.step": "lt.iteration", "lt.loss": "lt.step",
    "lt.shoot": "lt.loss", "lt.read.flag": "lt.shoot", "lt.substep": "lt.shoot",
    "lt.warp": "lt.loss",
    "lt.read.tier": "lt.warp", "lt.backward": "lt.step", "lt.descend": "lt.step",
    "lt.read.loss": "lt.iteration", "lt.read.reg": "lt.iteration",
}
CASES = {"3d": ((16, 16, 16), 2, 5), "2d": ((32, 32), 4, 10)}  # shape, batch, subjects


def _builder(shape, batch, n, vmax, seed=0):
    """A builder over ``n`` blobs, resuming from momenta whose velocities
    peak at ``vmax`` voxels (0.5: the fast path; 3: a tripped flag)."""
    rng = np.random.default_rng(seed)
    dim = len(shape)
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                                indexing="ij"))
    centre = (np.asarray(shape, dtype=np.float64) - 1) / 2
    imgs = []
    for _ in range(n):
        c = centre + rng.uniform(-1, 1, dim)
        r2 = sum((grid[a] - c[a]) ** 2 for a in range(dim))
        imgs.append(np.exp(-r2 / (2 * (shape[0] / 6) ** 2))[None].astype(np.float32))
    metric = lt.FluidMetric(PARAMS)
    ms = []
    for i in range(0, n, batch):
        m = rng.standard_normal((min(batch, n - i), dim) + shape)
        v = metric.sharp(torch.from_numpy(m))
        ms.append((m * (vmax / float(v.norm(dim=1).max()))).astype(np.float32))
    b = lt.LDDMMAtlasBuilder(imgs, I0=np.mean(imgs, axis=0), ms=ms, num_epochs=1,
                             batch_size=batch, learning_rate_pose=1e-5,
                             learning_rate_image=100.0, reg_weight=0.1, metric=metric,
                             device="cpu", progress_bar=False)
    b.initialize()
    return b


def _traced_epoch(builder, tmp_path):
    """The ``lt.`` spans of one traced epoch (``[name, ts, end, tid]``) and
    the counters it left."""
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        builder.epoch()
    path = str(tmp_path / "epoch.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [[e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid")]
             for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("lt.")]
    return spans, profiling.counters()


def _inside(child, parents, slack=0.01):
    return any(p[3] == child[3] and p[1] - slack <= child[1] and child[2] <= p[2] + slack
               for p in parents)


def test_span_without_profiler_is_one_null_context_and_counts():
    profiling.reset_counters()
    a, b = profiling.span("lt.a"), profiling.span("lt.b")
    assert a is b
    with profiling.span("lt.a"):
        pass
    profiling.add("lt.a.bytes", 5)
    profiling.add("lt.a.bytes", 3)
    assert profiling.counters() == {"lt.a": 2, "lt.b": 1, "lt.a.bytes": 8}
    c = profiling.counters()
    c["lt.a"] = 0
    assert profiling.counters()["lt.a"] == 2
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_span_records_while_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]):
        s = profiling.span("lt.x")
    assert isinstance(s, torch.profiler.record_function)
    assert profiling.span("lt.x") is profiling.span("lt.y")


@pytest.mark.parametrize("case", sorted(CASES))
def test_traced_epoch_holds_the_spans(case, tmp_path):
    shape, batch, n = CASES[case]
    b = _builder(shape, batch, n, vmax=0.5)
    iters = -(-n // batch)
    spans, counts = _traced_epoch(b, tmp_path)
    names = {s[0] for s in spans}
    dim = len(shape)
    substeps = {"lt.substep"} if dim == 3 else set()  # 2D beta == 0: K8's one launch
    assert names == set(PARENT) - {"lt.substep"} | substeps | {"lt.iteration",
                                                               "lt.update_atlas"}
    by = {k: [s for s in spans if s[0] == k] for k in names}
    for child, parent in PARENT.items():
        for s in by.get(child, []):
            assert _inside(s, by[parent]), (child, parent)
    assert counts.get("lt.substep", 0) == (4 * iters if dim == 3 else 0)
    assert len(by["lt.iteration"]) == iters and len(by["lt.update_atlas"]) == 1
    for it in by["lt.iteration"]:
        reads = [s for s in spans if s[0].startswith("lt.read.") and _inside(s, [it])]
        assert sorted(s[0] for s in reads) == sorted(READS)
    assert sum(s[0].startswith("lt.read.") for s in spans) == 4 * iters
    # the counters count every entry, the trace's spans among them
    for k in names:
        assert counts[k] == len(by[k]), k
    assert counts["lt.stage.bytes"] == 4 * n * (1 + dim) * int(np.prod(shape))
    assert "lt.shoot.general" not in counts and "lt.allsum" not in counts


@pytest.mark.parametrize("case", sorted(CASES))
def test_tripped_flag_reruns_the_general_shooting(case, tmp_path):
    shape, batch, n = CASES[case]
    b = _builder(shape, batch, n, vmax=3.0)
    iters = -(-n // batch)
    spans, counts = _traced_epoch(b, tmp_path)
    general = [s for s in spans if s[0] == "lt.shoot.general"]
    assert len(general) == iters == counts["lt.shoot.general"]
    shoots = [s for s in spans if s[0] == "lt.shoot"]
    for it in (s for s in spans if s[0] == "lt.iteration"):
        assert sum(_inside(g, [it]) for g in general) == 1
    assert all(_inside(g, shoots) for g in general)


def test_timer_sections_are_spans(tmp_path):
    profiling.reset_counters()
    tm = profiling.Timer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with tm("lt.test.data"):
                torch.ones(4).sum()
    path = str(tmp_path / "timer.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("lt.test.data") == 2
    assert profiling.counters()["lt.test.data"] == 2 == tm.summary()["lt.test.data"]["count"]


def test_counts_from_many_threads_lose_nothing():
    profiling.reset_counters()
    n, per = 8, 5000

    def work():
        for _ in range(per):
            with profiling.span("lt.test.stage"):
                profiling.add("lt.test.bytes", 3)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters() == {"lt.test.stage": n * per, "lt.test.bytes": 3 * n * per}
