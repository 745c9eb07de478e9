"""The ``beta != 0`` 2D atlas (``lddmm2d_512_beta``) and what reads it, on
the CPU:

* the port's atlas step at ``(0.1, 0.05, 0.01)`` against the float64
  reference (its loss, ``m - lr dL/dm`` and ``dL/dI``) at 32^2 b2 and
  16^3 b2, on the benchmark's inputs;
* a tiny cell of the configuration through ``run.py --device cpu``, traced
  and not: correct, and the new readers, which find no device operation on
  the CPU, leave their metrics out without raising;
* the new work functions against counts by hand;
* the readers ``substep2d_fwd_roofline``, ``substep2d_bwd_roofline`` and
  ``substep_idle_ms_per_iter`` on a synthetic trace.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import lagomorph_tpu_torch as lt
from conftest import PB, ROOT
from lagomorph_tpu_torch import lddmm
from portbench import manifest, report, tracing
from portbench.inputs import Inputs
from portbench.reference import atlas as ref

torch.set_num_threads(2)
F64 = torch.float64
TOL = 1e-10  # float64, relative to the largest value: FFTs and sums round differently
BETA = (0.1, 0.05, 0.01)


def close(a, b, tol=TOL):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= tol * max(scale, 1e-300), (
        float((a - b).abs().max()), scale)


@pytest.mark.parametrize("shape", [(32, 32), (16, 16, 16)])
def test_atlas_step_beta(shape):
    """The step's loss, ``m - lr dL/dm`` and ``dL/dI`` in float64 with the
    grad-div coupling, as ``test_pb_reference.py::test_atlas_step`` holds
    them at ``beta = 0``."""
    cfg = {"shape": list(shape), "batch_size": 2, "fluid_alpha": BETA[0],
           "fluid_beta": BETA[1], "fluid_gamma": BETA[2]}
    traffic = {"subjects": 2, "offset": 2.0, "bumps": 4, "vmax": 0.5}
    inp = Inputs(cfg, traffic, 2**33 + 11, 0, 1, torch.device("cpu"))
    m, img = inp.momenta([0, 1]).to(F64), inp.images([0, 1]).to(F64)
    I = inp.atlas().to(F64)
    reg, lr = 0.1, 1e-3
    step = lddmm.make_lddmm_atlas_step(lt.FluidMetric(BETA), reg_weight=reg,
                                       learning_rate_pose=lr, integration_steps=5)
    m_new, gI, loss, _ = step(I, m, img)
    numel = 2 * float(np.prod(shape))
    mine = ref.FluidMetric(BETA, shape, "cpu")
    sq, vm, gm = ref.momenta_grad(mine, I, m, img, 5, reg, numel)
    close(loss, (sq + reg * vm) / numel)
    close(m_new - m, -lr * gm)
    _, _, g_sq = ref.atlas_grad_sq(mine, I, m, img, 5)
    close(gI, g_sq / numel)


# The tiny cell's limits, set as the cells' are: above the largest reading
# of the sound program over 8 seeds on the CPU (loss 1.3e-7, grad and change
# 2.0e-5, atlas 1.8e-6) and below the bfloat16 control's smallest over 3
# (3.9e-4, 5.2e-4, 5.1e-4, 2.8e-3), which fails all four; half of each
# minibatch left out reads 0.34, 1.0, 1.0, 0.75.
TINY = {"shape": [32, 32], "batch_size": 4, "learning_rate_m": 1e-5, "learning_rate_I": 100.0}
TINY_LIMITS = {"loss": 1.5e-5, "grad": 2e-4, "change": 2e-4, "atlas": 2e-4}
NEW = ("substep2d_fwd_roofline", "substep2d_bwd_roofline", "substep_idle_ms_per_iter")


@pytest.fixture(scope="module")
def beta_checkout(tmp_path_factory):
    """A copy of the benchmark beside a link to the port, with the tiny
    cell ``tiny2d_beta.one``, which reports what ``lddmm2d_512_beta.
    resident`` reports."""
    root = tmp_path_factory.mktemp("beta")
    shutil.copytree(PB, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "lagomorph_tpu_torch"), root / "lagomorph_tpu_torch")
    cfg = dict(manifest.config("lddmm2d_512_beta"), name="tiny2d_beta", **TINY)
    wl = {"config": "tiny2d_beta", "chips": 1, "why": "a test", "limits": TINY_LIMITS,
          "traffic": {"subjects": 12, "offset": 2.0, "bumps": 4, "vmax": 0.5, "trace_epochs": 1}}
    json.dump(cfg, open(root / "portbench" / "configs" / "tiny2d_beta.json", "w"))
    json.dump(wl, open(root / "portbench" / "workloads" / "tiny2d_beta.one.json", "w"))
    bench = manifest.benchmark()
    bench["workloads"].append({"name": "tiny2d_beta.one", "config": "tiny2d_beta",
                               "traffic": "one", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells = m.get("workloads", [])
        if "lddmm2d_512_beta.resident" in cells:
            cells.append("tiny2d_beta.one")
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_beta_cell_runs_correct(beta_checkout, trace):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tiny2d_beta.one",
                        "--seed", str(2**31 + 4242), "--seconds", "0.5", "--trace", str(trace),
                        "--device", "cpu"], cwd=beta_checkout, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res["checks"]
    if trace:  # no device operation on the CPU: nothing to read, and no raise
        assert not set(NEW) & set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"subjects_per_s", "iter_ms_p95", "peak_mem_gib",
                                       "setup_s"}


CFG2 = {"shape": [4, 4], "batch_size": 2, "lddmm_integration_steps": 5}
N, V = 2, 16
F2 = 4 * 2 * N * V  # bytes of a 2-channel field of 2 subjects on 4^2: 256
# per pixel: the 2D warp's two axes of weights (18), 9 tap weights and 17
# products and sums per channel (34): 61; K10 adds 14 and half the flag's 8,
# K11 adds 4 and 4; the backwards' transposed warp 63 and weight gradient 117
HAND = [
    ("adstar2d_fwd", 4 * F2, N * V * (61 + 14 + 4)),
    ("compose2d_fwd", 3 * F2, N * V * (61 + 4 + 4)),
    ("adstar2d_bwd", 6 * F2, N * V * (63 + 117 + 36)),
    ("compose2d_bwd", 5 * F2, N * V * (63 + 117 + 4)),
    # field in and out (2 x 256), 3 multiplier entries on the 4 x 3 half
    # spectrum; 4 real FFTs of 16 points each way (2.5 x 16 x 4 each), 12
    # operations per half-spectrum frequency of each subject
    ("fluid_solve_coupled", 2 * F2 + 4 * 3 * 12, 2 * 4 * 160 + N * 12 * 12),
]


@pytest.mark.parametrize("name,nbytes,ops", HAND, ids=[h[0] for h in HAND])
def test_work_by_hand(name, nbytes, ops):
    assert manifest.work(name)(CFG2) == (nbytes, ops)


def test_coupled_solve_counts_the_fft_as_the_packed_solve():
    """Its transforms' operations are the packed solve's (``N d / 2``
    complex pairs, two FFTs each), with the mix for the pairs' product."""
    cfg = dict(CFG2, shape=[8, 8])
    _, ops = manifest.work("fluid_solve_coupled")(cfg)
    _, packed = manifest.work("fluid_solve")(cfg)
    V8 = 64
    assert ops - N * 8 * 5 * 12 == packed - 2 * 2 * V8


# two iterations; device: K10 on its strips, K11, a glue kernel, K12's
# tile kernel, K12's per-thread kernel and its d_m0 sum, K13
DEVICE = [
    {"ph": "X", "cat": "kernel", "ts": 100, "dur": 40,
     "name": "void lagomorph::(anonymous namespace)::ad_star2d_march_kernel<2>(float const*)"},
    {"ph": "X", "cat": "kernel", "ts": 150, "dur": 20,
     "name": "void lagomorph::(anonymous namespace)::compose2d_fwd_kernel(float const*)"},
    {"ph": "X", "cat": "kernel", "ts": 200, "dur": 30, "name": "at::native::mul"},
    {"ph": "X", "cat": "kernel", "ts": 400, "dur": 50,
     "name": "void lagomorph::(anonymous namespace)::ad_star2d_bwd_tile_kernel(float const*)"},
    {"ph": "X", "cat": "kernel", "ts": 500, "dur": 10,
     "name": "void lagomorph::(anonymous namespace)::ad_star2d_bwd_m0_kernel(float const*)"},
    {"ph": "X", "cat": "kernel", "ts": 520, "dur": 30,
     "name": "void lagomorph::(anonymous namespace)::compose2d_bwd_kernel(float const*)"},
]
# device gaps [140, 150], [170, 200], [230, 400], [450, 500], [510, 520]
SUBSTEPS = [
    # [140, 150] and [170, 200] open inside it: count
    {"ph": "X", "cat": "user_annotation", "name": "lt.substep", "ts": 90, "dur": 100},
    # [230, 400] opens at 230, after it ends: does not count
    {"ph": "X", "cat": "user_annotation", "name": "lt.substep", "ts": 195, "dur": 30},
    # [450, 500] opens at 450 inside it: counts whole
    {"ph": "X", "cat": "user_annotation", "name": "lt.substep", "ts": 440, "dur": 20},
    {"ph": "X", "cat": "user_annotation", "name": "lt.read.flag", "ts": 505, "dur": 20},
]
CFG = {"shape": [4, 4], "batch_size": 2, "lddmm_integration_steps": 5,
       "roofline": {"adstar2d_fwd": 4, "compose2d_fwd": 4, "adstar2d_bwd": 4,
                    "compose2d_bwd": 4, "fluid_solve_coupled": 10}}


def _ctx(tmp_path, events, cfg=CFG, rows=(2, 1)):
    path = tmp_path / "t.json"
    json.dump({"traceEvents": events}, open(path, "w"))
    tr = tracing.load_trace(str(path))
    tr.update(iterations=2, window_s=1000e-6, first=1, last=3)
    stats = {"fallbacks": 0, "t0": 0.0, "close": 4, "rows": list(rows),
             "times": [0.001, 0.002, 0.003, 0.004]}
    return report.Context(dict(stats, trace=tr), cfg)


def _need(functions):
    """The bounds a step of ``functions`` (4 calls each), over minibatches
    of 2 and 1, in ms."""
    return sum(4 * max(nb / 3.35e12, ops / 67e12) * 1e3
               for b in (2, 1) for f in functions
               for nb, ops in [manifest.work(f)(dict(CFG, batch_size=b))]) / 2


def test_substep_rooflines(tmp_path):
    ctx = _ctx(tmp_path, DEVICE + SUBSTEPS)
    fwd = _need(("adstar2d_fwd", "compose2d_fwd"))
    bwd = _need(("adstar2d_bwd", "compose2d_bwd"))
    # 60 us of K10 and K11, 90 of K12 and K13, over 2 iterations
    assert manifest.reader("substep2d_fwd_roofline")(ctx) == pytest.approx(
        100 * fwd / (60e-3 / 2))
    assert manifest.reader("substep2d_bwd_roofline")(ctx) == pytest.approx(
        100 * bwd / (90e-3 / 2))


def test_substep_idle_counts_only_gaps_that_open_in_a_substep(tmp_path):
    ctx = _ctx(tmp_path, DEVICE + SUBSTEPS)
    assert manifest.reader("substep_idle_ms_per_iter")(ctx) == pytest.approx(
        (10 + 30 + 50) * 1e-3 / 2)


def test_new_readers_find_nothing_to_read(tmp_path):
    # no K10-K13 (a beta == 0 step) and no lt.substep span (a program without it)
    glue = [e for e in DEVICE if "lagomorph" not in e["name"]]
    ctx = _ctx(tmp_path, glue + SUBSTEPS[3:])
    for name in NEW:
        assert manifest.reader(name)(ctx) is None
    ctx = report.Context({"fallbacks": 0}, CFG)  # untraced
    for name in NEW:
        assert manifest.reader(name)(ctx) is None
    ctx = _ctx(tmp_path, SUBSTEPS)  # spans, no device operation
    assert manifest.reader("substep_idle_ms_per_iter")(ctx) is None
