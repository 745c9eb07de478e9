"""Fixtures of the benchmark's tests: tiny cells, and a copy of the
checkout (the benchmark's files, ``BENCHMARK.json`` with the tiny cells
added, and a link to the port) for running ``run.py`` as the driver does."""
import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TRAFFIC = {"offset": 2.0, "bumps": 4, "vmax": 0.5, "trace_epochs": 1}
# the cells' configurations at a size the CPU holds; the learning rates are
# cut with the grid so that the momenta stay in the fast path's regime
TINY = {
    "tiny3d": ("lddmm3d_128", {"shape": [16, 16, 16], "batch_size": 2,
                               "learning_rate_m": 1e-5, "learning_rate_I": 100.0}, 6),
    "tiny2d": ("lddmm2d_512", {"shape": [32, 32], "batch_size": 4,
                               "learning_rate_m": 1e-5, "learning_rate_I": 100.0}, 12),
}


# The tiny cells' limits, set as the cells' are (above the largest reading
# of the sound program over 8 seeds on the CPU, below the bfloat16 control's
# smallest over 3 where that is 3 times the largest or more): the loss and
# the atlas as the cells' (tiny readings: loss 1.5e-7 and 1.2e-7, control
# 2.1e-4 and 3.1e-4; atlas 2.9e-6 and 2.3e-6, control 2.0e-3 and 2.6e-3);
# on grids of 16^3 and 32^2 the worst leaf of the momenta reads higher
# (grad 3.3e-5 and 2.4e-5, change 4.9e-5 and 4.2e-4; the control 6.7e-5
# and 3.6e-4, 1.7e-4 and 4.9e-4), so those two limits are the tiny cells' own.
TINY_LIMITS = {
    "tiny3d": {"loss": 2e-5, "grad": 3e-4, "change": 3e-4, "atlas": 3e-4},
    "tiny2d": {"loss": 1.5e-5, "grad": 3e-4, "change": 3e-3, "atlas": 2e-4},
}


def tiny_cell(name, chips=1):
    """``(cfg, workload)`` of a tiny cell."""
    from portbench import manifest

    base, over, subjects = TINY[name]
    cfg = dict(manifest.config(base), name=name, **over)
    wl = {"config": name, "chips": chips, "traffic": dict(TRAFFIC, subjects=subjects),
          "why": "a test", "limits": TINY_LIMITS[name]}
    return cfg, wl


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark beside a link to the port, with the tiny
    cells ``tiny3d.one`` and ``tiny3d.dp2`` (two processes) added beside
    the cells they stand for."""
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "lagomorph_tpu_torch"), tmp_path / "lagomorph_tpu_torch")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for cell, chips in (("tiny3d.one", 1), ("tiny3d.dp2", 2)):
        cfg, wl = tiny_cell("tiny3d", chips)
        json.dump(cfg, open(tmp_path / "portbench" / "configs" / "tiny3d.json", "w"))
        json.dump(wl, open(tmp_path / "portbench" / "workloads" / f"{cell}.json", "w"))
        bench["workloads"].append({"name": cell, "config": "tiny3d", "traffic": cell.split(".")[1],
                                   "chips": chips, "why": "a test"})
    # the tiny cells report what the 3D cell reports
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells = m.get("workloads", [])
        if "lddmm3d_128.resident" in cells:
            cells += ["tiny3d.one", "tiny3d.dp2"]
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    return tmp_path
