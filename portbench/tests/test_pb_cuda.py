"""On the card: each one-card cell runs through ``run.py`` for two seconds
and comes out correct, with its end-to-end metrics.  Skipped without a
card (``python -m pytest portbench/tests -m cuda`` on the card's
machine)."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import manifest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


ONE_CARD = [w["name"] for w in manifest.benchmark()["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_runs_correct(card, cell):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                        str(2**31 + 2024), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    e2e, _ = manifest.cell_metrics(manifest.benchmark(), cell)
    assert set(res["metrics"]) == {m["name"] for m in e2e}
    assert res["device"]["platform"] == "gpu"
