"""The control and the faults: a run of the program is correct against the
cells' limits, and comes out not correct with the builder's own bfloat16
image path (the control) and with each fault the cells can have planted
under the timed path (its state returned unchanged, half of each
minibatch left out, the exchange between processes left out).  Tiny cells
on the CPU, the port's plain versions; the whole run but the look for a
card."""
import json
import subprocess
import sys

import pytest
import torch

from conftest import tiny_cell
from portbench import check, drive
from portbench.faults import FAULTS

torch.set_num_threads(2)
SEED = 2**31 + 12345


def _run(name, plant=None, **traffic):
    cfg, wl = tiny_cell(name)
    st = drive.run_rank(cfg, dict(wl["traffic"], **traffic), SEED, 0.3, False,
                        torch.device("cpu"), plant=FAULTS[plant] if plant else None)
    numbers = {k: st["checks"][k] for k in check.NUMBERS}
    ok, lines = check.verdict(numbers, wl["limits"])
    return ok and st["failed"] == 0 and st["attempted"] > 0, numbers


@pytest.mark.parametrize("name", ["tiny3d", "tiny2d"])
def test_sound_run_is_correct(name):
    ok, numbers = _run(name)
    assert ok, numbers


TRAFFIC = {  # from the cell's subjects, the traffic's keys
    # the last minibatch short (5 subjects at b2, 11 at b4), as a cohort
    # that is no multiple of the batch gives it
    "short_last": lambda n: {"subjects": n - 1},
    # streamed from the host through the staging threads, as the command's default
    "streamed": lambda n: {"keep_data_on_device": False, "loader_workers": 1},
    # the first subject of every second minibatch shot at 2 voxels
    "outliers": lambda n: {"outliers": {"every": 2, "vmax": 2.0}},
}


@pytest.mark.parametrize("traffic", TRAFFIC)
@pytest.mark.parametrize("name", ["tiny3d", "tiny2d"])
def test_traffic_from_data_is_correct(name, traffic):
    """The traffic's own keys reach the run, and the comparison holds."""
    ok, numbers = _run(name, **TRAFFIC[traffic](tiny_cell(name)[1]["traffic"]["subjects"]))
    assert ok, numbers


@pytest.mark.parametrize("plant", ["bf16_images", "unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["tiny3d", "tiny2d"])
def test_control_and_faults_are_not_correct(name, plant):
    ok, numbers = _run(name, plant)
    assert not ok, numbers


def _cli(checkout, cell, plant=None):
    cmd = [sys.executable, str(checkout / "portbench" / "run.py"), "--workload", cell,
           "--seed", str(SEED), "--seconds", "2", "--trace", "0", "--device", "cpu"]
    if plant:
        cmd += ["--plant", plant]
    r = subprocess.run(cmd, cwd=checkout, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1]), r.stderr


@pytest.mark.parametrize("plant", [None, "no_exchange"])
def test_two_processes(checkout, plant):
    """Two gloo processes through ``run.py``: correct, and not correct
    without the exchange; the checks come last, on stderr too."""
    res, err = _cli(checkout, "tiny3d.dp2", plant)
    assert res["correct"] is (plant is None), res["checks"]
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("atlas ")
    assert res["device"]["count"] == 2
    assert set(res["metrics"]) == {"subjects_per_s", "iter_ms_p95", "peak_mem_gib", "setup_s"}


def test_control_script(checkout):
    """``control.py`` (the chip's readings script) on the tiny cell: the
    sound runs' largest reading and the control's smallest, per number."""
    r = subprocess.run([sys.executable, "portbench/control.py", "--workload", "tiny3d.one",
                        "--seeds", "2", "--plants", "bf16_images", "--plant-seeds", "1",
                        "--device", "cpu"], cwd=checkout, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(x) for x in r.stdout.strip().splitlines()]
    assert [x["plant"] for x in lines[:-1]] == ["sound", "sound", "bf16_images"]
    summary = lines[-1]["summary"]
    assert summary["loss"]["sound"] == max(x["loss"] for x in lines[:2])
    assert summary["loss"]["bf16_images"] > 10 * summary["loss"]["sound"]
