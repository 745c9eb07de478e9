#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, on the card, at a
cell's own size.

    python3 portbench/control.py --workload <cell> [--seeds 12] [--first N]
                                 [--plants bf16_images,half_batch] [--plant-seeds 3]

Runs the cell's set-up, warm-up epoch and comparison (a window of a few
iterations, which the readings do not use) on ``--seeds`` seeds of the
sound program, then on ``--plant-seeds`` seeds with each of ``--plants``
(:mod:`.faults`: ``bf16_images``, the control, is the builder's own
bfloat16 image path; the others are faults planted under the timed path).
Prints one JSON line per run and, last, per number the lower reading (the
largest of the sound runs, ``sound``) and each plant's smallest reading.
A one-card cell runs in this process; a cell on several cards runs
``run.py`` once a seed.  Not run by the benchmark's runs.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import check, manifest  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402

WINDOW_S = 0.2


def one_card(wl, cfg, seed, plant, device):
    import torch

    from portbench import drive

    st = drive.run_rank(cfg, wl["traffic"], seed, WINDOW_S, False, torch.device(device),
                        plant=FAULTS[plant] if plant else None)
    return st["checks"], st["reference_s"]


def several_cards(name, seed, plant, device):
    cmd = [sys.executable, os.path.join(ROOT, "portbench", "run.py"), "--workload", name,
           "--seed", str(seed), "--seconds", str(WINDOW_S), "--trace", "0", "--device", device]
    if plant:
        cmd += ["--plant", plant]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(r.stderr[-3000:])
    res = json.loads(r.stdout.strip().splitlines()[-1])
    return {k: v["value"] for k, v in res["checks"].items()}, None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=4_000_000_001)
    ap.add_argument("--plants", default="bf16_images,half_batch")
    ap.add_argument("--plant-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)  # a CPU rehearsal
    args = ap.parse_args()
    import torch

    torch.set_num_threads(2)
    wl = manifest.workload(args.workload)
    cfg = manifest.config(wl["config"])
    plants = [p for p in args.plants.split(",") if p]
    runs = [(None, args.first + i) for i in range(args.seeds)]
    runs += [(p, args.first + 1000 + 100 * k + i) for k, p in enumerate(plants)
             for i in range(args.plant_seeds)]
    readings = {}
    for plant, seed in runs:
        t = time.perf_counter()
        if int(wl["chips"]) == 1:
            nums, ref_s = one_card(wl, cfg, seed, plant, args.device)
        else:
            nums, ref_s = several_cards(args.workload, seed, plant, args.device)
        nums = {k: nums[k] for k in check.NUMBERS}
        readings.setdefault(plant or "sound", []).append(nums)
        print(json.dumps({"plant": plant or "sound", "seed": seed, **nums,
                          "reference_s": ref_s, "run_s": time.perf_counter() - t}), flush=True)
    summary = {k: {p: (max if p == "sound" else min)(r[k] for r in rs)
                   for p, rs in readings.items()} for k in check.NUMBERS}
    print(json.dumps({"summary": summary, "workload": args.workload}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
