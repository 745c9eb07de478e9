#!/usr/bin/env python3
"""The benchmark of ``lagomorph_tpu_torch``'s atlas builder on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` (``portbench/workloads/<cell>.json``,
its configuration ``portbench/configs/<config>.json``): makes the inputs
from the seed, builds ``LDDMMAtlasBuilder`` on them on the traffic's data
path (staged on the device by default), warms it up by one epoch (set-up),
then drives
``builder.epoch()`` for ``--seconds`` and prints one JSON line: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, each read by
``portbench/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the
float64 reference beside its limit (also the last lines on standard
error).  A cell on several chips runs one process per card in a
``torch.distributed`` group (NCCL), started here.

Exits 2 without a result when there are fewer CUDA cards than the cell
asks for, and 3 when a JAX module (or the JAX package) was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the JAX package and what imports it; compared by top-level name, whole
FORBIDDEN = {"jax", "jaxlib", "flax", "lagomorph_tpu", "bench", "chip_smoke", "profile_atlas",
             "profile_warp", "profile_shoot2d", "profile_epdiff2d", "profile_radix"}


THREADS = 2  # each process's CPU threads: load from few threads, steadier host timing


def forbidden_modules():
    """The forbidden top-level names among the loaded modules."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # one process of a multi-card cell, started by the run itself
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--stop-fds", default="", help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=None, help=argparse.SUPPRESS)
    # the control's faults and the tests' CPU runs (never in a measured run)
    ap.add_argument("--plant", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _plant(name):
    if name is None:
        return None
    from portbench.faults import FAULTS

    return FAULTS[name]


def _kind(device):
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def rank_main(args, wl, cfg, per_layer):
    """One process of a multi-card cell: join the group, run, print the
    summary as the last line."""
    import torch
    import torch.distributed as dist

    from portbench import drive, report

    world = int(wl["chips"])
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(args.rank)
        device = torch.device("cuda", args.rank)
    else:
        device = torch.device("cpu")
    dist.init_process_group("cpu:gloo,cuda:nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=world, rank=args.rank,
                            **({"device_id": device} if cuda else {}))
    fds = [int(f) for f in args.stop_fds.split(",") if f]
    for fd in fds:
        os.set_blocking(fd, False)
    try:
        stats = drive.run_rank(cfg, wl["traffic"], args.seed, args.seconds, bool(args.trace),
                               device, rank=args.rank, world=world, stop_fds=fds,
                               t_start=args.t_start, plant=_plant(args.plant))
        summary = report.summarize(stats, cfg, per_layer)
        summary["forbidden"] = forbidden_modules()
        summary["kind"] = _kind(device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(json.dumps(summary), flush=True)
    return 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, world):
    """Start one process per card and collect their summaries (rank order)."""
    if args.device == "cuda":  # build the kernels once, before the processes load them
        from lagomorph_tpu_torch.ops.kernels import _build

        _build.library()
    port = _free_port()
    pipes = [os.pipe() for _ in range(world - 1)]  # rank 0 tells the others when to stop
    procs = []
    for r in range(world):
        fds = [w for _, w in pipes] if r == 0 else [pipes[r - 1][0]]
        cmd = [sys.executable, os.path.abspath(__file__), "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", str(args.seconds),
               "--trace", str(args.trace), "--rank", str(r), "--port", str(port),
               "--stop-fds", ",".join(map(str, fds)), "--t-start", repr(T_START),
               "--device", args.device]
        if args.plant:
            cmd += ["--plant", args.plant]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, pass_fds=fds, text=True))
    for rd, wr in pipes:
        os.close(rd)
        os.close(wr)
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=330)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} failed (exit codes "
                           f"{[procs[r].returncode for r in bad]})")
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def run(args, wl, cfg, bench):
    """The result line of a run of cell ``args.workload``, and the checks'
    lines."""
    import torch

    from portbench import check, manifest, report

    world = int(wl["chips"])
    e2e, per_layer = manifest.cell_metrics(bench, args.workload)
    if world == 1:
        from portbench import drive

        device = torch.device(args.device)
        stats = drive.run_rank(cfg, wl["traffic"], args.seed, args.seconds, bool(args.trace),
                               device, t_start=T_START, plant=_plant(args.plant))
        summaries = [dict(report.summarize(stats, cfg, per_layer), forbidden=[],
                          kind=_kind(device))]
    else:
        summaries = launch(args, world)
    numbers = {k: max(s["checks"][k] for s in summaries) for k in check.NUMBERS}
    correct, lines = check.verdict(numbers, wl["limits"])
    attempted = summaries[0]["attempted"]
    failed = max(s["failed"] for s in summaries)
    correct = correct and failed == 0 and attempted > 0
    if args.trace:
        metrics = summaries[0]["per_layer"]
    else:
        run_ctx = report.Run(summaries)
        metrics = {m["name"]: {"value": manifest.reader(m["name"])(run_ctx), "unit": m["unit"]}
                   for m in e2e}
    cuda = args.device == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": summaries[0]["kind"],
              "count": world,
              "memory_peak_bytes": max(s["memory_peak_bytes"] for s in summaries)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = sum(s["busy_s"] for s in summaries) / world
        device["window_s"] = sum(s["traced_s"] for s in summaries) / world
        result["breakdown"] = summaries[0]["breakdown"]
    result["checks"] = {k: {"value": numbers[k], "limit": wl["limits"][k]}
                        for k in check.NUMBERS}
    note = (f"portbench: set-up marks (s) {summaries[0]['setup_marks']}; reference "
            f"{max(s['reference_s'] for s in summaries)!r} s, its norms (rank 0) "
            f"{summaries[0]['checks']['ref_norms']}")
    if args.trace:
        note += f"; s an iteration, traced and not (rank 0) {summaries[0]['iter_s']}"
    forbidden = sorted(set(forbidden_modules()).union(*(s["forbidden"] for s in summaries)))
    return result, [note] + lines, forbidden


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    import torch

    torch.set_num_threads(THREADS)
    from portbench import manifest

    wl = manifest.workload(args.workload)
    cfg = manifest.config(wl["config"])
    bench = manifest.benchmark()
    if args.rank is not None:
        return rank_main(args, wl, cfg, manifest.cell_metrics(bench, args.workload)[1])
    world = int(wl["chips"])
    if args.device == "cuda" and (not torch.cuda.is_available()
                                  or torch.cuda.device_count() < world):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {world} CUDA card(s), {have} found", file=sys.stderr)
        return 2
    result, lines, forbidden = run(args, wl, cfg, bench)
    if forbidden:
        print(f"portbench: forbidden modules loaded: {', '.join(forbidden)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
