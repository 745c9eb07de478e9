#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--trace PATH]

Drives the port's 3D shoot-and-warp slice (``lagomorph_tpu_torch``) at the
headline size of the JAX package's bench (128^3, batch 4, 5 integration
steps, ``FluidMetric([0.1, 0.0, 0.01])``), forward:

1. device: needs a CUDA card; prints the card's name and power limit;
2. build: compiles the hand-written kernels from ``lagomorph_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   128^3 b4 and at a non-cubic, non-power-of-two shape, plus inputs that
   leave the unit regime so the flags must come out false;
4. slice: ``_lddmm_loss`` through the kernels and through the plain
   versions, at the bench's momenta and at momenta scaled to a deformation
   of about half a voxel; the launch counters show the path went through
   every kernel;
5. fallback: momenta whose substeps leave the unit regime, so ``expmap``
   re-runs the exact general integration;
6. timings: CUDA-event times of each kernel beside its plain version, and
   of the slice both ways;
7. trace (only with ``--trace PATH``): a ``torch.profiler`` trace of 5
   slices, written to ``PATH``, with the device time by kernel, the busy
   share and the idle gaps.

Any failure raises and the exit code is non-zero.  The line before the last
is a JSON record of the kernels; the last line, printed only when every
phase passed, is ``{"ok": true, "device": {...}}``.  Imports no jax.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FULL = (4, 3, 128, 128, 128)  # bench.py headline: 128^3, batch 4
ODD = (3, 3, 96, 80, 112)  # non-cubic, non-power-of-two
PARAMS = (0.1, 0.0, 0.01)
REG_WEIGHT = 0.1
STEPS = 5


def log(*parts):
    print(*parts, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def card_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip().splitlines()[0].strip()


def time_ms(fn, device, reps, warmup=2):
    """Mean milliseconds per call of ``fn`` after ``warmup`` calls (CUDA
    events around ``reps`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def compare(name, got, ref, tol_rel, offset=1.0):
    """Max abs error of ``got`` against ``ref``, checked against
    ``tol_rel * (offset + max|ref|)``."""
    err = max_err(got, ref)
    bound = tol_rel * (offset + float(ref.double().abs().max()))
    log(f"  {name}: max_abs_err={err:.3e} (bound {bound:.3e})")
    check(torch.isfinite(got).all().item(), f"{name}: non-finite output")
    check(err <= bound, f"{name}: max_abs_err {err:.3e} > {bound:.3e}")
    return err


def kernel_checks(lt, device, shape, seed):
    """Phase 3 at one shape: every kernel against its plain version, on the
    same inputs, in and out of the unit regime.  Returns {kernel: err}."""
    from lagomorph_tpu_torch.ops.kernels import epdiff_unit, fft_unit, plain_versions, warp_unit

    N, _, X, Y, Z = shape
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    phiinv = t(rng.uniform(-0.99, 0.99, shape))
    m0 = t(rng.standard_normal((1, 3, X, Y, Z)))
    v = t(rng.uniform(-4.9, 4.9, shape))  # s*v in (-0.98, 0.98) at s = -0.2
    I = t(rng.standard_normal((1, 1, X, Y, Z)))
    I3 = t(rng.standard_normal(shape))
    x = t(rng.standard_normal((2 * ((N * 3 + 1) // 2), X, Y, Z)))
    Mn = lt.FluidMetric(PARAMS).multiplier(shape, torch.float32, device, True)
    mN = t(rng.standard_normal(shape))  # batch-N momenta, as expmap passes them
    s = -0.2
    errs = {}

    def both(fn, *args):
        got = fn(*args)
        with plain_versions():
            ref = fn(*args)
        return got, ref

    tag = "x".join(map(str, shape))
    log(f"kernels at {tag}:")
    # K4, batch-1 image (the atlas warp), and batch-N 3-channel (the
    # fallback's unit tier)
    got, ref = both(warp_unit.sample_displacement_unit, I, phiinv)
    errs["warp_unit_fwd"] = compare("warp_unit_fwd I(1,1)", got, ref, 1e-5)
    got, ref = both(warp_unit.sample_displacement_unit, I3, phiinv)
    errs["warp_unit_fwd"] = max(errs["warp_unit_fwd"],
                                compare("warp_unit_fwd I(N,3)", got, ref, 1e-5))
    # K1 with batch-1 m0 (read with batch stride 0) and with batch-N m0 (the
    # main path's operand)
    errs["ad_star_fwd"] = 0.0
    for label, mm in (("m0(1,3)", m0), ("m0(N,3)", mN)):
        (got, gf), (ref, rf) = both(epdiff_unit.ad_star, phiinv, mm)
        errs["ad_star_fwd"] = max(errs["ad_star_fwd"],
                                  compare(f"ad_star_fwd {label}", got, ref, 1e-5))
        check(bool(gf) and bool(rf), f"ad_star_fwd {label}: in-regime flag false")
    # K2
    (got, gf), (ref, rf) = both(epdiff_unit.compose, phiinv, v, s)
    errs["compose_fwd"] = compare("compose_fwd", got, ref, 1e-5)
    check(bool(gf) and bool(rf), "compose_fwd: in-regime flag false")
    # K3: the packed pairs as fluid_operator builds them (odd slab counts
    # carry one zero slab)
    if (N * 3) % 2:
        x[-1] = 0
    got, ref = both(fft_unit.fluid_flat, x, Mn)
    errs["fluid_flat"] = compare("fluid_flat", got, ref, 1e-4, offset=0.0)

    # out of the unit regime: the flags must come out false, equal
    bad_p = phiinv.clone()
    bad_p.view(-1)[:: 1 + bad_p.numel() // 7] = 1.0  # upper bound is open
    bad_p.view(-1)[5] = -1.5
    for mm in (m0, mN):
        (_, gf), (_, rf) = both(epdiff_unit.ad_star, bad_p, mm)
        check(not bool(gf) and not bool(rf), "ad_star_fwd: out-of-regime flag not false")
    bad_v = v.clone()
    bad_v.view(-1)[bad_v.numel() // 2] = -5.1  # s*v = 1.02: outside
    (_, gf), (_, rf) = both(epdiff_unit.compose, phiinv, bad_v, s)
    check(not bool(gf) and not bool(rf), "compose_fwd: out-of-regime flag not false")
    # an in-regime edge value: s*v == -1.0 exactly is inside [-1, 1)
    edge_v = v.clone()
    edge_v.view(-1)[7] = 5.0
    (_, gf), (_, rf) = both(epdiff_unit.compose, phiinv, edge_v, s)
    check(bool(gf) == bool(rf), "compose_fwd: flags differ at the edge value")
    log("  flags: equal in and out of the unit regime")
    return errs


def bench_inputs(device):
    """The JAX bench's inputs (bench.py:92-103), from seed 0."""
    X = FULL[2:]
    rng = np.random.default_rng(0)
    I = rng.standard_normal((1, 1) + X)
    m = rng.standard_normal(FULL) * 2e-6
    img = rng.standard_normal((FULL[0], 1) + X)
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in (I, m, img)]


def slice_check(metric, I, m, img, loss, launched, label):
    """Hold one kernel-path forward of the slice (its ``loss`` and
    ``launched`` counts) against the plain versions: phiinv, the loss, the
    hoisted flag and the launches."""
    from lagomorph_tpu_torch import lddmm
    from lagomorph_tpu_torch.ops import kernels
    from lagomorph_tpu_torch.ops.interp import warp_tier

    with kernels.plain_versions():
        loss_p = float(lddmm._lddmm_loss(I, m, img, metric, REG_WEIGHT, STEPS)[0])
    dt = 1.0 / STEPS
    v0 = metric.sharp(m)
    _, ok = lddmm._expmap_fast_flagged(metric, m, dt, STEPS - 1, -dt * v0, None)
    check(bool(ok), f"{label}: hoisted-path flag tripped (fallback taken)")
    h = lddmm.expmap(metric, m, num_steps=STEPS, v0=v0)
    with kernels.plain_versions():
        h_p = lddmm.expmap(metric, m, num_steps=STEPS, v0=metric.sharp(m))
    tier = warp_tier(h)
    herr = max_err(h, h_p)
    rel = abs(loss - loss_p) / abs(loss_p)
    log(f"slice {label}: loss={loss!r} plain={loss_p!r} rel_diff={rel:.3e}; "
        f"phiinv max|h|={float(h.abs().max()):.4e} max_diff={herr:.3e} voxel; "
        f"hoisted flag kept; atlas warp tier={tier}; launches={launched}")
    check(np.isfinite(loss) and tuple(h.shape) == FULL, f"{label}: bad output")
    check(herr <= 1e-4, f"{label}: phiinv differs by {herr:.3e} voxel > 1e-4")
    check(rel <= 1e-5, f"{label}: loss differs by {rel:.3e} relative > 1e-5")
    want = {"ad_star_fwd": STEPS - 1, "compose_fwd": STEPS - 1, "fluid_flat": STEPS,
            "warp_unit_fwd": 1 if tier == "unit" else 0}
    check(launched == want, f"{label}: launches {launched}, want {want}")


def fallback_run(metric, m):
    """Momenta whose substeps leave the unit regime: ``expmap`` must return
    the general integration's result, which matches the plain versions."""
    from lagomorph_tpu_torch import lddmm
    from lagomorph_tpu_torch.ops import kernels

    dt = 1.0 / STEPS
    v0 = metric.sharp(m)
    fast, ok = lddmm._expmap_fast_flagged(metric, m, dt, STEPS - 1, -dt * v0, None)
    check(not bool(ok), "fallback: hoisted flag did not trip")
    h = lddmm.expmap(metric, m, num_steps=STEPS, v0=v0)
    general = lddmm._expmap_general(metric, m, dt, STEPS - 1, -dt * v0, None)
    check(torch.equal(h, general), "fallback: expmap did not return the general integration")
    check(not torch.equal(h, fast), "fallback: expmap returned the flagged fast result")
    with kernels.plain_versions():
        h_p = lddmm.expmap(metric, m, num_steps=STEPS, v0=metric.sharp(m))
    scale = 1.0 + float(h_p.abs().max())
    err = max_err(h, h_p)
    log(f"fallback: fast flag tripped, host branch re-ran _expmap_general; "
        f"max|h|={scale - 1:.4e} max_diff vs plain={err:.3e} voxel")
    check(bool(torch.isfinite(h).all()), "fallback: non-finite phiinv")
    check(err <= 1e-4 * scale, f"fallback: differs from plain by {err:.3e} > {1e-4 * scale:.3e}")


def timings(device, card, metric, I, m, img):
    """Per-call ms of each kernel and its plain version at 128^3 b4, and of
    the slice both ways (order: plain, kernel, kernel, plain)."""
    from lagomorph_tpu_torch import lddmm
    from lagomorph_tpu_torch.ops.kernels import epdiff_unit, fft_unit, plain_versions, warp_unit

    rng = np.random.default_rng(7)
    X = FULL[2:]

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    phiinv = t(rng.uniform(-0.99, 0.99, FULL))
    v = t(rng.uniform(-4.9, 4.9, FULL))
    x = t(rng.standard_normal((12,) + X))
    Mn = metric.multiplier(FULL, torch.float32, device, True)
    calls = {
        "warp_unit_fwd": lambda: warp_unit.sample_displacement_unit(I, phiinv),
        "ad_star_fwd": lambda: epdiff_unit.ad_star(phiinv, m),
        "compose_fwd": lambda: epdiff_unit.compose(phiinv, v, -0.2),
        "fluid_flat": lambda: fft_unit.fluid_flat(x, Mn),
    }
    out = {}
    for name, fn in calls.items():
        with plain_versions():
            p1 = time_ms(fn, device, 10)
        k1 = time_ms(fn, device, 10)
        k2 = time_ms(fn, device, 10)
        with plain_versions():
            p2 = time_ms(fn, device, 10)
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"time {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms "
            f"per call at 128^3 b4 [{card}]")

    def loss():
        return float(lddmm._lddmm_loss(I, m, img, metric, REG_WEIGHT, STEPS)[0])

    with plain_versions():
        p1 = time_ms(loss, device, 3, warmup=1)
    k1 = time_ms(loss, device, 3, warmup=1)
    k2 = time_ms(loss, device, 3, warmup=1)
    with plain_versions():
        p2 = time_ms(loss, device, 3, warmup=1)
    log(f"time slice (_lddmm_loss forward, 128^3 b4, 5 steps): kernels "
        f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms per call [{card}]")
    return out


def trace_run(device, card, metric, I, m, img, path, slices=5):
    """Optional phase (``--trace PATH``): a ``torch.profiler`` trace of
    ``slices`` kernel-path forwards of the slice, written to ``path`` as a
    Chrome trace.  Prints the device time per slice of each kernel, the
    device's busy share over the traced span, and its idle gaps."""
    from torch.profiler import ProfilerActivity, profile

    from lagomorph_tpu_torch import lddmm

    def loss():
        return float(lddmm._lddmm_loss(I, m, img, metric, REG_WEIGHT, STEPS)[0])

    loss()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(slices):
            loss()
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3 / slices
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = sorted((e for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda e: e["ts"])
    check(dev, "trace: no device activity in the trace")
    per = {}
    busy, gaps, end = 0.0, [], dev[0]["ts"]
    for e in dev:
        ms, n = per.get(e["name"], (0.0, 0))
        per[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
        start, stop = e["ts"], e["ts"] + e["dur"]
        if start > end:
            gaps.append(start - end)
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    span = end - dev[0]["ts"]
    gaps.sort(reverse=True)
    log(f"trace: {slices} slices, wall {wall:.3f} ms per slice under the profiler; "
        f"device busy {busy / 1e3 / slices:.3f} ms per slice, busy share "
        f"{busy / span:.3f} of the traced span [{card}]")
    log(f"trace: {len(gaps)} idle gaps, {sum(g > 50 for g in gaps)} over 50 us; "
        f"largest (us): {', '.join(f'{g:.0f}' for g in gaps[:8])}")
    for name, (ms, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"trace: {ms / slices:8.3f} ms/slice {n / slices:5.1f} calls/slice  {name[:90]}")
    log(f"trace: written to {path}")


def run(device, card, trace_path=None):
    sys.path.insert(0, HERE)
    import lagomorph_tpu_torch as lt
    from lagomorph_tpu_torch import lddmm
    from lagomorph_tpu_torch.ops import kernels
    from lagomorph_tpu_torch.ops.kernels import _build

    check("jax" not in sys.modules, "the port imported jax")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc sm_90a, "
        f"{len(_build._sources())} sources)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # 3. kernels against their plain versions
    errs = kernel_checks(lt, device, FULL, seed=1)
    kernel_checks(lt, device, ODD, seed=2)

    # 4. the slice, at the bench's momenta and at momenta scaled to a
    # half-voxel deformation: the main path, through the kernels, with the
    # launch counters set to 0 just before and read just after
    metric = lt.FluidMetric(PARAMS)
    I, m, img = bench_inputs(device)
    m_half = m * (0.5 / float(metric.sharp(m).abs().max()))
    configs = [("bench momenta (x2e-6)", m), ("momenta scaled to max|v0| = 0.5", m_half)]
    runs = []
    kernels.reset_launches()
    for label, mm in configs:
        before = kernels.launch_counts()
        loss = float(lddmm._lddmm_loss(I, mm, img, metric, REG_WEIGHT, STEPS)[0])
        after = kernels.launch_counts()
        runs.append((label, mm, loss, {k: after[k] - before[k] for k in after}))
    launches = kernels.launch_counts()
    log(f"main path launches: {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel was not launched: {launches}")
    for label, mm, loss, launched in runs:
        slice_check(metric, I, mm, img, loss, launched, label)

    # 5. fallback
    fallback_run(metric, m * (8.0 / float(metric.sharp(m).abs().max())))

    # 6. timings
    times = timings(device, card, metric, I, m, img)
    if trace_path:
        trace_run(device, card, metric, I, m, img, trace_path)

    record = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": launches[k.name], "max_abs_err": errs[k.name],
         "ms": times[k.name][0], "plain_ms": times[k.name][1]}
        for k in kernels.KERNELS.values()
    ]}
    return record


def main():
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    ap.add_argument("--trace", metavar="PATH",
                    help="also trace 5 slices with torch.profiler into this Chrome-trace "
                         "file and print the device time by kernel and the busy share")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    record = run(device, card, args.trace)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
