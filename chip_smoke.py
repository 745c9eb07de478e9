#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--trace PATH]

Drives the port's 3D atlas step (``lagomorph_tpu_torch``) at the headline
size of the JAX package's bench (128^3, batch 4, 5 integration steps,
``FluidMetric([0.1, 0.0, 0.01])``, ``reg_weight=0.1``,
``learning_rate_pose=1e-6``; bench.py:81-103), on its default fluid solve
(K3) and on the radix-2 solve (``--fluid_transform radix``: K14, K15), the
3D step at the bench's 64^3 b4 (bench.py:340) on the whole-volume solve
(``set_fluid_mxu_whole(True)``: K16), and its 2D atlas step at the bench's
2D configurations (256^2 and 512^2, batch 8; bench.py:342-345), with that
metric and with ``FluidMetric([0.1, 0.05, 0.01])`` (``lddmm atlas
--fluid_beta 0.05``):

1. device: needs a CUDA card; prints the card's name and power limit;
2. build: compiles the hand-written kernels from ``lagomorph_tpu_torch/csrc``
   (one nvcc per source, in parallel);
3. kernels: each forward kernel against its plain PyTorch version on the
   card, at 128^3 b4 and at a non-cubic, non-power-of-two shape, plus
   inputs that leave the unit regime so the flags must come out false (K4,
   K1 (out and ``mw``, batch-1 and batch-N momenta) and K2 bit-equal; K1
   and K2 also at 64^3 b4 and at forced march lengths, with a voxel out of
   the regime on the last plane of a march); then each
   backward kernel (K5, K6, K7, and K3 through
   autograd) against the plain versions' gradients at both shapes, two
   launches each of K5, K6 and K7 bit-identical, and K6's first pass alone
   (batch-1 and batch-N momenta: ``d_mw`` bit-equal to the plain Jacobian
   transpose, ``d_phiinv`` within 1e-5 * (1 + max|ref|), a second launch
   bit-identical); then the 2D whole-shoot
   kernels K8 (phiinv_T, flag and stashed trajectory) and K9 (both
   gradients) against their plain versions at 256^2 b8, 512^2 b8 and
   (3, 2, 96, 80), with batch-1 and batch-N momenta and a tripped flag,
   launched directly (K8 and K9 twice each, bit-identical, their grids and
   tiles logged; K8's traj_phiinv[0] and traj_mw[0] bit-equal) and through
   the wrapper under autograd; then the 2D
   per-substep kernels K10-K13 (Ad*, compose and their backwards) against
   their plain versions at the same three shapes, the same way (K10 and
   K11 on their column strips at the chooser's band height and at 3 and 8
   rows, bit-equal to the plain versions and to their per-thread route,
   their strips logged); then the
   fluid solves that the selectors reach: K14 (both directions), K15 and
   the pipeline K14, K15, K14 at 128^3 b4, 64^3 b4, (3, 3, 32, 64, 128),
   (1, 3, 4, 256, 256) (256^2 planes: K14's two register line passes) and
   (1, 3, 512, 8, 512) (K14's z pass and K15 in radix-2 tiles), and K16 at
   128^3 b4, 64^3 b4, (3, 3, 32, 64, 128) and (3, 3, 96, 80, 112),
   directly and under autograd, the pipeline K14, K15, K14 and K16
   bit-equal to K3 on its plane (128^3, 64^3) and line (3, 3, 32, 64, 128)
   paths (and the pipeline at (1, 3, 4, 256, 256)), with K16's cooperative
   grid logged;
4. slice: ``_lddmm_loss`` forward through the kernels and through the
   plain versions, at the bench's momenta and at momenta scaled to a
   deformation of about half a voxel; the launch counters show the forward
   went through every forward kernel;
5. fallback: momenta whose substeps leave the unit regime, so ``expmap``
   re-runs the exact general integration;
6. atlas steps, the main path: three chained ``make_lddmm_atlas_step``
   steps (``m_new`` feeds the next step, then one atlas update) through the
   kernels and through the plain versions, at the bench's momenta and at
   max|v0| = 0.5, each step's momentum gradient held against a float64
   one; the launch counters, set to 0 just before the bench momenta's
   steps and read just after, show every kernel ran, with the launches of
   each step checked; then one step on fallback momenta at 128^3 b4, with
   its peak device memory (the general substeps rematerialised) beside the
   peak before they were;
6b. 2D atlas steps, the 2D main path: three chained steps at 256^2 b8 and
   at 512^2 b8 (bench.py's inputs), and at 256^2 b8 at max|v0| = 0.5,
   both ways, with each step's momentum
   gradient held against a float64 one; the counters, set to 0 just before
   the 256^2 kernel steps and read just after, show K8 and K9 each
   launched once per step and no 3D kernel;
6c. 2D atlas steps with ``beta = 0.05``, the path of K10-K13: the same
   three chains, the counters set to 0 just before the 256^2 kernel steps
   and read just after showing K10-K13 four times each per step and no
   other kernel; then one step at 256^2 b8 on momenta whose flag trips
   (max|v0| = 8, and 2), re-run on the exact general integration, whose
   unit-regime warps run K10-K13;
6d. the radix path: three chained atlas steps at 128^3 b4 under
   ``set_fluid_fft_kernel("radix")``, both ways, each step's momentum
   gradient held against a float64 one; the counters, set to 0 just before
   the kernel steps and read just after, show K14 20 and K15 10 launches per
   step, no K3, and the other 3D kernels as on the default path;
6e. the whole-volume path: the same at 64^3 b4 under
   ``set_fluid_mxu_whole(True)`` (K16 10 launches per step, no K3), then
   one step at 64^3 b4 on the default selectors (K3), with the route each
   setting takes logged;
7. timings: CUDA-event times of each kernel beside its plain version, the
   bound of its work on the card and, where one PyTorch call computes the
   same function, that call (K5's: ``grid_sampler_3d_backward`` and the sum
   over the subjects), each kernel's multiple of its bound (K1 timed as the
   step runs it, writing ``mw``, and forward-only), and K2's two-call yardstick
   (``grid_sample`` + s v); each pass of the warp's backward launchers, which
   K5, K6 and K7 share, at the four operand shapes of the step, and K6's
   first pass alone, each beside its bound; the slice and the atlas step
   both ways, with
   the peak device memory of each step; K8 and K9 at 256^2 b8 and 512^2
   b8, K10-K13 at one substep's shapes at 256^2 b8 (and by device time at
   both widths, with K11's two-call yardstick), and the 2D atlas step
   both ways, with
   ``beta = 0`` and ``beta = 0.05``, at 256^2 b8 and 512^2 b8, with peak
   memory; K14, K15 and the pipeline at 128^3 b4 and K16 at 64^3 b4 and
   128^3 b4 (the library call of the pipeline and of K16: ``ifftn(Mn *
   fftn(.))`` on the packed pairs), with K16's cooperative grid and the
   ``torch.profiler`` device time per call of K16, K3 and the library call
   at both shapes, and the radix step at 128^3 b4 and the whole and default
   steps at 64^3 b4, both ways, with peak memory;
8. trace (only with ``--trace PATH``): ``torch.profiler`` traces of 5
   slices (``PATH``), of 5 atlas steps (``PATH`` with ``_steps`` before its
   extension), of 5 2D atlas steps at 256^2 b8 (``_steps2d``), of 5 such
   steps with ``beta = 0.05`` (``_steps2d_beta``), of 5 radix steps at
   128^3 b4 (``_steps_radix``) and of 5 whole-volume steps at 64^3 b4
   (``_steps64_whole``), with the device time by kernel (every kernel of
   the port listed), the busy share and the idle gaps.

Any failure raises and the exit code is non-zero.  The line before the last
is a JSON record of the kernels; the last line, printed only when every
phase passed, is ``{"ok": true, "device": {...}}``.  Imports no jax.
"""
from __future__ import annotations

import argparse
import contextlib
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
LR_POSE = 1e-6  # bench.py:85
LR_IMAGE = 1e4  # lddmm_atlas's default learning_rate_image
CHAIN = 3  # chained atlas steps per comparison
# the momentum gradient through the kernels against a float64 one, in
# relative L2 norm (step_compare); the fallback's general tiers take more
# rounding
P_TOL = 2e-4
FALLBACK_P_TOL = 5e-3
# the fallback step runs at the headline size (the bounded warp tier's
# backward keeps only its inputs)
FALLBACK = FULL
# its peak through the kernels when `_expmap_general` kept every substep's
# intermediates (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W), logged beside
# the peak of the rematerialised substeps
FALLBACK_PEAK_UNREMAT_GIB = 16.20
# K2 and K1 at forced march lengths (planes a block marches over along x)
COMPOSE_MARCHES = (8, 16, 128)
AD_STAR_MARCHES = (8, 16, 128)
FULL2D = (8, 2, 256, 256)  # bench.py:342, 2d_256sq_b8
FULL2D_512 = (8, 2, 512, 512)  # bench.py:345, 2d_512sq_b8
ODD2D = (3, 2, 96, 80)  # non-square, non-power-of-two
# launches of each kernel in one atlas step on the hoisted fast path
STEP_LAUNCHES = {"ad_star_fwd": 4, "compose_fwd": 4, "fluid_flat": 10, "warp_unit_fwd": 1,
                 "warp_unit_bwd": 1, "ad_star_bwd": 4, "compose_bwd": 4}
FORWARD = ("warp_unit_fwd", "ad_star_fwd", "compose_fwd", "fluid_flat")
KERNELS_2D = ("shoot2d_fwd", "shoot2d_bwd")
FORCED_BANDS = (3, 8)  # band heights forced on K10's and K11's strips in phase 3
KERNELS_2D_PER_OP = ("ad_star2d_fwd", "compose2d_fwd", "ad_star2d_bwd", "compose2d_bwd")
# launches in one 2D atlas step: the whole shooting is one K8, its backward
# one K9; the 2D fluid solve and warps are plain PyTorch (as in the JAX
# package) and no 3D kernel runs
STEP2D_LAUNCHES = {"shoot2d_fwd": 1, "shoot2d_bwd": 1}
# the 2D step with a compressible fluid metric (`lddmm atlas --fluid_beta
# 0.05`): K8's gate is closed by beta, so each of the 4 substeps after the
# peeled first runs K10 (Ad*), the plain rfftn solve and K11 (compose), and
# the backward K12 and K13 per substep
PARAMS_BETA = (0.1, 0.05, 0.01)
STEP2D_BETA_LAUNCHES = {k: STEPS - 1 for k in KERNELS_2D_PER_OP}
# the fluid solves of the selectors: K14, K15 (`set_fluid_fft_kernel("radix")`,
# the CLI's `--fluid_transform radix`) and K16 (`set_fluid_mxu_whole(True)`);
# each of a 3D step's 10 solves (5 forward, 5 backward) is K14, K15, K14 or
# one K16 in place of K3
KERNELS_SOLVE = ("fluid_radix_zy", "fluid_radix_x", "fluid_whole")
FULL64 = (4, 3, 64, 64, 64)  # bench.py:340, 64cubed_b4
RADIX_ODD = (3, 3, 32, 64, 128)  # non-cubic, power-of-two axes
RADIX_WIDE = (1, 3, 4, 256, 256)  # 256^2 (Y, Z) planes: K14's two line passes, not its plane
RADIX_LONG = (1, 3, 512, 8, 512)  # axes beyond 256: K14's z pass and K15 in radix-2 tiles
RADIX_STEP_LAUNCHES = {**STEP_LAUNCHES, "fluid_flat": 0, "fluid_radix_zy": 20, "fluid_radix_x": 10}
WHOLE_STEP_LAUNCHES = {**STEP_LAUNCHES, "fluid_flat": 0, "fluid_whole": 10}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


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
    """Phase 3 at one shape: every forward kernel against its plain
    version, on the same inputs, in and out of the unit regime.  Returns
    {kernel: err}."""
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
    # K4 sums its 8 live taps in the plain version's order and rounding: bit-equal
    got, ref = both(warp_unit.sample_displacement_unit, I, phiinv)
    errs["warp_unit_fwd"] = compare("warp_unit_fwd I(1,1)", got, ref, 0.0)
    got, ref = both(warp_unit.sample_displacement_unit, I3, phiinv)
    errs["warp_unit_fwd"] = max(errs["warp_unit_fwd"],
                                compare("warp_unit_fwd I(N,3)", got, ref, 0.0))
    # K1 with batch-1 m0 (read with batch stride 0) and with batch-N m0 (the
    # main path's operand), forward only and writing mw (as under autograd);
    # it sums its 8 live taps in the plain version's order and rounding and
    # rounds the Jacobian as it does: bit-equal
    errs["ad_star_fwd"] = 0.0
    for label, mm in (("m0(1,3)", m0), ("m0(N,3)", mN)):
        (got, gf), (ref, rf) = both(epdiff_unit.ad_star, phiinv, mm)
        errs["ad_star_fwd"] = max(errs["ad_star_fwd"],
                                  compare(f"ad_star_fwd {label}", got, ref, 0.0))
        check(bool(gf) and bool(rf), f"ad_star_fwd {label}: in-regime flag false")
        got, gf, mw = epdiff_unit._launch_ad_star(phiinv, mm, want_mw=True)
        for what, a, r in zip(("out", "mw"), (got, mw), (ref, epdiff_unit.ad_star_plain(
                phiinv, mm, want_mw=True)[2])):
            errs["ad_star_fwd"] = max(errs["ad_star_fwd"],
                                      compare(f"ad_star_fwd {label} writing mw: {what}", a, r,
                                              0.0))
        check(bool(gf), f"ad_star_fwd {label} writing mw: in-regime flag false")
    # K2 sums its 8 live taps in the plain version's order and rounding: bit-equal
    (got, gf), (ref, rf) = both(epdiff_unit.compose, phiinv, v, s)
    errs["compose_fwd"] = compare("compose_fwd", got, ref, 0.0)
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
    log("  flags: equal in and out of the unit regime; two launches of K9 bit-identical")
    return errs


def compose_fwd_march(phiinv, v, s, march):
    """K2 through its C entry point, its blocks marching over ``march``
    planes (0: the length K2 takes; not counted: the main path launches K2
    through its wrapper): ``(out, flag)``."""
    from lagomorph_tpu_torch.ops.kernels import _build, stream_of

    N, _, X, Y, Z = phiinv.shape
    out = torch.empty_like(phiinv)
    flag = torch.ones((), dtype=torch.int32, device=phiinv.device)
    _build.call("lagomorph_compose_fwd", phiinv.data_ptr(), v.data_ptr(), float(s),
                out.data_ptr(), flag.data_ptr(), N, X, Y, Z, march, stream_of(phiinv))
    return out, bool(flag)


def compose_checks(device, shape, seed):
    """Phase 3, K2 at one shape, at the march length it takes and at
    ``COMPOSE_MARCHES``: out bit-equal to the plain version and the flags
    equal, on displacements inside the unit regime and on displacements
    with about one voxel in eight outside it or at its edges (-1, 0); a
    second launch bit-identical; and one voxel out of the regime on the
    last plane of a march (the last subject, the corner of a partial tile)
    clears the flag.  Returns the largest error."""
    from lagomorph_tpu_torch.ops.kernels import epdiff_unit

    N, _, X, Y, Z = shape
    rng = np.random.default_rng(seed)
    s = -0.2

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    phiinv = t(rng.uniform(-0.99, 0.99, shape))
    inside = rng.uniform(-4.9, 4.9, shape)
    edges = inside.copy()
    pick = rng.uniform(size=shape) < 0.125
    edges[pick] = rng.choice([-2.5, -1.5, 1.0, 1.5, 3.7, -1.0, 0.0], size=int(pick.sum())) / s
    err = 0.0
    tag = "x".join(map(str, shape))
    for label, v in (("in the unit regime", t(inside)), ("edges and outside", t(edges))):
        ref, r_flag = epdiff_unit.compose_plain(phiinv, v, s)
        for march in (0,) + COMPOSE_MARCHES:
            got, flag = compose_fwd_march(phiinv, v, s, march)
            err = max(err, compare(f"compose_fwd {tag} march {march or 'own'}, {label}", got,
                                   ref, 0.0))
            check(flag is bool(r_flag), f"compose_fwd march {march}, {label}: flags differ")
            if march == 0:
                again = compose_fwd_march(phiinv, v, s, 0)
                check(torch.equal(got, again[0]) and again[1] is flag,
                      f"compose_fwd {label}: two launches differ")
    for march in COMPOSE_MARCHES:
        if march <= X:
            v = t(inside)
            v[N - 1, 2, march - 1, Y - 1, Z - 1] = 1.5 / s
            check(not compose_fwd_march(phiinv, v, s, march)[1],
                  f"compose_fwd march {march}: a voxel out of the regime on the march's last "
                  "plane left the flag true")
    log(f"  K2 at {tag}: bit-equal at its own march length and at {COMPOSE_MARCHES} planes, "
        "flags equal, a rerun bit-identical, the last plane of a march flagged")
    return err


def ad_star_fwd_march(phiinv, m0, march, want_mw):
    """K1 through its C entry point, its blocks marching over ``march``
    planes (0: the length K1 takes; not counted: the main path launches K1
    through its wrapper): ``(out, flag, mw or None)``."""
    from lagomorph_tpu_torch.ops.kernels import _build, stream_of

    N, _, X, Y, Z = phiinv.shape
    out = torch.empty_like(phiinv)
    mw = torch.empty_like(phiinv) if want_mw else None
    flag = torch.ones((), dtype=torch.int32, device=phiinv.device)
    _build.call("lagomorph_ad_star_fwd", phiinv.data_ptr(), m0.data_ptr(), out.data_ptr(),
                None if mw is None else mw.data_ptr(), flag.data_ptr(), N, m0.shape[0], X, Y, Z,
                march, stream_of(phiinv))
    return out, bool(flag), mw


def ad_star_checks(device, shape, seed):
    """Phase 3, K1 at one shape, at the march length it takes and at
    ``AD_STAR_MARCHES``, with batch-1 and batch-N m0, writing mw and not:
    out and mw bit-equal to the plain version and the flags equal, on
    displacements inside the unit regime and on displacements with about
    one voxel in eight outside it or at its edges (-1, 0); a second launch
    bit-identical; and one voxel out of the regime on the last plane of a
    march (the last subject, the corner of a partial tile) clears the flag.
    Returns the largest error."""
    from lagomorph_tpu_torch.ops.kernels import epdiff_unit

    N, _, X, Y, Z = shape
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    inside = rng.uniform(-0.99, 0.99, shape)
    edges = inside.copy()
    pick = rng.uniform(size=shape) < 0.125
    edges[pick] = rng.choice([-2.5, -1.5, 1.0, 1.5, 3.7, -1.0, 0.0], size=int(pick.sum()))
    moms = (("m0(1,3)", t(rng.standard_normal((1, 3, X, Y, Z)))),
            ("m0(N,3)", t(rng.standard_normal(shape))))
    err = 0.0
    tag = "x".join(map(str, shape))
    for label, phiinv in (("in the unit regime", t(inside)), ("edges and outside", t(edges))):
        for mlabel, m0 in moms:
            ref, r_flag, r_mw = epdiff_unit.ad_star_plain(phiinv, m0, want_mw=True)
            worst = 0.0
            for march in (0,) + AD_STAR_MARCHES:
                for want_mw in (True, False):
                    got, flag, mw = ad_star_fwd_march(phiinv, m0, march, want_mw)
                    what = (f"ad_star_fwd {tag} {mlabel} march {march or 'own'}"
                            f"{', writing mw' if want_mw else ''}, {label}")
                    e = max([max_err(got, ref)] + ([max_err(mw, r_mw)] if want_mw else []))
                    check(e == 0.0 and torch.isfinite(got).all().item(),
                          f"{what}: max_abs_err {e:.3e} > 0 or non-finite")
                    check(flag is bool(r_flag), f"{what}: flags differ")
                    worst = max(worst, e)
                    if march == 0:
                        again = ad_star_fwd_march(phiinv, m0, 0, want_mw)
                        check(torch.equal(got, again[0]) and again[1] is flag
                              and (mw is None or torch.equal(mw, again[2])),
                              f"{what}: two launches differ")
            log(f"  ad_star_fwd {tag} {mlabel}, {label}: out and mw max_abs_err={worst:.3e} "
                f"(bound 0) at its own march and {AD_STAR_MARCHES}, flags {bool(r_flag)} equal")
            err = max(err, worst)
    for march in AD_STAR_MARCHES:
        if march <= X:
            phiinv = t(inside)
            phiinv[N - 1, 2, march - 1, Y - 1, Z - 1] = 1.0  # the upper bound is open
            check(not ad_star_fwd_march(phiinv, moms[1][1], march, False)[1],
                  f"ad_star_fwd march {march}: a voxel out of the regime on the march's last "
                  "plane left the flag true")
    log(f"  K1 at {tag}: a rerun bit-identical, the last plane of a march flagged")
    return err


def backward_checks(lt, device, shape, seed):
    """Phase 3, backward, at one shape: the gradients through each backward
    kernel against autograd of the plain versions, on the same inputs and
    cotangent: K5 with the atlas (1, 1) and a batch-N three-channel image,
    K6 with batch-1 and batch-N m0, K7 at s = -0.2, K3 (its own backward)
    through the packed solve.  Returns {kernel: err}."""
    from lagomorph_tpu_torch.ops.kernels import (epdiff_unit, fft_unit, launch_counts,
                                                 plain_versions, warp_unit)

    N, _, X, Y, Z = shape
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    phiinv = t(rng.uniform(-0.99, 0.99, shape))
    Mn = lt.FluidMetric(PARAMS).multiplier(shape, torch.float32, device, True)
    cases = [
        ("warp_unit_bwd", "I(1,1)", warp_unit.sample_displacement_unit,
         (t(rng.standard_normal((1, 1, X, Y, Z))), phiinv), 1e-5, 1.0),
        ("warp_unit_bwd", "I(N,3)", warp_unit.sample_displacement_unit,
         (t(rng.standard_normal(shape)), phiinv), 1e-5, 1.0),
        ("ad_star_bwd", "m0(1,3)", lambda a, b: epdiff_unit.ad_star(a, b)[0],
         (phiinv, t(rng.standard_normal((1, 3, X, Y, Z)))), 1e-5, 1.0),
        ("ad_star_bwd", "m0(N,3)", lambda a, b: epdiff_unit.ad_star(a, b)[0],
         (phiinv, t(rng.standard_normal(shape))), 1e-5, 1.0),
        ("compose_bwd", "s=-0.2", lambda a, b: epdiff_unit.compose(a, b, -0.2)[0],
         (phiinv, t(rng.uniform(-4.9, 4.9, shape))), 1e-5, 1.0),
        ("fluid_flat", "backward", lambda a: fft_unit.fluid_flat(a, Mn),
         (t(rng.standard_normal((2 * ((N * 3 + 1) // 2), X, Y, Z))),), 1e-4, 0.0),
    ]
    log(f"backward kernels at {'x'.join(map(str, shape))}:")
    g1 = t(rng.standard_normal((N, 1, X, Y, Z)))
    g3 = t(rng.standard_normal(shape))
    errs = {}
    for name, label, fn, args, tol, offset in cases:
        leaves, refs = ([a.clone().requires_grad_(True) for a in args] for _ in range(2))
        out = fn(*leaves)
        with plain_versions():
            ref_out = fn(*refs)
        cot = t(rng.standard_normal(tuple(out.shape)))
        before = launch_counts()[name]
        got = torch.autograd.grad(out, leaves, cot)
        check(launch_counts()[name] == before + 1, f"{name} {label}: backward kernel not launched")
        for i, (g, r) in enumerate(zip(got, torch.autograd.grad(ref_out, refs, cot))):
            err = compare(f"{name} {label} d_arg{i}", g, r, tol, offset)
            errs[name] = max(errs.get(name, 0.0), err)
    # the passes sum each output in one fixed order: two launches of K5
    # (atlas and batch-N image), of K6 (batch-1 and batch-N m0) and of K7
    # agree bit for bit
    mws = {label: epdiff_unit._launch_ad_star(*args, want_mw=True)[2]
           for _, label, _, args, _, _ in cases[2:4]}
    for label, launch in (
            ("warp_unit_bwd I(1,1)", lambda: warp_unit._launch_bwd(cases[0][3][0], phiinv, g1)),
            ("warp_unit_bwd I(N,3)", lambda: warp_unit._launch_bwd(cases[1][3][0], phiinv, g3)),
            ("ad_star_bwd m0(1,3)", lambda: epdiff_unit._launch_ad_star_bwd(
                *cases[2][3], g3, mws["m0(1,3)"])),
            ("ad_star_bwd m0(N,3)", lambda: epdiff_unit._launch_ad_star_bwd(
                *cases[3][3], g3, mws["m0(N,3)"])),
            ("compose_bwd", lambda: epdiff_unit._launch_compose_bwd(phiinv, cases[4][3][1], -0.2,
                                                                    g3))):
        first, second = launch(), launch()
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"{label}: two launches differ")
    log("  K5, K6, K7: two launches bit-identical")
    # K6's first pass alone: d_mw rounds as the plain Jacobian transpose
    for _, label, _, args, _, _ in cases[2:4]:
        got = ad_star_bwd_first(*args, g3, mws[label])
        ref = epdiff_unit.ad_star_bwd_first_plain(*args, g3, mws[label])
        compare(f"ad_star_bwd first pass {label} d_mw", got[0], ref[0], 0.0)
        err = compare(f"ad_star_bwd first pass {label} d_phiinv", got[1], ref[1], 1e-5)
        errs["ad_star_bwd"] = max(errs["ad_star_bwd"], err)
        check(all(torch.equal(a, b) for a, b in zip(got, ad_star_bwd_first(*args, g3,
                                                                             mws[label]))),
              f"ad_star_bwd first pass {label}: two launches differ")
    log("  K6's first pass: d_mw bit-equal to the plain version, two launches bit-identical")
    return errs


def ad_star_bwd_first(phiinv, m0, g, mw):
    """K6's first pass alone, through its C entry point (not counted: the
    main path launches it inside K6): ``(d_mw, d_phiinv)``."""
    from lagomorph_tpu_torch.ops.kernels import _build, stream_of

    N, _, X, Y, Z = phiinv.shape
    d_mw, d_p = torch.empty_like(phiinv), torch.empty_like(phiinv)
    _build.call("lagomorph_ad_star_bwd_first", phiinv.data_ptr(), m0.data_ptr(), g.data_ptr(),
                mw.data_ptr(), d_mw.data_ptr(), d_p.data_ptr(), N, m0.shape[0], X, Y, Z, 0,
                stream_of(phiinv))
    return d_mw, d_p


def bench_inputs(device, shape=None):
    """The JAX bench's inputs (bench.py:92-103) at ``shape`` (``FULL`` when
    None), from seed 0."""
    shape = FULL if shape is None else shape
    X = shape[2:]
    rng = np.random.default_rng(0)
    I = rng.standard_normal((1, 1) + X)
    m = rng.standard_normal(shape) * 2e-6
    img = rng.standard_normal((shape[0], 1) + X)
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
    want = {k: 0 for k in launched}
    want.update({"ad_star_fwd": STEPS - 1, "compose_fwd": STEPS - 1, "fluid_flat": STEPS,
                 "warp_unit_fwd": 1 if tier == "unit" else 0})
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


def make_step(lt, metric):
    """The atlas step at the bench's configuration (bench.py:81-89)."""
    return lt.make_lddmm_atlas_step(metric, reg_weight=REG_WEIGHT, learning_rate_pose=LR_POSE,
                                    lddmm_steps=1, integration_steps=STEPS)


def step_chain(step, I, m, img, mode, steps=CHAIN):
    """``steps`` chained atlas steps from ``m`` (``m_new`` feeds the next
    step), then one atlas update ``I - LR_IMAGE * sum(I_grad) / steps``
    (lddmm.py:849-850), through the kernels (``mode`` "kernels") or the
    plain versions ("plain").  Returns per step ``(m, m_new, I_grad, loss,
    launches)`` and the atlas update."""
    from lagomorph_tpu_torch.ops.kernels import launch_counts, plain_versions

    out = []
    grad_sum = torch.zeros_like(I)
    with plain_versions() if mode != "kernels" else contextlib.nullcontext():
        for _ in range(steps):
            before = launch_counts()
            m_new, I_grad, loss, _reg = step(I, m, img)
            after = launch_counts()
            out.append((m, m_new, I_grad, float(loss), {k: after[k] - before[k] for k in after}))
            grad_sum += I_grad
            m = m_new
    return out, -LR_IMAGE * grad_sum / steps


def momentum_grads(metric, I, ms, img, mode):
    """The gradient ``p`` in the momenta that the atlas step applies
    (``lddmm_steps=1``, no preconditioning: ``m_new = m - LR_POSE * p``),
    at each momenta of ``ms``, by the step's own autograd call: through the
    kernels (``mode`` "kernels"), the plain versions ("plain", float32) or
    the plain versions on float64 copies of the inputs ("float64", the
    reference).  Returns ``[(p, loss)]``."""
    from lagomorph_tpu_torch import lddmm
    from lagomorph_tpu_torch.ops.kernels import plain_versions

    dtype = torch.float64 if mode == "float64" else torch.float32
    out = []
    with plain_versions() if mode != "kernels" else contextlib.nullcontext():
        for m in ms:
            m_ = m.detach().to(dtype).requires_grad_(True)
            I_ = I.detach().to(dtype).requires_grad_(True)
            loss, _ = lddmm._lddmm_loss(I_, m_, img.to(dtype), metric, REG_WEIGHT, STEPS)
            out.append((torch.autograd.grad(loss, (m_, I_))[0], float(loss.detach())))
    return out


def rel_l2(a, ref):
    return float((a.double() - ref.double()).norm() / ref.double().norm())


def top_share(a, ref, k=100):
    """The share of ``|a - ref|^2`` carried by its ``k`` largest voxels."""
    sq = (a.double() - ref.double()).flatten() ** 2
    return float(sq.topk(k).values.sum() / sq.sum())


def step_compare(label, got, ref, grads, p_tol, grad_tol=1e-5, loss_tol=1e-5):
    """Hold the kernel path's atlas steps (``got``) against the plain
    versions' (``ref``, float32), and the momentum gradient that each step
    applied against a float64 one.

    The loss (relative) and the atlas gradient (relative to max|ref|) are
    held to the plain float32 path.  ``grads[mode]`` holds
    ``momentum_grads`` at each of the kernel path's momenta: the kernels'
    ``p`` must lie within ``p_tol`` of the float64 ``p`` in relative L2
    norm, with the plain float32 ``p`` logged beside it as the control, and
    the step's ``m_new`` must be ``m - LR_POSE * p`` to within one float32
    ulp of max|m| (plus 1e-5 of max|LR_POSE * p| for the atomic sums of
    autograd's gather backward on the fallback), so the ``p`` held is the
    one applied.  The largest error of ``p`` is logged, not held: it sits in
    a few voxels (the share of the squared error that the worst 100 voxels
    carry is logged), and moves between steps whose momenta barely differ.
    The update ``m_new - m`` is not compared either: ``m_new`` is rounded at
    |m|, so the update carries up to half an ulp of |m|, 2e-4 of
    max|update| at the bench momenta and 0.15 at max|v0| = 0.5."""
    for i, (g, r) in enumerate(zip(got, ref)):
        g_m, g_new, g_I, g_loss, _ = g
        _, _, r_I, r_loss, _ = r
        (p_k, _), (p_p, _), (p_64, loss64) = (grads[k][i] for k in ("kernels", "plain", "float64"))
        scale = float(p_64.abs().max())
        l2_k, l2_p, l2_kp = rel_l2(p_k, p_64), rel_l2(p_p, p_64), rel_l2(p_k, p_p)
        top = [top_share(p, p_64) for p in (p_k, p_p)]
        applied = max_err(g_new, g_m - LR_POSE * p_k)
        ulp = float(g_m.abs().max()) * 2.0**-23 + LR_POSE * 1e-5 * float(p_k.abs().max())
        rel = abs(g_loss - r_loss) / abs(r_loss)
        e_I = max_err(g_I, r_I) / float(r_I.abs().max())
        log(f"  {label} step {i + 1}: loss={g_loss!r} plain={r_loss!r} float64={loss64!r} "
            f"rel={rel:.3e}; I_grad rel err={e_I:.3e}; p vs float64, l2 (max): kernels "
            f"{l2_k:.3e} ({max_err(p_k, p_64) / scale:.3e}), plain {l2_p:.3e} "
            f"({max_err(p_p, p_64) / scale:.3e}), kernels vs plain {l2_kp:.3e} "
            f"({max_err(p_k, p_p) / scale:.3e}); worst 100 voxels' share of the squared error: "
            f"kernels {top[0]:.3f}, plain {top[1]:.3f}; max|p|={scale:.4e}; "
            f"m_new - (m - lr p) {applied:.3e} (bound {ulp:.3e}), max|m|={float(g_m.abs().max()):.4e}")
        check(np.isfinite(applied) and applied <= ulp,
              f"{label} step {i + 1}: m_new is not m - lr * p ({applied:.3e} > {ulp:.3e})")
        for name, err, tol in (("loss", rel, loss_tol), ("I_grad", e_I, grad_tol),
                               ("p (relative l2)", l2_k, p_tol)):
            check(np.isfinite(err) and err <= tol,
                  f"{label} step {i + 1}: {name} differs by {err:.3e} relative > {tol:.3e}")


def atlas_steps(lt, metric, I, m, img, m_half):
    """Phase 6, the main path: ``CHAIN`` chained atlas steps through the
    kernels and through the plain versions, at the bench's momenta and at
    max|v0| = 0.5, with the momentum gradient at each of the kernel path's
    momenta through the kernels, the plain versions and in float64.  The
    launch counters are set to 0 just before the bench momenta's kernel
    steps and read just after: every kernel must have run, and each step
    must make ``STEP_LAUNCHES``.  Returns those counts."""
    from lagomorph_tpu_torch.ops import kernels

    step = make_step(lt, metric)
    main = None
    for label, mm in (("bench momenta (x2e-6)", m), ("max|v0| = 0.5", m_half)):
        if main is None:
            kernels.reset_launches()
        got, dI = step_chain(step, I, mm, img, "kernels")
        if main is None:
            main = kernels.launch_counts()
        ref, dI_ref = step_chain(step, I, mm, img, "plain")
        grads = {mode: momentum_grads(metric, I, [g[0] for g in got], img, mode)
                 for mode in ("kernels", "plain", "float64")}
        log(f"atlas steps, {label}: {CHAIN} chained steps through the kernels vs the plain "
            "versions (float32); momentum gradients vs float64")
        want = {k: 0 for k in got[0][4]}
        want.update(STEP_LAUNCHES)
        for i, g in enumerate(got):
            check(g[4] == want, f"{label} step {i + 1}: launches {g[4]}, want {want}")
            check(tuple(g[1].shape) == FULL and tuple(g[2].shape) == tuple(I.shape),
                  f"{label}: step outputs of the wrong shape")
        check(all(sum(r[4].values()) == 0 for r in ref),
              f"{label}: the plain path launched a kernel")
        step_compare(label, got, ref, grads, P_TOL)
        e = max_err(dI, dI_ref) / float(dI_ref.abs().max())
        log(f"  {label} atlas update: rel err={e:.3e} (max|dI|={float(dI_ref.abs().max()):.4e}); "
            f"launches per step {got[0][4]}")
        check(e <= 1e-5, f"{label}: atlas update differs by {e:.3e} relative > 1e-5")
        del got, ref, grads
    log(f"main path (atlas steps at the bench momenta) launches: {main}")
    others = KERNELS_2D + KERNELS_2D_PER_OP + KERNELS_SOLVE
    check(all(n > 0 for k, n in main.items() if k not in others),
          f"a kernel of the 3D path was not launched: {main}")
    check(all(main[k] == 0 for k in others),
          f"a 2D kernel or a selector's solve ran in a default 3D step: {main}")
    return main


def fallback_inputs(device, shape, seed):
    """Standard normal momenta, atlas and images at ``shape`` from
    ``seed``."""
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s), dtype=torch.float32, device=device)
            for s in (shape, (1, 1) + shape[2:], (shape[0], 1) + shape[2:])]


def fallback_step(lt, device, params, max_v0, m, I, img):
    """One atlas step with ``FluidMetric(params)`` on the momenta ``m``
    scaled so that their substeps leave the unit regime, the initial
    velocity peaking at ``max_v0`` voxels (8: from the first substep; 2:
    from the third): the hoisted path's flag trips and the shooting re-runs
    ``_expmap_general``, which picks each warp's tier, so in 2D its
    unit-regime warps run K10-K13.  Through the kernels and the plain
    versions, with its momentum gradient held against a float64 one and the
    peak device memory of each."""
    from lagomorph_tpu_torch import lddmm

    metric = lt.FluidMetric(params)
    shape = tuple(m.shape)
    m = m * (max_v0 / float(metric.sharp(m).abs().max()))
    label = f"fallback {'x'.join(map(str, shape))}, beta={params[1]}, max|v0| = {max_v0:g}"
    dt = 1.0 / STEPS
    v0 = metric.sharp(m)
    _, ok = lddmm._expmap_fast_flagged(metric, m, dt, STEPS - 1, -dt * v0, None)
    check(not bool(ok), f"{label}: the hoisted flag did not trip")
    step = make_step(lt, metric)
    runs = {}
    for mode in ("kernels", "plain"):
        torch.cuda.reset_peak_memory_stats(device)
        runs[mode] = step_chain(step, I, m, img, mode, steps=1)[0]
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        was = ""
        if mode == "kernels" and shape == FULL:
            was = (f" (the general substeps rematerialised; {FALLBACK_PEAK_UNREMAT_GIB:.2f} GiB "
                   "with every substep's intermediates kept)")
            check(peak < FALLBACK_PEAK_UNREMAT_GIB, f"{label}: peak {peak:.2f} GiB")
        log(f"  {label} ({mode}): peak device memory {peak:.2f} GiB{was}")
    grads = {mode: momentum_grads(metric, I, [m], img, mode)
             for mode in ("kernels", "plain", "float64")}
    launched = {k: n for k, n in runs["kernels"][0][4].items() if n}
    log(f"{label}: launches {launched}")
    fast = ("ad_star_fwd", "compose_fwd") if len(shape) == 5 else KERNELS_2D_PER_OP[:2]
    check(all(launched.get(k, 0) >= STEPS - 1 for k in fast),
          f"{label}: the fast path did not run first")
    if len(shape) == 4:
        check(all(k in KERNELS_2D_PER_OP for k in launched),
              f"{label}: a kernel off the 2D per-substep path ran: {launched}")
        check(max_v0 > 2 or (launched["ad_star2d_fwd"] > STEPS - 1
                             and launched.get("ad_star2d_bwd", 0) > 0
                             and launched.get("compose2d_bwd", 0) > 0),
              f"{label}: the general re-run took no kernel on its unit-regime warps")
    step_compare(label, runs["kernels"], runs["plain"], grads, FALLBACK_P_TOL, grad_tol=1e-4)


def shoot_grid(shoot2d, N, H, W, fwd=False):
    """K8's (``fwd``) or K9's launch at ``N`` subjects of ``(H, W)``, in
    words."""
    c = (shoot2d.fwd_launch_config if fwd else shoot2d.bwd_launch_config)(N, H, W)
    return (f"{c['path']} path, {c['tile']}-line tiles, {c['blocks']} blocks of {c['threads']}, "
            f"{c['smem']} B of shared memory, tiles of phases {'A-C' if fwd else '1-3'}: "
            f"{', '.join(map(str, c['tiles']))}")


def shoot2d_checks(lt, device, shape, seed):
    """Phase 3, 2D, at one shape: K8 (phiinv_T, the flag, the stashed
    trajectory) and K9 (d_phiinv0, d_m0 on the plain trajectory) against
    their plain versions on the same inputs, 4 substeps at s = -0.2 from
    momenta scaled to max|v0| = 0.5 (batch N and batch 1, whose d_m0 K9
    sums over the subjects), within 1e-4 * max|ref| (float32 transforms
    against cuFFT, as K3), K8's traj_phiinv[0] and traj_mw[0] (before any
    transform) bit-equal, a second launch of K8 and of K9 bit-identical, and a
    displacement of 1.5 in phiinv0 must trip both flags; then the wrapper ``shoot2d.shoot2d`` under
    ``torch.autograd.grad`` (K8 forward, K9 backward, one launch each, with
    a non-contiguous cotangent) against autograd of the plain versions, on
    momenta whose displacements stay off the integers.  Returns {kernel:
    err}."""
    from lagomorph_tpu_torch.ops.kernels import launch_counts, plain_versions, shoot2d

    N, _, H, W = shape
    rng = np.random.default_rng(seed)
    Mn = lt.FluidMetric(PARAMS).packed_multiplier((H, W), torch.float32, device)
    s, T = -1.0 / STEPS, STEPS - 1
    errs = {"shoot2d_fwd": 0.0, "shoot2d_bwd": 0.0}
    tag = "x".join(map(str, shape))
    log(f"2D whole-shoot kernels at {tag}:")
    log(f"  K8's launch: {shoot_grid(shoot2d, N, H, W, fwd=True)}")
    log(f"  K9's launch: {shoot_grid(shoot2d, N, H, W)}")

    def hold(name, label, pairs):
        for what, g, r in pairs:
            errs[name] = max(errs[name], compare(f"{name} {label} {what}", g, r, 1e-4, 0.0))

    for label, nb in (("m0(N,2)", N), ("m0(1,2)", 1)):
        m0 = torch.as_tensor(rng.standard_normal((nb, 2, H, W)), dtype=torch.float32, device=device)
        m0 = m0 * (0.5 / float(shoot2d.fluid2d_plain(m0, Mn).abs().max()))
        phiinv0 = (s * shoot2d.fluid2d_plain(m0, Mn)).expand(N, -1, -1, -1).contiguous()
        got = shoot2d._launch_fwd(phiinv0, m0, Mn, s, T, True)
        ref = shoot2d.shoot2d_fwd_plain(phiinv0, m0, Mn, s, T)
        hold("shoot2d_fwd", label, zip(("phiinv_T", "traj_phiinv", "traj_v", "traj_mw"),
                                       got[:1] + got[2:], ref[:1] + ref[2:]))
        check(bool(got[1]) and bool(ref[1]), f"shoot2d_fwd {label}: in-regime flag false")
        check(torch.equal(got[2][0], ref[2][0]) and torch.equal(got[4][0], ref[4][0]),
              f"shoot2d_fwd {label}: traj_phiinv[0] or traj_mw[0] not bit-equal")
        again = shoot2d._launch_fwd(phiinv0, m0, Mn, s, T, True)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"shoot2d_fwd {label}: two launches differ")
        cot = torch.as_tensor(rng.standard_normal((N, 2, H, W)), dtype=torch.float32, device=device)
        d = shoot2d._launch_bwd(m0, cot, *ref[2:], Mn, s)
        hold("shoot2d_bwd", label, zip(("d_phiinv0", "d_m0"), d,
                                       shoot2d.shoot2d_bwd_plain(m0, cot, *ref[2:], Mn, s)))
        again = shoot2d._launch_bwd(m0, cot, *ref[2:], Mn, s)
        check(all(torch.equal(a, b) for a, b in zip(d, again)),
              f"shoot2d_bwd {label}: two launches differ")
        bad = phiinv0.clone()
        bad.view(-1)[bad.numel() // 3] = 1.5
        _, gf = shoot2d.shoot2d(bad, m0, Mn, s, T)
        _, rf = shoot2d.shoot2d_fwd_plain(bad, m0, Mn, s, T, stash=False)
        check(not bool(gf) and not bool(rf), f"shoot2d_fwd {label}: tripped flag not false")
    log("  flags: equal in and out of the unit regime; K8's traj_phiinv[0] and traj_mw[0] "
        "bit-equal; two launches of K8 and of K9 bit-identical")

    # The wrapper and its autograd.Function, as the main path calls them,
    # against autograd of the plain versions.  The two float32 forwards
    # differ by ~1e-7 voxel, and where a warp displacement lies that close to
    # an integer the weights' slopes jump, so the gradients would differ by
    # O(1) there.  These momenta drift by s*v = -0.15 per substep, with a
    # perturbation of at most 0.01, which keeps every displacement of the
    # trajectory 0.05 or more from the integers (checked).  The cotangent is
    # a transposed view, which the backward must make contiguous.
    for label, nb in (("m0(N,2)", N), ("m0(1,2)", 1)):
        pert = torch.as_tensor(rng.standard_normal((nb, 2, H, W)), dtype=torch.float32,
                               device=device)
        pert = pert * (0.01 / abs(s) / float(shoot2d.fluid2d_plain(pert, Mn).abs().max()))
        m0 = pert + 0.15 / abs(s) / float(Mn[0, 0])  # Mn[0, 0]: the solve's gain at k = 0
        phiinv0 = (s * shoot2d.fluid2d_plain(m0, Mn)).expand(N, -1, -1, -1).contiguous()
        _, _, traj_p, traj_v, _ = shoot2d.shoot2d_fwd_plain(phiinv0, m0, Mn, s, T)
        gap = min(float((d - d.round()).abs().min()) for d in (traj_p, s * traj_v))
        check(gap >= 0.05, f"shoot2d {label}: a displacement lies {gap:.3e} from an integer")
        leaves, refs = ([x.clone().requires_grad_(True) for x in (phiinv0, m0)] for _ in range(2))
        cot_t = torch.as_tensor(rng.standard_normal((N, 2, W, H)), dtype=torch.float32,
                                device=device).transpose(2, 3)
        before = launch_counts()
        out, flag = shoot2d.shoot2d(*leaves, Mn, s, T)
        d_got = torch.autograd.grad(out, leaves, cot_t)
        after = launch_counts()
        check(after["shoot2d_fwd"] == before["shoot2d_fwd"] + 1
              and after["shoot2d_bwd"] == before["shoot2d_bwd"] + 1,
              f"shoot2d {label}: the wrapper did not launch K8 and K9 once each")
        with plain_versions():
            ref_out, ref_flag = shoot2d.shoot2d(*refs, Mn, s, T)
        d_ref = torch.autograd.grad(ref_out, refs, cot_t)
        check(bool(flag) and bool(ref_flag), f"shoot2d {label}: in-regime flag false")
        check(tuple(d_got[1].shape) == (nb, 2, H, W), f"shoot2d {label}: d_m0 of the wrong shape")
        hold("shoot2d_fwd", f"{label} wrapper", [("phiinv_T", out.detach(), ref_out.detach())])
        hold("shoot2d_bwd", f"{label} autograd", zip(("d_phiinv0", "d_m0"), d_got, d_ref))
    log(f"  wrapper under autograd: K8 and K9 once per call; displacements >= {gap:.3f} "
        "from the integers")
    return errs


def epdiff2d_checks(device, shape, seed):
    """Phase 3, 2D per-substep kernels, at one shape: K10 (out, ``mw``,
    flag) and K11 (out, flag; s = -0.2) against their plain versions, K12
    and K13 against the plain backwards on the same inputs, with batch-1
    (d_m0 summed over the subjects) and batch-N momenta, all within 1e-5 *
    (1 + max|ref|); K10 (with ``mw`` and without) and K11 on their column
    strips, at the chooser's band height and at ``FORCED_BANDS`` rows,
    ``torch.equal`` to the plain versions and to their per-thread route
    (``march`` -1), flags equal; K12 on its row tiles (batch-N m0)
    ``torch.equal`` to its per-thread route, and a second launch of K12 and
    of K13 bit-identical;
    inputs that trip each flag (and an in-regime edge value) give equal
    flags both ways; then the wrappers ``ad_star2d`` and ``compose2d`` under
    ``torch.autograd.grad`` (forward and backward kernel once each, a
    transposed cotangent) against autograd of the plain versions.  Returns
    {kernel: err}."""
    from lagomorph_tpu_torch.ops.kernels import epdiff2d, launch_counts, plain_versions

    N, _, H, W = shape
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    p = t(rng.uniform(-0.99, 0.99, shape))
    v = t(rng.uniform(-4.9, 4.9, shape))  # s*v in (-0.98, 0.98) at s = -0.2
    s = -0.2
    errs = {k: 0.0 for k in KERNELS_2D_PER_OP}
    log(f"2D per-substep kernels at {'x'.join(map(str, shape))}:")
    check(epdiff2d.bwd_route(N, N, H, W) == "tile"
          and epdiff2d.bwd_route(N, 1, H, W) == "thread", "K12's routes")
    c = epdiff2d.bwd_launch_config(N, H, W)
    log(f"  K12's launch (batch-N m0): {c['tile']}-row tiles, {c['blocks']} blocks of "
        f"{c['threads']}, {c['smem']} B of shared memory")

    for name in ("ad_star2d_fwd", "compose2d_fwd"):
        c = epdiff2d.fwd_launch_config(name, N, H, W)
        log(f"  {name}'s strips: {c['px']} columns a thread, bands of {c['rj']} rows, "
            f"{c['blocks']} blocks of {c['threads']} ({c['per_sm']} an SM)")

    def hold(name, label, pairs):
        for what, g, r in pairs:
            errs[name] = max(errs[name], compare(f"{name} {label} {what}", g, r, 1e-5))

    def bit_equal(name, label, got, refs):
        """Outputs ``got`` against each output tuple of ``refs``, bit for bit."""
        for ref in refs:
            check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                  f"{name} {label}: not bit-equal")

    def same_bits(name, label, launch, thread=None):
        """A launch's outputs against a second launch's and, if given, the
        per-thread route's."""
        got = launch()
        check(all(torch.equal(a, b) for a, b in zip(got, launch())),
              f"{name} {label}: two launches differ")
        if thread is not None:
            check(all(torch.equal(a, b) for a, b in zip(got, thread())),
                  f"{name} {label}: the tiles differ from the per-thread route")

    for label, nb in (("m0(N,2)", N), ("m0(1,2)", 1)):
        m0 = t(rng.standard_normal((nb, 2, H, W)))
        out, flag, mw = epdiff2d._launch_ad_star(p, m0, want_mw=True)
        r_out, r_flag, r_mw = epdiff2d.ad_star2d_plain(p, m0, want_mw=True)
        hold("ad_star2d_fwd", label, [("out", out, r_out), ("mw", mw, r_mw)])
        check(bool(flag) and bool(r_flag), f"ad_star2d_fwd {label}: in-regime flag false")
        thread = epdiff2d._launch_ad_star(p, m0, want_mw=True, march=epdiff2d.THREAD)
        bit_equal("ad_star2d_fwd", f"{label} per-thread route", thread[::2], [(r_out, r_mw)])
        for march in (0, *FORCED_BANDS):
            got = epdiff2d._launch_ad_star(p, m0, want_mw=True, march=march)
            bit_equal("ad_star2d_fwd", f"{label} march {march}", got[::2],
                      [(r_out, r_mw), thread[::2]])
            bit_equal("ad_star2d_fwd", f"{label} march {march} without mw",
                      epdiff2d._launch_ad_star(p, m0, march=march)[:1], [(r_out,)])
            check(bool(got[1]) and bool(thread[1]), f"ad_star2d_fwd {label}: flag false")
        g = t(rng.standard_normal(shape))
        hold("ad_star2d_bwd", label, zip(("d_phiinv", "d_m0"),
                                         epdiff2d._launch_ad_star_bwd(p, m0, g, r_mw),
                                         epdiff2d.ad_star2d_bwd_plain(p, m0, g, r_mw)))
        same_bits("ad_star2d_bwd", label, lambda: epdiff2d._launch_ad_star_bwd(p, m0, g, r_mw),
                  (lambda: epdiff2d._launch_ad_star_bwd(p, m0, g, r_mw, epdiff2d.THREAD))
                  if nb == N else None)
        bad = p.clone()
        bad.view(-1)[:: 1 + bad.numel() // 7] = 1.0  # the upper bound is open
        bad.view(-1)[5] = -1.5
        _, gf = epdiff2d.ad_star2d(bad, m0)
        with plain_versions():
            _, rf = epdiff2d.ad_star2d(bad, m0)
        tf = epdiff2d._launch_ad_star(bad, m0, march=epdiff2d.THREAD)[1]
        check(not bool(gf) and not bool(rf) and not bool(tf),
              f"ad_star2d_fwd {label}: tripped flag not false")
    out, flag = epdiff2d.compose2d(p, v, s)
    r_out, r_flag = epdiff2d.compose2d_plain(p, v, s)
    hold("compose2d_fwd", "s=-0.2", [("out", out, r_out)])
    check(bool(flag) and bool(r_flag), "compose2d_fwd: in-regime flag false")
    thread = epdiff2d._launch_compose(p, v, s, march=epdiff2d.THREAD)
    bit_equal("compose2d_fwd", "per-thread route", thread[:1], [(r_out,)])
    for march in (0, *FORCED_BANDS):
        got = epdiff2d._launch_compose(p, v, s, march=march)
        bit_equal("compose2d_fwd", f"march {march}", got[:1], [(r_out,), thread[:1]])
        check(bool(got[1]) and bool(thread[1]), f"compose2d_fwd march {march}: flag false")
    g = t(rng.standard_normal(shape))
    hold("compose2d_bwd", "s=-0.2", zip(("d_phiinv", "d_v"),
                                        epdiff2d._launch_compose_bwd(p, v, s, g),
                                        epdiff2d.compose2d_bwd_plain(p, v, s, g)))
    same_bits("compose2d_bwd", "s=-0.2", lambda: epdiff2d._launch_compose_bwd(p, v, s, g))
    # s*v = 1.02 lies outside; s*v == -1.0 inside (the lower bound is closed)
    for value, inside in ((-5.1, False), (5.0, True)):
        edge_v = v.clone()
        edge_v.view(-1)[edge_v.numel() // 2] = value
        _, gf = epdiff2d.compose2d(p, edge_v, s)
        _, rf = epdiff2d.compose2d_plain(p, edge_v, s)
        _, tf = epdiff2d._launch_compose(p, edge_v, s, march=epdiff2d.THREAD)
        check(bool(gf) is bool(rf) is bool(tf) is inside,
              f"compose2d_fwd: flags {bool(gf)}, {bool(rf)} at s*v = {s * value}")
    log(f"  flags: equal in and out of the unit regime; K10 (out, mw) and K11 on their strips "
        f"(bands: the chooser's, {FORCED_BANDS}) bit-equal to the plain versions and to their "
        "per-thread route; K12 on its tiles bit-equal to its per-thread route; two launches of "
        "K12 and of K13 bit-identical")

    # the wrappers and their autograd.Functions, as the main path calls them
    cases = (("ad_star2d", lambda a, b: epdiff2d.ad_star2d(a, b),
              (p, t(rng.standard_normal((1, 2, H, W))))),
             ("compose2d", lambda a, b: epdiff2d.compose2d(a, b, s), (p, v)))
    for name, fn, args in cases:
        leaves, refs = ([x.clone().requires_grad_(True) for x in args] for _ in range(2))
        cot = t(rng.standard_normal((N, 2, W, H))).transpose(2, 3)
        before = launch_counts()
        out, flag = fn(*leaves)
        d_got = torch.autograd.grad(out, leaves, cot)
        after = launch_counts()
        check(after[f"{name}_fwd"] == before[f"{name}_fwd"] + 1
              and after[f"{name}_bwd"] == before[f"{name}_bwd"] + 1,
              f"{name}: the wrapper did not launch its forward and backward kernels once each")
        with plain_versions():
            ref_out, ref_flag = fn(*refs)
        d_ref = torch.autograd.grad(ref_out, refs, cot)
        check(bool(flag) and bool(ref_flag), f"{name} wrapper: in-regime flag false")
        hold(f"{name}_fwd", "wrapper", [("out", out.detach(), ref_out.detach())])
        hold(f"{name}_bwd", "autograd", zip(("d_arg0", "d_arg1"), d_got, d_ref))
    log("  wrappers under autograd: forward and backward kernels once per call")
    return errs


def solve_checks(lt, device, shape, seed, radix=True, whole=True):
    """Phase 3, the fluid solves at one shape: K3 against its plain version
    (the ``torch.fft`` packed solve; 128^3 and 64^3 take its plane path,
    (3, 3, 32, 64, 128) and (1, 3, 4, 256, 256) its line path, (3, 3, 96,
    80, 112) and (1, 3, 512, 8, 512) its tile path), K14 forward (a
    bit-reversed spectrum) and inverse, K15 on that spectrum and the
    pipeline K14, K15, K14 against their plain versions (power-of-two axes),
    and K16 against its plain version (the ``torch.fft`` packed solve), on
    the packed pairs ``fluid_operator`` builds (an odd slab count carries
    one zero slab), within 1e-4 * max|ref|; then K3, the pipeline and K16
    under ``torch.autograd.grad`` (1 launch, 3, or 1, each way; one
    transposed cotangent) against autograd of the plain versions.  Where
    K3 takes a register path (128^3 and 64^3 its plane path, (3, 3, 32, 64,
    128) and (1, 3, 4, 256, 256) its line path) the pipeline runs K3's
    passes with the spectrum in bit-reversed order, and K16 runs them as
    its phases: both must be bit-equal to K3, forward and backward.
    Returns {kernel: err}."""
    from lagomorph_tpu_torch.ops import fluid
    from lagomorph_tpu_torch.ops.kernels import (fft_radix, fft_unit, fft_whole, launch_counts,
                                                 plain_versions)

    N, _, X, Y, Z = shape
    rng = np.random.default_rng(seed)
    F = (N * 3 + 1) // 2
    x = torch.as_tensor(rng.standard_normal((2 * F, X, Y, Z)), dtype=torch.float32, device=device)
    if (N * 3) % 2:
        x[-1] = 0
    cot = torch.as_tensor(rng.standard_normal((2 * F, Z, Y, X)), dtype=torch.float32,
                          device=device).transpose(1, 3)

    def multiplier(route):
        return fluid.form_multiplier(fluid.multiplier_form(route), (X, Y, Z), PARAMS, True,
                                     torch.float32, device)

    def both(fn, *args):
        got = fn(*args)
        with plain_versions():
            ref = fn(*args)
        return got, ref

    def hold(name, label, got, ref):
        errs[name] = max(errs.get(name, 0.0), compare(f"{name} {label}", got, ref, 1e-4, 0.0))

    def under_autograd(names, per_call, fn, label):
        leaf, ref_leaf = (x.clone().requires_grad_(True) for _ in range(2))
        before = launch_counts()
        out = fn(leaf)
        (got,) = torch.autograd.grad(out, leaf, cot)
        after = launch_counts()
        check(all(after[k] == before[k] + 2 * n for k, n in zip(names, per_call)),
              f"{label}: launches {[after[k] - before[k] for k in names]} under autograd, "
              f"want {[2 * n for n in per_call]}")
        with plain_versions():
            (ref,) = torch.autograd.grad(fn(ref_leaf), ref_leaf, cot)
        for k in names:
            hold(k, f"{label} autograd", got, ref)
        return got

    errs = {}
    log(f"fluid solves at {'x'.join(map(str, shape))}:")
    Mn = multiplier("fluid_flat")
    flat, ref = both(fft_unit.fluid_flat, x, Mn)
    hold("fluid_flat", "forward", flat, ref)
    flat_grad = under_autograd(("fluid_flat",), (1,), lambda a: fft_unit.fluid_flat(a, Mn),
                               "fluid_flat")
    if radix:
        Mbr = multiplier("fluid_radix")
        spec, ref = both(fft_radix.radix_zy, x, False)
        hold("fluid_radix_zy", "forward", spec, ref)
        hold("fluid_radix_zy", "inverse", *both(fft_radix.radix_zy, spec, True))
        hold("fluid_radix_x", "on the spectrum", *both(fft_radix.radix_x, spec, Mbr))
        got, ref = both(fft_radix.fluid_radix, x, Mbr)
        for k in ("fluid_radix_zy", "fluid_radix_x"):
            hold(k, "pipeline", got, ref)
        got_grad = under_autograd(("fluid_radix_zy", "fluid_radix_x"), (2, 1),
                                  lambda a: fft_radix.fluid_radix(a, Mbr), "pipeline")
        if not fft_unit.needs_scratch(X, Y, Z):
            check(torch.equal(got, flat) and torch.equal(got_grad, flat_grad),
                  f"K14, K15, K14 at {shape}: not bit-equal to K3 (max diff "
                  f"{max_err(got, flat):.3e}, backward {max_err(got_grad, flat_grad):.3e})")
            log("  pipeline K14, K15, K14: bit-equal to K3, forward and backward")
    if whole:
        Mn = multiplier("fluid_whole")
        cfg = fft_whole.launch_config(X, Y, Z)
        log(f"  fluid_whole launch: {cfg['path']} path, cooperative grid of {cfg['blocks']} "
            f"blocks x {cfg['threads']} threads, {cfg['smem']} B shared memory a block")
        got, ref = both(fft_whole.fluid_whole, x, Mn)
        hold("fluid_whole", "forward", got, ref)
        got_grad = under_autograd(("fluid_whole",), (1,),
                                  lambda a: fft_whole.fluid_whole(a, Mn), "fluid_whole")
        if not fft_unit.needs_scratch(X, Y, Z):
            check(torch.equal(got, flat) and torch.equal(got_grad, flat_grad),
                  f"fluid_whole at {shape}: not bit-equal to K3 on its {cfg['path']} path "
                  f"(max diff {max_err(got, flat):.3e}, backward {max_err(got_grad, flat_grad):.3e})")
            log(f"  fluid_whole {cfg['path']} path: bit-equal to K3, forward and backward")
    return errs


def atlas_steps_2d(lt, device, params=PARAMS, launches=STEP2D_LAUNCHES):
    """Phases 6b and 6c, the 2D main paths: ``CHAIN`` chained 2D atlas steps
    with ``FluidMetric(params)`` at 256^2 b8 and 512^2 b8 on bench.py's
    inputs, and at 256^2 b8 on its momenta scaled to max|v0| = 0.5, through
    the kernels and the plain versions, each step's momentum gradient held
    against a float64 one.  The counters are set to 0 just before the 256^2
    bench momenta's kernel steps and read just after: each step must make
    ``launches`` (6b, ``beta == 0``: K8 and K9 once; 6c, ``beta != 0``:
    K10-K13 four times each), and no other kernel may run.  Returns those
    counts."""
    from lagomorph_tpu_torch.ops import kernels

    metric = lt.FluidMetric(params)
    step = make_step(lt, metric)
    tag = f"2D beta={params[1]}"
    main = None
    for shape, half in ((FULL2D, False), (FULL2D, True), (FULL2D_512, False)):
        I, m, img = bench_inputs(device, shape)
        label = f"{tag} {shape[2]}^2 b{shape[0]}, bench momenta (x2e-6)"
        if half:
            m = m * (0.5 / float(metric.sharp(m).abs().max()))
            label = f"{tag} {shape[2]}^2 b{shape[0]}, max|v0| = 0.5"
        if main is None:
            kernels.reset_launches()
        got, dI = step_chain(step, I, m, img, "kernels")
        if main is None:
            main = kernels.launch_counts()
        ref, dI_ref = step_chain(step, I, m, img, "plain")
        grads = {mode: momentum_grads(metric, I, [g[0] for g in got], img, mode)
                 for mode in ("kernels", "plain", "float64")}
        log(f"atlas steps, {label}: {CHAIN} chained steps through the kernels vs the plain "
            "versions (float32); momentum gradients vs float64")
        want = {k: 0 for k in got[0][4]}
        want.update(launches)
        for i, g in enumerate(got):
            check(g[4] == want, f"{label} step {i + 1}: launches {g[4]}, want {want}")
            check(tuple(g[1].shape) == shape and tuple(g[2].shape) == tuple(I.shape),
                  f"{label}: step outputs of the wrong shape")
        check(all(sum(r[4].values()) == 0 for r in ref), f"{label}: the plain path launched a kernel")
        step_compare(label, got, ref, grads, P_TOL)
        e = max_err(dI, dI_ref) / float(dI_ref.abs().max())
        log(f"  {label} atlas update: rel err={e:.3e}; launches per step {got[0][4]}")
        check(e <= 1e-5, f"{label}: atlas update differs by {e:.3e} relative > 1e-5")
        del got, ref, grads
    log(f"{tag} main path (atlas steps at 256^2 b8) launches: {main}")
    check(all(main[k] > 0 for k in launches), f"a {tag} kernel was not launched: {main}")
    check(all(n == 0 for k, n in main.items() if k not in launches),
          f"a kernel off the {tag} path ran: {main}")
    return main


@contextlib.contextmanager
def selected(setter, value):
    """The selector ``setter`` at ``value`` for the block, restored after
    it."""
    prev = setter(value)
    try:
        yield
    finally:
        setter(prev)


def selector_steps(lt, device, shape, setter, value, launches):
    """Phases 6d and 6e: ``CHAIN`` chained 3D atlas steps at ``shape`` on
    bench.py's inputs with the selector ``setter`` at ``value`` (restored
    after), through the kernels and the plain versions, each step's
    momentum gradient held against a float64 one (``P_TOL``) and ``m_new ==
    m - lr p`` to an ulp.  The counters are set to 0 just before the kernel
    steps and read just after: each step must make ``launches`` and no
    other kernel may run.  Returns those counts."""
    from lagomorph_tpu_torch.ops import fluid, kernels

    metric = lt.FluidMetric(PARAMS)
    step = make_step(lt, metric)
    I, m, img = bench_inputs(device, shape)
    label = f"{setter.__name__}({value!r}) {shape[2]}^3 b{shape[0]}, bench momenta (x2e-6)"
    with selected(setter, value):
        route = fluid.fluid_route(shape, PARAMS)
        kernels.reset_launches()
        got, dI = step_chain(step, I, m, img, "kernels")
        main = kernels.launch_counts()
        ref, dI_ref = step_chain(step, I, m, img, "plain")
        grads = {mode: momentum_grads(metric, I, [g[0] for g in got], img, mode)
                 for mode in ("kernels", "plain", "float64")}
    log(f"atlas steps, {label}: route {route}; {CHAIN} chained steps through the kernels vs the "
        "plain versions (float32); momentum gradients vs float64")
    want = {k: 0 for k in got[0][4]}
    want.update(launches)
    for i, g in enumerate(got):
        check(g[4] == want, f"{label} step {i + 1}: launches {g[4]}, want {want}")
        check(tuple(g[1].shape) == shape and tuple(g[2].shape) == tuple(I.shape),
              f"{label}: step outputs of the wrong shape")
    check(all(sum(r[4].values()) == 0 for r in ref), f"{label}: the plain path launched a kernel")
    step_compare(label, got, ref, grads, P_TOL)
    e = max_err(dI, dI_ref) / float(dI_ref.abs().max())
    log(f"  {label} atlas update: rel err={e:.3e}; launches per step {got[0][4]}")
    check(e <= 1e-5, f"{label}: atlas update differs by {e:.3e} relative > 1e-5")
    log(f"{label} main path launches: {main}")
    return main


def default_step_64(lt, device):
    """Phase 6e, beside the whole-volume path: the route each setting of
    ``set_fluid_mxu_whole`` gives at 64^3 b4 and at 128^3 b4, then one
    atlas step at 64^3 b4 on the default selectors (K3, as every default 3D
    step) against the plain versions."""
    from lagomorph_tpu_torch.ops import fluid

    for value in (False, "auto", True):
        with selected(lt.set_fluid_mxu_whole, value):
            log(f"route at 64^3 b4 / 128^3 b4 under set_fluid_mxu_whole({value!r}): "
                f"{fluid.fluid_route(FULL64, PARAMS)} / {fluid.fluid_route(FULL, PARAMS)}")
    check(fluid.fluid_route(FULL64, PARAMS) == "fluid_flat", "the default route is not K3")
    step = make_step(lt, lt.FluidMetric(PARAMS))
    I, m, img = bench_inputs(device, FULL64)
    got = step_chain(step, I, m, img, "kernels", steps=1)[0]
    ref = step_chain(step, I, m, img, "plain", steps=1)[0]
    want = {k: 0 for k in got[0][4]}
    want.update(STEP_LAUNCHES)
    check(got[0][4] == want, f"default step at 64^3 b4: launches {got[0][4]}, want {want}")
    rel = abs(got[0][3] - ref[0][3]) / abs(ref[0][3])
    e_I = max_err(got[0][2], ref[0][2]) / float(ref[0][2].abs().max())
    log(f"default step at 64^3 b4 (route fluid_flat): loss rel {rel:.3e}, I_grad rel {e_I:.3e}; "
        f"launches {got[0][4]}")
    check(rel <= 1e-5 and e_I <= 1e-5, "default step at 64^3 b4 differs from the plain versions")


def bound(nbytes, flops):
    """The least time in ms the card could take for work that must move
    ``nbytes`` bytes and do ``flops`` float32 operations, and which of the
    two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Float32 operations per voxel of the unit-regime stencils, counted from the
# plain versions' formulas (each multiply, add, compare and floor one):
AXIS_W = 27  # three axes of weights: floor, subtract, 2 compares, 4 mul, 1 add
TAP_W = 36  # 27 tap weights: 9 (x, y) products, 27 products with z


def warp_ops(C):  # forward warp: 27 products and 26 sums per channel
    return AXIS_W + TAP_W + 53 * C


def transpose_ops(C):  # its transpose: one product and one sum per (tap, channel)
    return AXIS_W + TAP_W + 54 * C


def weight_grad_ops(C):  # d_disp: weights and slopes, 27 (x, y) pair products,
    # per tap the channel dot product (2C - 1) and three products and sums (9)
    return AXIS_W + 9 + 27 + 27 * (2 * C - 1 + 9)


JAC_OPS = 36  # 9 central differences (2 each), 9 products, 6 sums, 3 diagonal adds
DIV_OPS = 51  # 9 transposed differences of products (5 each), 6 sums
# the 2D stencils, per pixel, counted the same way: two axes of weights (9
# each), 9 tap weights, 9 products and 8 sums per channel
AXIS_W2, TAP_W2 = 18, 9
WARP2 = AXIS_W2 + TAP_W2 + 17 * 2
AD2 = WARP2 + 14  # + 4 central differences (2 each), 2 diagonal adds, 4 products
COMPOSE2 = WARP2 + 4  # + s*v (2) and the two sums
FLAG2 = 8  # two compares per component, s*v and phiinv
# the transposed warp, counted as the 3D one: the weights once per pixel, a
# product and a sum per (tap, channel)
TRANSPOSE2 = AXIS_W2 + TAP_W2 + 18 * 2
WGRAD2 = 2 * AXIS_W2 + 9 * (3 + 2 * 3)  # weights and slopes; per tap <c, I> and 2 products and sums
# per pixel: Ad*'s backward (d_mw 12, the divergence path 2 x 10, sums 4)
# and compose's (s g + s dd, 4), each with a transposed warp and a weight
# gradient
ADSTAR2_BWD = TRANSPOSE2 + WGRAD2 + 12 + 2 * 10 + 4
COMPOSE2_BWD = TRANSPOSE2 + WGRAD2 + 4


def work(name, N, V, F=None, axes=None):
    """(bytes, operations) that kernel ``name`` must move and do at the
    timed shapes: fields of ``N`` subjects of ``V`` voxels, float32, a
    batch-1 one-channel atlas for the warp, batch-N momenta for Ad*, ``F``
    complex fields for the fluid solves (of spatial ``axes`` for the
    radix-2 kernels), or, for the 2D whole-shoot kernels, ``F`` substeps of
    2-channel fields of ``V`` pixels.  Each input read once, each output
    written once."""
    f3 = 4 * 3 * N * V  # one 3-channel field
    f1 = 4 * N * V  # one 1-channel batch-N field
    atlas = 4 * V
    if name == "warp_unit_fwd":  # read d, I; write out
        return f3 + atlas + f1, N * V * warp_ops(1)
    if name == "warp_unit_bwd":  # read d, g, I; write dI, d_disp
        return 2 * f3 + f1 + 2 * atlas, N * V * (transpose_ops(1) + weight_grad_ops(1))
    if name == "ad_star_fwd":  # read phi, m0; write out and mw (under autograd, as in the step)
        return 4 * f3, N * V * (warp_ops(3) + JAC_OPS + 6)
    if name == "compose_fwd":  # read phi, v; write out
        return 3 * f3, N * V * (3 + warp_ops(3) + 3 + 6)
    if name == "ad_star_bwd":  # read phi, m0, g, mw; write d_phi, d_m0
        return 6 * f3, N * V * (JAC_OPS + weight_grad_ops(3) + DIV_OPS + 3 + transpose_ops(3))
    if name == "compose_bwd":  # read phi, v, g; write d_phi, d_v
        return 5 * f3, N * V * (3 + transpose_ops(3) + 3 + weight_grad_ops(3) + 9)
    if name in ("fluid_flat", "fluid_whole"):  # read x, Mn; write y; two 3D complex FFTs per field
        return 4 * (2 * 2 * F * V + V), F * (2 * 5 * V * np.log2(V) + 2 * V)
    if name == "fluid_radix_zy":  # read x, write y; 5 flops per element per radix-2 stage
        return 4 * 2 * 2 * F * V, F * 5 * V * np.log2(axes[1] * axes[2])
    if name == "fluid_radix_x":  # and read Mbr; stages along x both ways, the product
        return 4 * (2 * 2 * F * V + V), F * (2 * 5 * V * np.log2(axes[0]) + 2 * V)
    fft2 = 2 * 5 * V * np.log2(V) + 2 * V  # one packed 2D solve per subject
    f2 = 4 * 2 * N * V  # one 2-channel batch-N 2D field
    if name == "shoot2d_fwd":  # read phi0, m0, Mn; write phi_T and 3T stash fields
        return (3 + 3 * F) * f2 + 4 * V, F * N * (V * (AD2 + COMPOSE2 + FLAG2) + fft2)
    if name == "shoot2d_bwd":  # read m0, g, Mn and the 3T stash; write d_phi0, d_m0
        return (4 + 3 * F) * f2 + 4 * V, F * N * (V * (ADSTAR2_BWD + COMPOSE2_BWD) + fft2)
    # the 2D per-substep kernels, one substep at batch-N momenta, each
    # counted as its share of K8's and K9's stencils
    if name == "ad_star2d_fwd":  # read phi, m0; write out, mw (under autograd)
        return 4 * f2, N * V * (AD2 + FLAG2 // 2)
    if name == "compose2d_fwd":  # read phi, v; write out
        return 3 * f2, N * V * (COMPOSE2 + FLAG2 // 2)
    if name == "ad_star2d_bwd":  # read phi, m0, g, mw; write d_phi, d_m0
        return 6 * f2, N * V * ADSTAR2_BWD
    if name == "compose2d_bwd":  # read phi, v, g; write d_phi, d_v
        return 5 * f2, N * V * COMPOSE2_BWD
    raise KeyError(name)


def pass_work(kind, N, NI, C, V, compose=False):
    """(bytes, operations) of one pass of the warp's backward launchers, as
    K5, K6 and K7 run them: the transpose (read the displacement and the
    cotangent, write the ``NI``-batch image gradient) or the weight
    gradient (``kind == "dd"``: read the image, the displacement and the
    cotangent, write the displacement gradient; with the compose epilogue,
    s g + s dd); or K6's first pass (``kind == "adstar_first"``, ``C == 3``:
    read phiinv, the ``NI``-batch momenta, the cotangent and the warped
    momenta, write ``d_mw`` and ``d_phiinv``)."""
    if kind == "transpose":
        return 4 * V * (3 * N + N * C + NI * C), N * V * transpose_ops(C)
    if kind == "adstar_first":
        return 4 * V * (5 * 3 * N + 3 * NI), N * V * (JAC_OPS + weight_grad_ops(3) + DIV_OPS + 3)
    return 4 * V * (NI * C + 3 * N + N * C + 3 * N), N * V * (weight_grad_ops(C)
                                                            + (3 if compose else 0))


def grid_of(disp):
    """``F.grid_sample``'s grid (align_corners=True) for sampling at
    ``x + disp(x)`` of a 3D ``(N, 3, X, Y, Z)`` or 2D ``(N, 2, H, W)``
    displacement: ``(N, *spatial, D)``, last axis reversed ((z, y, x) or
    (w, h)), in [-1, 1]."""
    from lagomorph_tpu_torch.ops.sampling import identity_grid

    spatial = tuple(disp.shape[2:])
    D = len(spatial)
    coords = identity_grid(spatial, dtype=disp.dtype, device=disp.device)[None] + disp
    size = torch.tensor(spatial, dtype=disp.dtype, device=disp.device).view(1, D, *[1] * D)
    return (2.0 * coords / (size - 1) - 1.0).flip(1).permute(0, *range(2, D + 2), 1).contiguous()


def compose_yardstick(device, card, phiinv, v, s):
    """Log the compose's yardstick, two PyTorch calls (so not its library
    column): ``grid_sample`` of phiinv at x + s v (the grid made
    beforehand) plus s v, its ms per call (CUDA events; in 2D, where the
    host sets those, also ``torch.profiler``'s device time) and its largest
    difference from the kernel (K2 in 3D, K11 in 2D)."""
    import torch.nn.functional as Fn

    from lagomorph_tpu_torch.ops.kernels import epdiff2d, epdiff_unit

    d = s * v
    grid = grid_of(d)
    two_d = phiinv.dim() == 4

    def yardstick():
        return Fn.grid_sample(phiinv, grid, mode="bilinear", padding_mode="border",
                              align_corners=True) + d

    y1, y2 = (time_ms(yardstick, device, 10) for _ in range(2))
    kernel = (epdiff2d.compose2d if two_d else epdiff_unit.compose)(phiinv, v, s)[0]
    err = max_err(yardstick(), kernel)
    dev = ""
    if two_d:
        us = [device_us(device, yardstick)[0] for _ in range(2)]
        dev = f", device {us[0]:.2f}/{us[1]:.2f} us per call (torch.profiler)"
    log(f"time {'compose2d_fwd' if two_d else 'compose_fwd'} yardstick (grid_sample + s v, two "
        f"calls): {y1:.4f}/{y2:.4f} ms per call{dev} at {'x'.join(map(str, phiinv.shape))}, max "
        f"diff from {'K11' if two_d else 'K2'} {err:.3e} [{card}]")


def timings(device, card, lt, metric, I, m, img):
    """Per-call ms at 128^3 b4 of each kernel, its plain version and, where
    one PyTorch call computes the same function, that call (order: plain,
    kernel, kernel, plain, library), beside the bound of its work; then the
    slice and the atlas step both ways, with each step's peak device
    memory.  Returns {kernel: {ms, plain_ms, library_ms, bound_ms,
    bound_by}}."""
    import torch.nn.functional as Fn

    from lagomorph_tpu_torch import lddmm
    from lagomorph_tpu_torch.ops.kernels import (_build, epdiff_unit, fft_unit, plain_versions,
                                                 stream_of, warp_unit)

    rng = np.random.default_rng(7)
    N, _, X, Y, Z = FULL
    V = X * Y * Z

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    phiinv = t(rng.uniform(-0.99, 0.99, FULL))
    v = t(rng.uniform(-4.9, 4.9, FULL))
    x = t(rng.standard_normal((12,) + FULL[2:]))
    g1 = t(rng.standard_normal((N, 1) + FULL[2:]))
    g3 = t(rng.standard_normal(FULL))
    Mn = metric.multiplier(FULL, torch.float32, device, True)
    _, _, mw = epdiff_unit._launch_ad_star(phiinv, m, want_mw=True)
    grid = grid_of(phiinv)
    I_N = I.expand(N, -1, -1, -1, -1)
    cx = torch.complex(x[:6], x[6:])
    gs = Fn.grid_sample(I_N, grid, mode="bilinear", padding_mode="border", align_corners=True)
    log(f"grid_sample yardstick vs K4 at 128^3 b4: max diff "
        f"{max_err(gs, warp_unit.sample_displacement_unit(I, phiinv)):.3e}")

    def grid_sample_bwd():  # K5's function: the atlas gradient summed over the subjects
        dI, dgrid = torch.ops.aten.grid_sampler_3d_backward(g1, I_N, grid, 0, 1, True,
                                                           [True, True])
        return dI.sum(0, keepdim=True), dgrid
    # kernel name: (kernel path, plain version, one library call or None)
    calls = {
        "warp_unit_fwd": (lambda: warp_unit.sample_displacement_unit(I, phiinv),
                          lambda: warp_unit.sample_displacement_unit_plain(I, phiinv),
                          lambda: Fn.grid_sample(I_N, grid, mode="bilinear",
                                                 padding_mode="border", align_corners=True)),
        "warp_unit_bwd": (lambda: warp_unit._launch_bwd(I, phiinv, g1),
                          lambda: warp_unit.sample_displacement_unit_bwd_plain(I, phiinv, g1),
                          grid_sample_bwd),
        # K1 as the step runs it: under autograd, writing mw for K6
        "ad_star_fwd": (lambda: epdiff_unit._launch_ad_star(phiinv, m, want_mw=True),
                        lambda: epdiff_unit.ad_star_plain(phiinv, m, want_mw=True), None),
        "ad_star_bwd": (lambda: epdiff_unit._launch_ad_star_bwd(phiinv, m, g3, mw),
                        lambda: epdiff_unit.ad_star_bwd_plain(phiinv, m, g3, mw), None),
        "compose_fwd": (lambda: epdiff_unit.compose(phiinv, v, -0.2),
                        lambda: epdiff_unit.compose_plain(phiinv, v, -0.2), None),
        "compose_bwd": (lambda: epdiff_unit._launch_compose_bwd(phiinv, v, -0.2, g3),
                        lambda: epdiff_unit.compose_bwd_plain(phiinv, v, -0.2, g3), None),
        "fluid_flat": (lambda: fft_unit.fluid_flat(x, Mn),
                       lambda: fft_unit.fluid_flat_plain(x, Mn),
                       lambda: torch.fft.ifftn(torch.fft.fftn(cx, dim=(1, 2, 3)) * Mn,
                                               dim=(1, 2, 3))),
    }
    out = {}
    for name, (fn, plain, library) in calls.items():
        p1 = time_ms(plain, device, 10)
        k1 = time_ms(fn, device, 10)
        k2 = time_ms(fn, device, 10)
        p2 = time_ms(plain, device, 10)
        lib = time_ms(library, device, 10) if library is not None else None
        b_ms, b_by = bound(*work(name, N, V, F=6))
        out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                     "bound_ms": b_ms, "bound_by": b_by}
        log(f"time {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
            f"library {'none' if lib is None else f'{lib:.4f} ms'}, bound {b_ms:.4f} ms "
            f"({b_by}), {(k1 + k2) / 2 / b_ms:.2f}x the bound, per call at 128^3 b4 [{card}]")
    # K1 forward-only, as the slice and a step without gradients call it:
    # no mw, so one field fewer to write
    k1 = time_ms(lambda: epdiff_unit._launch_ad_star(phiinv, m), device, 10)
    k2 = time_ms(lambda: epdiff_unit._launch_ad_star(phiinv, m), device, 10)
    nbytes, flops = work("ad_star_fwd", N, V)
    b_ms, b_by = bound(nbytes * 3 // 4, flops)
    log(f"time ad_star_fwd forward-only (no mw): kernel {k1:.4f}/{k2:.4f} ms, bound {b_ms:.4f} "
        f"ms ({b_by}), {(k1 + k2) / 2 / b_ms:.2f}x the bound, per call at 128^3 b4 [{card}]")
    compose_yardstick(device, card, phiinv, v, -0.2)

    # each pass of the warp's backward launchers at the operand shapes the
    # step runs: the transpose of K5 (C = 1, the atlas summed over the N
    # subjects) and of K6 and K7 (C = 3, NI = N), the weight gradient of K5
    # (C = 1) and of K7 (C = 3, the compose epilogue)
    st = stream_of(phiinv)
    dI1 = torch.empty_like(I)
    d3 = torch.empty_like(phiinv)

    def transpose(disp, s, cot, out, NI, C):
        return lambda: _build.call("lagomorph_warp_transpose", disp.data_ptr(), s,
                                   cot.data_ptr(), out.data_ptr(), N, NI, C, X, Y, Z, st)

    def dd(img_, disp, s, cot, NI, C, compose):
        return lambda: _build.call("lagomorph_warp_dd", img_.data_ptr(), disp.data_ptr(), s,
                                   cot.data_ptr(), d3.data_ptr(), N, NI, C, X, Y, Z,
                                   int(compose), st)

    for label, kind, NI, C, compose, fn in (
            ("transpose C=1 NI=1 (K5)", "transpose", 1, 1, False,
             transpose(phiinv, 1.0, g1, dI1, 1, 1)),
            ("transpose C=3 NI=N (K6, K7)", "transpose", N, 3, False,
             transpose(v, -0.2, g3, d3, N, 3)),
            ("weight gradient C=1 (K5)", "dd", 1, 1, False, dd(I, phiinv, 1.0, g1, 1, 1, False)),
            ("weight gradient C=3 compose (K7)", "dd", N, 3, True,
             dd(phiinv, v, -0.2, g3, N, 3, True))):
        k1 = time_ms(fn, device, 10)
        k2 = time_ms(fn, device, 10)
        b_ms, b_by = bound(*pass_work(kind, N, NI, C, V, compose))
        log(f"time pass {label}: {k1:.4f}/{k2:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{(k1 + k2) / 2 / b_ms:.2f}x the bound, per call at 128^3 b4 [{card}]")
    # K6's first pass alone, at batch-N momenta as the step runs it
    k1 = time_ms(lambda: ad_star_bwd_first(phiinv, m, g3, mw), device, 10)
    k2 = time_ms(lambda: ad_star_bwd_first(phiinv, m, g3, mw), device, 10)
    b_ms, b_by = bound(*pass_work("adstar_first", N, m.shape[0], 3, V))
    log(f"time pass K6 first pass (d_mw, d_phiinv; m0 batch {m.shape[0]}): {k1:.4f}/{k2:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}), {(k1 + k2) / 2 / b_ms:.2f}x the bound, per call at "
        f"128^3 b4 [{card}]")

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

    step = make_step(lt, metric)

    def atlas_step():
        return float(step(I, m, img)[2])

    samples = {False: [], True: []}
    for is_plain in (True, False, False, True):
        with plain_versions() if is_plain else contextlib.nullcontext():
            samples[is_plain].append(time_ms(atlas_step, device, 3, warmup=1))
    peak = {}
    for is_plain in (False, True):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        with plain_versions() if is_plain else contextlib.nullcontext():
            atlas_step()
        peak[is_plain] = torch.cuda.max_memory_allocated(device) / 2**30
    k, p = samples[False], samples[True]
    log(f"time atlas step (make_lddmm_atlas_step, 128^3 b4, 5 steps): kernels "
        f"{k[0]:.3f}/{k[1]:.3f} ms ({2000 / (k[0] + k[1]):.2f} steps/s), plain "
        f"{p[0]:.3f}/{p[1]:.3f} ms per step; peak device memory per step: kernels "
        f"{peak[False]:.2f} GiB, plain {peak[True]:.2f} GiB [{card}]")
    return out


def timings2d(device, card, lt):
    """Per-call ms of K8 (with the stash, as under autograd) and K9 at 256^2
    b8 and 512^2 b8, and of K10 (writing ``mw``, as under autograd), K11,
    K12 and K13 at one substep of the ``beta = 0.05`` shooting at 256^2 b8,
    each beside its plain version (order: plain, kernel, kernel, plain) and
    the bound of its work (no PyTorch call computes any of these
    functions); then the 2D atlas step both ways with ``beta = 0`` and
    ``beta = 0.05`` at 256^2 b8 and 512^2 b8, with the peak device memory
    of each step; then K10-K13's device time per call (``torch.profiler``,
    two samples of 10 calls; each call's total and the kernel alone) at
    256^2 b8 and 512^2 b8, and K11's two-call yardstick there.  Returns {kernel: {ms, plain_ms, library_ms, bound_ms,
    bound_by}} at 256^2 b8."""
    from lagomorph_tpu_torch.ops.kernels import epdiff2d, plain_versions, shoot2d

    metric = lt.FluidMetric(PARAMS)
    s, T = -1.0 / STEPS, STEPS - 1

    def momenta(shape):  # bench.py's momenta and a cotangent at shape
        g = torch.as_tensor(np.random.default_rng(8).standard_normal(shape), dtype=torch.float32,
                            device=device)
        return bench_inputs(device, shape)[1], g

    def shoot2d_calls(shape, m, g):  # K8 (with the stash) and K9
        Mn = metric.packed_multiplier(shape[2:], torch.float32, device)
        phiinv0 = s * metric.sharp(m)
        traj = shoot2d._launch_fwd(phiinv0, m, Mn, s, T, True)[2:]
        return {("shoot2d_fwd", shape): (lambda: shoot2d._launch_fwd(phiinv0, m, Mn, s, T, True),
                                         lambda: shoot2d.shoot2d_fwd_plain(phiinv0, m, Mn, s, T),
                                         T),
                ("shoot2d_bwd", shape): (lambda: shoot2d._launch_bwd(m, g, *traj, Mn, s),
                                         lambda: shoot2d.shoot2d_bwd_plain(m, g, *traj, Mn, s), T)}

    out = {}

    def timed(calls):
        for (name, shape), (fn, plain, substeps) in calls.items():
            N, _, H, W = shape
            p1 = time_ms(plain, device, 10)
            k1 = time_ms(fn, device, 10)
            k2 = time_ms(fn, device, 10)
            p2 = time_ms(plain, device, 10)
            b_ms, b_by = bound(*work(name, N, H * W, F=substeps))
            if shape == FULL2D:
                out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": None,
                             "bound_ms": b_ms, "bound_by": b_by}
            log(f"time {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
                f"library none, bound {b_ms:.4f} ms ({b_by}) per call at {H}^2 b{N}, "
                f"{substeps} substep{'s' if substeps > 1 else ''} [{card}]")
            if name.startswith("shoot2d"):
                log(f"  {'K8' if name == 'shoot2d_fwd' else 'K9'}'s launch at {H}^2 b{N}: "
                    f"{shoot_grid(shoot2d, N, H, W, fwd=name == 'shoot2d_fwd')}")

    def per_op_calls(shape, m, g):  # K10-K13 on the beta = 0.05 shooting's second substep
        v0 = lt.FluidMetric(PARAMS_BETA).sharp(m)
        phi1 = s * v0
        _, _, mw = epdiff2d._launch_ad_star(phi1, m, want_mw=True)
        return {
            ("ad_star2d_fwd", shape): (lambda: epdiff2d._launch_ad_star(phi1, m, want_mw=True),
                                       lambda: epdiff2d.ad_star2d_plain(phi1, m, want_mw=True), 1),
            ("compose2d_fwd", shape): (lambda: epdiff2d._launch_compose(phi1, v0, s),
                                       lambda: epdiff2d.compose2d_plain(phi1, v0, s), 1),
            ("ad_star2d_bwd", shape): (lambda: epdiff2d._launch_ad_star_bwd(phi1, m, g, mw),
                                       lambda: epdiff2d.ad_star2d_bwd_plain(phi1, m, g, mw), 1),
            ("compose2d_bwd", shape): (lambda: epdiff2d._launch_compose_bwd(phi1, v0, s, g),
                                       lambda: epdiff2d.compose2d_bwd_plain(phi1, v0, s, g), 1),
        }

    def device_times(calls):  # K10-K13 by torch.profiler device time, after the events
        for (name, shape), (fn, _, _) in calls.items():
            N, _, H, W = shape
            runs = [device_us(device, fn) for _ in range(2)]
            own = [sum(t for op, t in r[2].items() if name.rsplit("_", 1)[0] in op) for r in runs]
            log(f"time {name}: device {runs[0][0]:.2f}/{runs[1][0]:.2f} us per call, the kernel "
                f"alone {own[0]:.2f}/{own[1]:.2f} (torch.profiler) at {H}^2 b{N}, 1 substep "
                f"[{card}]")

    # the 256^2 operands stay alive through the steps below, the 512^2 ones
    # do not (the steps' peaks count what is allocated)
    m, g = momenta(FULL2D)
    calls = shoot2d_calls(FULL2D, m, g)
    per_op = per_op_calls(FULL2D, m, g)
    calls.update(per_op)
    timed(calls)
    timed(shoot2d_calls(FULL2D_512, *momenta(FULL2D_512)))

    for params in (PARAMS, PARAMS_BETA):
        step = make_step(lt, lt.FluidMetric(params))
        for shape in (FULL2D, FULL2D_512):
            I, m, img = bench_inputs(device, shape)

            def atlas_step():
                return float(step(I, m, img)[2])

            samples = {False: [], True: []}
            for is_plain in (True, False, False, True):
                with plain_versions() if is_plain else contextlib.nullcontext():
                    samples[is_plain].append(time_ms(atlas_step, device, 5, warmup=1))
            peak = {}
            for is_plain in (False, True):
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
                with plain_versions() if is_plain else contextlib.nullcontext():
                    atlas_step()
                peak[is_plain] = torch.cuda.max_memory_allocated(device) / 2**30
            k, p = samples[False], samples[True]
            log(f"time 2D atlas step (beta={params[1]}, {shape[2]}^2 b{shape[0]}, 5 steps): "
                f"kernels {k[0]:.3f}/{k[1]:.3f} ms ({2000 / (k[0] + k[1]):.2f} steps/s), plain "
                f"{p[0]:.3f}/{p[1]:.3f} ms per step; peak device memory per step: kernels "
                f"{peak[False]:.3f} GiB, plain {peak[True]:.3f} GiB [{card}]")
    # after the steps' wall times, which a profiler session before them
    # would slow (its callbacks stay registered)
    device_times(per_op)
    device_times(per_op_calls(FULL2D_512, *momenta(FULL2D_512)))
    for shape in (FULL2D, FULL2D_512):  # K11's yardstick on the same substep
        v0 = lt.FluidMetric(PARAMS_BETA).sharp(momenta(shape)[0])
        compose_yardstick(device, card, s * v0, v0, s)
    return out


def step_times(lt, device, card, shape, label, setter=None, value=None, reps=3):
    """The atlas step at ``shape`` on bench.py's inputs, through the kernels
    and the plain versions (order: plain, kernel, kernel, plain), with the
    selector ``setter`` at ``value`` if given, and the peak device memory of
    one step each way."""
    from lagomorph_tpu_torch.ops.kernels import plain_versions

    step = make_step(lt, lt.FluidMetric(PARAMS))
    I, m, img = bench_inputs(device, shape)

    def atlas_step():
        return float(step(I, m, img)[2])

    with selected(setter, value) if setter else contextlib.nullcontext():
        samples = {False: [], True: []}
        for is_plain in (True, False, False, True):
            with plain_versions() if is_plain else contextlib.nullcontext():
                samples[is_plain].append(time_ms(atlas_step, device, reps, warmup=1))
        peak = {}
        for is_plain in (False, True):
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            with plain_versions() if is_plain else contextlib.nullcontext():
                atlas_step()
            peak[is_plain] = torch.cuda.max_memory_allocated(device) / 2**30
    k, p = samples[False], samples[True]
    log(f"time atlas step ({label}, {shape[2]}^3 b{shape[0]}, 5 steps): kernels "
        f"{k[0]:.3f}/{k[1]:.3f} ms ({2000 / (k[0] + k[1]):.2f} steps/s), plain "
        f"{p[0]:.3f}/{p[1]:.3f} ms per step; peak device memory per step: kernels "
        f"{peak[False]:.3f} GiB, plain {peak[True]:.3f} GiB [{card}]")


def step_ab(lt, device, card, shape, label, setter, value, reps=3):
    """The atlas step at ``shape`` on bench.py's inputs through the kernels,
    on the default selectors and with ``setter`` at ``value``, in turns
    (default, selected, selected, default), in ms per step."""
    step = make_step(lt, lt.FluidMetric(PARAMS))
    I, m, img = bench_inputs(device, shape)
    samples = {False: [], True: []}
    for sel in (False, True, True, False):
        with selected(setter, value) if sel else contextlib.nullcontext():
            samples[sel].append(time_ms(lambda: float(step(I, m, img)[2]), device, reps,
                                        warmup=1))
    d, r = samples[False], samples[True]
    log(f"time atlas step in turns at {shape[2]}^3 b{shape[0]}: default (K3) {d[0]:.3f}/"
        f"{d[1]:.3f} ms, {label} {r[0]:.3f}/{r[1]:.3f} ms per step [{card}]")


def timings_solves(device, card, lt):
    """Per-call ms of K14 (forward; the inverse logged), K15 and the
    pipeline K14, K15, K14 at 128^3 b4 (the pipeline also at 64^3 b4), and
    of K16 at 64^3 b4 (and, logged, at 128^3 b4), with K3 logged at both
    shapes, each beside its plain version (order: plain, kernel, kernel,
    plain), the library call (``ifftn(Mn * fftn(.))`` on the packed pairs,
    for K3, the pipeline and K16; none computes K14 or K15 alone) and the
    bound of its work, and K16, K3 and the pipeline logged at (3, 3, 32, 64,
    128), their line paths; then the radix step at 128^3 b4 (both ways,
    and in turns with the default step) and the whole-volume and default
    steps at 64^3 b4, both ways, with peak memory; last, at 128^3 and
    64^3, K16's cooperative grid and the device time per call of K16, K3,
    the pipeline and the library call from ``torch.profiler`` (the host
    sets the event times of such short calls), by kernel for K3's and the
    pipeline's three launches.  Returns {kernel: {ms, plain_ms,
    library_ms, bound_ms, bound_by}}."""
    from lagomorph_tpu_torch.ops import fluid
    from lagomorph_tpu_torch.ops.kernels import fft_radix, fft_unit, fft_whole, plain_versions

    rng = np.random.default_rng(11)
    out = {}

    def timed(name, shape, fn, library, work_name=None, record=True):
        """Time ``fn`` and, under ``plain_versions()``, its plain version."""
        def plain():
            with plain_versions():
                return fn()

        N, _, X, Y, Z = shape
        p1 = time_ms(plain, device, 10)
        k1 = time_ms(fn, device, 10)
        k2 = time_ms(fn, device, 10)
        p2 = time_ms(plain, device, 10)
        lib = time_ms(library, device, 10) if library is not None else None
        b_ms, b_by = bound(*work(work_name or name, N, X * Y * Z, F=(N * 3 + 1) // 2,
                                 axes=(X, Y, Z)))
        if record:
            out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                         "bound_ms": b_ms, "bound_by": b_by}
        log(f"time {name}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
            f"library {'none' if lib is None else f'{lib:.4f} ms'}, bound {b_ms:.4f} ms "
            f"({b_by}) per call at {X}x{Y}x{Z} b{N} [{card}]")

    def operands(shape):
        N, _, X, Y, Z = shape
        F = (N * 3 + 1) // 2
        x = torch.as_tensor(rng.standard_normal((2 * F, X, Y, Z)), dtype=torch.float32,
                            device=device)
        Mn, Mbr = (fluid.form_multiplier(fluid.multiplier_form(r), (X, Y, Z), PARAMS, True,
                                         torch.float32, device)
                   for r in ("fluid_flat", "fluid_radix"))
        cx = torch.complex(x[:F], x[F:])
        return x, Mn, Mbr, lambda: torch.fft.ifftn(torch.fft.fftn(cx, dim=(1, 2, 3)) * Mn,
                                                   dim=(1, 2, 3))

    def device_times(shape, x, Mn, Mbr, library):
        """K16's launch, and the device time per call of K16, K3, the
        pipeline and the library call, by kernel for K3's and the
        pipeline's three launches (K14 forward, K15, K14 inverse), from a
        profiler run of 10 calls each."""
        N, _, X, Y, Z = shape
        cfg = fft_whole.launch_config(X, Y, Z)
        log(f"fluid_whole launch at {X}x{Y}x{Z} b{N}: {cfg['path']} path, cooperative grid of "
            f"{cfg['blocks']} blocks x {cfg['threads']} threads, {cfg['smem']} B shared memory "
            "a block")
        for name, fn in (("fluid_whole", lambda: fft_whole.fluid_whole(x, Mn)),
                         ("fluid_flat", lambda: fft_unit.fluid_flat(x, Mn)),
                         ("pipeline K14, K15, K14", lambda: fft_radix.fluid_radix(x, Mbr)),
                         ("library", library)):
            us, k, by_name = device_us(device, fn)
            log(f"device time {name}: {us:.2f} us per call ({k:.1f} device operations) at "
                f"{X}x{Y}x{Z} b{N}, torch.profiler over 10 calls [{card}]")
            if name in ("fluid_flat", "pipeline K14, K15, K14"):
                for kname, kus in by_name.items():
                    log(f"device time {name} by kernel: {kus:.2f} us per call  {kname[:90]}")

    x, Mn, Mbr, library = operands(FULL)
    timed("fluid_flat", FULL, lambda: fft_unit.fluid_flat(x, Mn), library, record=False)
    spec = fft_radix.radix_zy(x, False)
    timed("fluid_radix_zy", FULL, lambda: fft_radix.radix_zy(x, False), None)
    timed("fluid_radix_zy inverse", FULL, lambda: fft_radix.radix_zy(spec, True), None,
          work_name="fluid_radix_zy", record=False)
    timed("fluid_radix_x", FULL, lambda: fft_radix.radix_x(spec, Mbr), None)
    timed("pipeline K14, K15, K14", FULL, lambda: fft_radix.fluid_radix(x, Mbr), library,
          work_name="fluid_flat", record=False)
    timed("fluid_whole", FULL, lambda: fft_whole.fluid_whole(x, Mn), library, record=False)
    del spec
    x, Mn, Mbr, library = operands(FULL64)
    timed("fluid_whole", FULL64, lambda: fft_whole.fluid_whole(x, Mn), library)
    timed("fluid_flat", FULL64, lambda: fft_unit.fluid_flat(x, Mn), library, record=False)
    timed("pipeline K14, K15, K14", FULL64, lambda: fft_radix.fluid_radix(x, Mbr), library,
          work_name="fluid_flat", record=False)
    x, Mn, Mbr, library = operands(RADIX_ODD)  # K16's, K3's and the pipeline's line paths
    timed("fluid_whole", RADIX_ODD, lambda: fft_whole.fluid_whole(x, Mn), library, record=False)
    timed("fluid_flat", RADIX_ODD, lambda: fft_unit.fluid_flat(x, Mn), library, record=False)
    timed("pipeline K14, K15, K14", RADIX_ODD, lambda: fft_radix.fluid_radix(x, Mbr), library,
          work_name="fluid_flat", record=False)
    del x, Mn, Mbr, library

    step_times(lt, device, card, FULL, "radix: K14, K15", lt.set_fluid_fft_kernel, "radix")
    step_ab(lt, device, card, FULL, "radix (K14, K15)", lt.set_fluid_fft_kernel, "radix")
    step_times(lt, device, card, FULL64, "whole: K16", lt.set_fluid_mxu_whole, True, reps=5)
    step_times(lt, device, card, FULL64, "default: K3", reps=5)
    # last: after a profiler run every launch costs the host more, which the
    # event times of short calls and of host-bound steps would show
    for shape in (FULL, FULL64):
        device_times(shape, *operands(shape))
    return out


def device_events(path):
    """The device's kernels, copies and sets in the Chrome trace at
    ``path``, by start time."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                  key=lambda e: e["ts"])


def profiled(device, fn, n, path, tries=3):
    """The device events of ``n`` calls of ``fn`` (after one call outside
    the profiler) under ``torch.profiler``, written to ``path`` as a Chrome
    trace, and the wall ms per call under the profiler.  A trace in which
    the profiler caught no device activity is taken again, up to ``tries``
    times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize(device)
            wall = (time.perf_counter() - t0) * 1e3 / n
        prof.export_chrome_trace(path)
        dev = device_events(path)
        if dev:
            return dev, wall
        log(f"profiler: no device activity caught over {n} calls (try {attempt + 1} of {tries})")
    check(False, f"no device activity in the trace after {tries} tries")


def device_us(device, fn, n=10):
    """Device microseconds per call of ``fn`` (the summed durations of the
    device operations it ran), device operations per call, and the
    microseconds per call of each operation by name, from a
    ``torch.profiler`` run of ``n`` calls (``profiled``)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        dev, _ = profiled(device, fn, n, os.path.join(tmp, "trace.json"))
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / n
    return sum(e["dur"] for e in dev) / n, len(dev) / n, by_name


def trace_run(device, card, fn, label, path, n=5):
    """Optional phase (``--trace PATH``): a ``torch.profiler`` trace of
    ``n`` calls of ``fn`` (``label`` names one call), written to ``path`` as
    a Chrome trace.  Prints the device time per call of the 16 largest
    kernels and of every kernel of the port, the device's busy share over
    the traced span, and its idle gaps."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    dev, wall = profiled(device, fn, n, path)
    per = {}
    busy, gaps, end = 0.0, [], dev[0]["ts"]
    for e in dev:
        ms, k = per.get(e["name"], (0.0, 0))
        per[e["name"]] = (ms + e["dur"] / 1e3, k + 1)
        start, stop = e["ts"], e["ts"] + e["dur"]
        if start > end:
            gaps.append(start - end)
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    span = end - dev[0]["ts"]
    gaps.sort(reverse=True)
    log(f"trace: {n} {label}s, wall {wall:.3f} ms per {label} under the profiler; "
        f"device busy {busy / 1e3 / n:.3f} ms per {label}, busy share "
        f"{busy / span:.3f} of the traced span [{card}]")
    log(f"trace: {len(gaps)} idle gaps, {sum(g > 50 for g in gaps)} over 50 us; "
        f"largest (us): {', '.join(f'{g:.0f}' for g in gaps[:8])}")
    ranked = sorted(per.items(), key=lambda kv: -kv[1][0])
    for i, (name, (ms, k)) in enumerate(ranked):
        if i < 16 or "lagomorph::" in name:
            log(f"trace: {ms / n:8.3f} ms/{label} {k / n:5.1f} calls/{label}  {name[:90]}")
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
        f"{len(_build._sources())} sources in parallel)")
    for line in _build.build_log.splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # 3. kernels against their plain versions, forward and backward
    errs = kernel_checks(lt, device, FULL, seed=1)
    kernel_checks(lt, device, ODD, seed=2)
    for shape, seed in ((FULL, 19), (FULL64, 20), (ODD, 21)):
        errs["compose_fwd"] = max(errs["compose_fwd"], compose_checks(device, shape, seed))
    for shape, seed in ((FULL, 22), (FULL64, 23), (ODD, 24)):
        errs["ad_star_fwd"] = max(errs["ad_star_fwd"], ad_star_checks(device, shape, seed))
    for name, err in backward_checks(lt, device, FULL, seed=3).items():
        errs[name] = max(errs.get(name, 0.0), err)
    backward_checks(lt, device, ODD, seed=4)
    errs.update(shoot2d_checks(lt, device, FULL2D, seed=5))
    for name, err in shoot2d_checks(lt, device, FULL2D_512, seed=9).items():
        errs[name] = max(errs[name], err)
    shoot2d_checks(lt, device, ODD2D, seed=6)
    errs.update(epdiff2d_checks(device, FULL2D, seed=10))
    for shape, seed in ((FULL2D_512, 11), (ODD2D, 12)):
        for name, err in epdiff2d_checks(device, shape, seed).items():
            errs[name] = max(errs[name], err)
    for shape, seed, radix, whole in ((FULL, 13, True, True), (FULL64, 14, True, True),
                                      (RADIX_ODD, 15, True, True), (RADIX_WIDE, 16, True, False),
                                      (RADIX_LONG, 18, True, False), (ODD, 17, False, True)):
        for name, err in solve_checks(lt, device, shape, seed, radix, whole).items():
            errs[name] = max(errs.get(name, 0.0), err)

    # 4. the slice forward, at the bench's momenta and at momenta scaled to
    # a half-voxel deformation, with the launch counters set to 0 just
    # before and read just after
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
    log(f"slice launches: {launches}")
    check(all(launches[k] > 0 for k in FORWARD), f"a forward kernel was not launched: {launches}")
    for label, mm, loss, launched in runs:
        slice_check(metric, I, mm, img, loss, launched, label)

    # 5. fallback of the shooting
    fallback_run(metric, m * (8.0 / float(metric.sharp(m).abs().max())))

    # 6. the main path: atlas steps, then one step on fallback momenta
    main = atlas_steps(lt, metric, I, m, img, m_half)
    fallback_step(lt, device, PARAMS, 8.0, *fallback_inputs(device, FALLBACK, seed=3))
    # 6b. the 2D main path: its kernels' launches come from its own run
    main2d = atlas_steps_2d(lt, device)
    main.update({k: main2d[k] for k in KERNELS_2D})
    # 6c. the 2D path with beta != 0 on K10-K13, and its fallback
    main2d = atlas_steps_2d(lt, device, PARAMS_BETA, STEP2D_BETA_LAUNCHES)
    main.update({k: main2d[k] for k in KERNELS_2D_PER_OP})
    I2, m2, img2 = bench_inputs(device, FULL2D)
    for max_v0 in (8.0, 2.0):
        fallback_step(lt, device, PARAMS_BETA, max_v0, m2, I2, img2)
    # 6d. the radix path at 128^3 b4 (K14, K15 in place of K3)
    radix = selector_steps(lt, device, FULL, lt.set_fluid_fft_kernel, "radix", RADIX_STEP_LAUNCHES)
    main.update({k: radix[k] for k in ("fluid_radix_zy", "fluid_radix_x")})
    # 6e. the whole-volume path at 64^3 b4 (K16 in place of K3), and the
    # default route beside it
    whole = selector_steps(lt, device, FULL64, lt.set_fluid_mxu_whole, True, WHOLE_STEP_LAUNCHES)
    main["fluid_whole"] = whole["fluid_whole"]
    default_step_64(lt, device)

    # 7. timings
    times = timings(device, card, lt, metric, I, m, img)
    times.update(timings2d(device, card, lt))
    times.update(timings_solves(device, card, lt))

    # 8. traces
    if trace_path:
        step = make_step(lt, metric)
        trace_run(device, card,
                  lambda: float(lddmm._lddmm_loss(I, m, img, metric, REG_WEIGHT, STEPS)[0]),
                  "slice", trace_path)
        base, ext = os.path.splitext(trace_path)
        trace_run(device, card, lambda: float(step(I, m, img)[2]), "step",
                  f"{base}_steps{ext or '.json'}")
        I2, m2, img2 = bench_inputs(device, FULL2D)
        trace_run(device, card, lambda: float(step(I2, m2, img2)[2]), "2D step",
                  f"{base}_steps2d{ext or '.json'}")
        step_beta = make_step(lt, lt.FluidMetric(PARAMS_BETA))
        trace_run(device, card, lambda: float(step_beta(I2, m2, img2)[2]), "2D beta step",
                  f"{base}_steps2d_beta{ext or '.json'}")
        with selected(lt.set_fluid_fft_kernel, "radix"):
            trace_run(device, card, lambda: float(step(I, m, img)[2]), "radix step",
                      f"{base}_steps_radix{ext or '.json'}")
        I64, m64, img64 = bench_inputs(device, FULL64)
        with selected(lt.set_fluid_mxu_whole, True):
            trace_run(device, card, lambda: float(step(I64, m64, img64)[2]), "whole step 64^3",
                      f"{base}_steps64_whole{ext or '.json'}")

    record = {"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": main[k.name], "max_abs_err": errs[k.name], **times[k.name]}
        for k in kernels.KERNELS.values()
    ]}
    return record


def main():
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    ap.add_argument("--trace", metavar="PATH",
                    help="also trace 5 slices (into this Chrome-trace file), 5 atlas "
                         "steps (into PATH with _steps before its extension), 5 2D "
                         "atlas steps at 256^2 b8 (_steps2d), 5 with beta = 0.05 "
                         "(_steps2d_beta), 5 radix steps at 128^3 b4 (_steps_radix) "
                         "and 5 whole-volume steps at 64^3 b4 (_steps64_whole) with "
                         "torch.profiler, and print the device time by kernel and the "
                         "busy share")
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
