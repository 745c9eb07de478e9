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
--fluid_beta 0.05``), then the atlas builder over epochs, the affine
stack that comes before it in the registration workflow, the rest of the
core API and the models (``lddmm_register``, ``affine_register``,
``rigid_register``, ``DeepLDDMMAtlas``), the data path, and the parallel
paths (the spatially sharded step, a device mesh, processes):

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
   their strips logged); then the 2D unit-regime warp K17 (bit-equal to the
   plain stencil) and its backward K18 (under autograd) at 512^2 b8 and
   (3, 2, 96, 80), for the batch-1 atlas and a batch-N two-channel field,
   K17's and K18's ms at 512^2 b8 beside their bounds and the plain
   stencil's; then the
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
   the 256^2 kernel steps and read just after, show K8, K9 and the atlas
   warp's K17 and K18 each launched once per step and no 3D kernel;
6c. 2D atlas steps with ``beta = 0.05``, the path of K10-K13: the same
   three chains, the counters set to 0 just before the 256^2 kernel steps
   and read just after showing K10-K13 four times each per step, K17 and
   K18 once, and no other kernel; then one step at 256^2 b8 on momenta whose flag trips
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
6f. (run after 7 and 8) the atlas builder (``LDDMMAtlasBuilder``)
   over epochs at the JAX package's end-to-end configuration
   (scripts/atlas_e2e_tpu.py: blobs from seed 0 offset by up to 2 voxels,
   ``FluidMetric([0.05, 0, 0.05])``, ``reg_weight=1e-2``, learning rates
   1e-3 and 50; ``profile_atlas.py`` builds them): whether h5py and tqdm
   import here; 8 subjects at 128^3 b4 over 3 epochs through the kernels
   (the counters, set to 0 just before and read just after, at each
   kernel's step launches x 6 iterations; the epoch loss falling) against
   the plain versions (every iteration's loss within 1e-5 relative, the
   atlas within 1e-5 of max|I|, each minibatch's momenta within 1e-3 in
   relative L2), both runs' drift from a float64 run logged; the same with
   moving momenta (the north-star run's pose learning rate 500, offsets of
   8 voxels and 10 integration steps, BASELINE.md), held and logged the
   same way; one epoch with ``gradient_checkpointing`` ``torch.equal`` to
   one without, with the recomputed forwards' launches and both peaks; one
   step at 128^3 b4 and at 256^3 b1 (bench.py's inputs) with and without
   checkpoints, equal, timed in turns with their peaks, the 256^3 step also
   against the plain versions; one epoch with momenta on a 64^3 grid
   against the plain versions; one epoch with ``keep_data_on_device``
   ``torch.equal`` to streaming, and one with bfloat16 images; the 2D
   builder, 16 subjects at 256^2 b8 over 2 epochs (K8, K9) against the
   plain versions, and one epoch at ``beta = 0.05`` (K10-K13) with
   checkpointing equal to one without; the epoch walls of 32 subjects at
   128^3 b4, streaming and on the device, beside 8 x the builder's step;
   and, where h5py imports, ``python -m lagomorph_tpu_torch lddmm atlas``
   at 64^3 over 2 epochs against the builder in this process;
6g. (run last, after 6f) the affine stack, plain PyTorch (no kernel), at
   examples/affine_atlas.py's configuration lifted to 3D (32 subjects at
   128^3 drawn as the example draws them, batch 16, 3 epochs, its learning
   rates): ``affine_interp`` at 128^3 b16 in float32 against float64 on the
   card, value and gradients, for the broadcast atlas and batch-N images,
   and two float32 runs of d_I; its times forward and with its backward, one
   affine atlas step with its peak, and ``F.grid_sample`` (border,
   ``align_corners=True``), beside the bound; ``affine_atlas`` in float32,
   float64 and with ``keep_data_on_device``, with epoch walls (the epoch
   loss falling); ``StandardizedDataset`` over the subjects with the
   recovered transforms against float64; one ``LDDMMAtlasBuilder`` epoch
   over the standardized subjects at 128^3 b4 through the kernels (its
   launches counted as 6f counts them); one JSON line of its numbers;
6h. (after 6g) the rest of the core API and the models, float32 through
   the kernels against the plain versions or float64 on the card: (a)
   ``splat``, ``interp_hessian_diagonal_image``, ``Ad``, ``ad_star``,
   ``sym``, ``Ad_dagger`` (K1, K3) and ``expmap_advect`` (K2, K3) at 128^3
   b4 against float64, their launches, two float32 splats within 1e-6 of
   max, ``splat``'s time beside its bound, and one atlas step at 64^3 b4
   under ``set_warp_mode("bounded")`` and ``("general")`` (K3's launches
   only; ``p`` within ``FALLBACK_P_TOL`` of float64; "auto" restored);
   (b) ``lddmm_register`` at examples/pairwise_registration.py's
   configuration (BASELINE.json config 3) on 256^2 b8 (K8, K9) and 128^3
   b4 (K1-K3, K6, K7), 10 of its 100 iterations, against its plain run
   (losses, momenta), the loss falling, the launches (counters set to 0
   just before, read just after), ms an iteration; (c)
   ``affine_register`` and ``rigid_register`` at 128^3 b4, 5 iterations,
   against float64; (d) ``DeepLDDMMAtlas`` at examples/deep_lddmm_atlas.py's
   configuration (config 5), 16 subjects at 256^2 over 2 epochs and 8 at
   128^3 b4 over 1, against its plain run (epoch losses, atlas), its
   launches, epoch walls and peak, and the net's forward and backward
   beside its bound (TF32 off, as the port runs it; TF32 on and
   ``cudnn.benchmark`` as yardsticks); one JSON line of its numbers;
6i. (after 6h) the data path: (a) which of h5py, zarr, numexpr,
   matplotlib and sklearn import; 8 of profile_atlas.py's subjects at
   256^3 downscaled by 2 on the host (``data.DownscaledDataset``, README.md's
   ``data downscale`` step) against ``F.avg_pool3d`` on the card (1e-6 of
   max), ``CropDataset`` through ``parse_slice_spec`` and ``NumexprDataset``
   through its vetted fallback against numpy, and, where h5py imports,
   ``python -m lagomorph_tpu_torch data downscale`` against them; (b) the
   builder over the downscaled subjects at 128^3 b4, 2 epochs, with 2
   loader workers: threads, worker processes (``loader_mode="process"``),
   worker processes over the native read-ahead cache
   (``dataloader_cache``) and threads over it, each ``torch.equal`` to the
   threads' run, launching ``STEP_LAUNCHES`` an iteration, the cache a
   ``NativeBatchCache``, no prefetcher degraded under
   ``LM_PREFETCH_TIMEOUT=30``, their epoch walls; one ``ProcessPrefetcher``
   alone over the minibatches; (c) one 64^3 b4 atlas step with
   ``set_debug_mode`` on ``torch.equal`` to it off, both timed, a NaN in
   one voxel of the momenta raising ``FloatingPointError`` naming a kernel,
   the mode off after; (d) ``profiling.device_time`` of that step, a
   ``profiling.trace`` around it holding the port's kernels, a
   ``profiling.Timer``; one JSON line of its numbers;
6j. (after 6i) ``parallel/``, every mesh entry and process on the one card,
   so nothing here measures communication: (a) one spatially sharded atlas
   step (``make_lddmm_atlas_step(spatial_mesh=...)``, bench.py's inputs) at
   128^3 b4 over 2 and 4 X slabs and at 256^3 b1 over 4, the counters set
   to 0 just before and read just after (K1, K2, K6, K7 once per slab per
   substep, no other kernel), its loss against the dense kernel step's
   (1e-5 relative), ``p`` against a float64 sharded run on the plain
   versions (``P_TOL``), that run against the float64 dense run (1e-9 of
   max), the ms of both steps and their peaks; (b) the builder (8 of 6f's
   subjects at 128^3, 2 epochs, minibatches of 4 and of 3), ``affine_atlas``
   at 128^3 b16 and ``DeepLDDMMAtlas`` on 16 subjects at 256^2, 1 epoch
   each, with a mesh of 2 entries of the card against none (losses and
   atlas 1e-6, momenta in relative L2 to ``P_TOL``); (c) two processes on
   the card over gloo (the builder at 128^3, 8 subjects, 2 a minibatch
   each, 2 epochs): both ranks equal, and equal to one process over the
   same global minibatches; then a one-rank world on ``cpu:gloo,cuda:nccl``
   (its collectives, and a builder epoch in it ``torch.equal`` to one
   without); one JSON line of its numbers;
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
# launches in one 2D shooting's forward and backward: the whole shooting is
# one K8, its backward one K9; the 2D fluid solve is plain PyTorch (as in the
# JAX package) and no 3D kernel runs (the models, which warp by the gather)
STEP2D_LAUNCHES = {"shoot2d_fwd": 1, "shoot2d_bwd": 1}
# the 2D unit-regime warp K17 and its backward K18: the atlas loss's warp,
# once each in every 2D atlas step
KERNELS_WARP2D = ("warp2d_fwd", "warp2d_bwd")
STEP2D_WARP_LAUNCHES = dict.fromkeys(KERNELS_WARP2D, 1)
STEP2D_ATLAS_LAUNCHES = {**STEP2D_LAUNCHES, **STEP2D_WARP_LAUNCHES}
# the 2D step with a compressible fluid metric (`lddmm atlas --fluid_beta
# 0.05`): K8's gate is closed by beta, so each of the 4 substeps after the
# peeled first runs K10 (Ad*), the plain rfftn solve and K11 (compose), and
# the backward K12 and K13 per substep
PARAMS_BETA = (0.1, 0.05, 0.01)
STEP2D_BETA_LAUNCHES = {**{k: STEPS - 1 for k in KERNELS_2D_PER_OP}, **STEP2D_WARP_LAUNCHES}
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
    others = KERNELS_2D + KERNELS_2D_PER_OP + KERNELS_WARP2D + KERNELS_SOLVE
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
        check(all(k in KERNELS_2D_PER_OP + KERNELS_WARP2D for k in launched),
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


def warp2d_checks(device, shape, seed, timed=False):
    """Phase 3, the 2D unit-regime warp at one shape (``N`` subjects of the
    2-channel field ``shape``): K17 ``torch.equal`` to the plain stencil and
    K18, through the wrapper under ``torch.autograd.grad``, within 1e-5 * (1
    + max|ref|) of autograd of the plain stencil, for a batch-1 one-channel
    image (the atlas, dI summed over the subjects) and a batch-N
    two-channel field; one launch of each a call, a second K18 launch
    bit-identical.  ``timed``: also the ms a call (CUDA events, 20 calls) of
    K17, K18 and the plain forward and backward on the atlas, beside the
    bound.  Returns ({kernel: err}, {kernel: its times} (empty unless
    ``timed``))."""
    from lagomorph_tpu_torch.ops.kernels import launch_counts, plain_versions, warp2d

    N, _, H, W = shape
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    p = t(rng.uniform(-0.99, 0.99, shape))
    errs = dict.fromkeys(KERNELS_WARP2D, 0.0)
    log(f"2D unit warp K17/K18 at {'x'.join(map(str, shape))}:")
    for nb, C in ((1, 1), (N, 2)):
        label = f"I({nb},{C})"
        I = t(rng.standard_normal((nb, C, H, W)))
        g = t(rng.standard_normal((N, C, H, W)))
        before = launch_counts()
        out = warp2d.sample_displacement_unit(I, p)
        with plain_versions():
            ref = warp2d.sample_displacement_unit(I, p)
        check(torch.equal(out, ref), f"warp2d_fwd {label}: not bit-equal to the plain stencil "
              f"(max diff {max_err(out, ref):.3e})")
        log(f"  warp2d_fwd {label}: bit-equal to the plain stencil")
        grads = []
        for plain in (False, True):
            leaves = (I.clone().requires_grad_(True), p.clone().requires_grad_(True))
            with plain_versions() if plain else contextlib.nullcontext():
                grads.append(torch.autograd.grad(warp2d.sample_displacement_unit(*leaves),
                                                 leaves, g))
        for what, a, b in zip(("dI", "d_disp"), *grads):
            errs["warp2d_bwd"] = max(errs["warp2d_bwd"],
                                     compare(f"warp2d_bwd {label} {what}", a, b, 1e-5))
        after = launch_counts()
        check((after["warp2d_fwd"] - before["warp2d_fwd"], after["warp2d_bwd"]
               - before["warp2d_bwd"]) == (2, 1), f"warp2d {label}: launches")
        again = warp2d._launch_bwd(I, p, g)
        check(all(torch.equal(a, b) for a, b in zip(grads[0], again)),
              f"warp2d_bwd {label}: two launches differ")
    times = {}
    if timed:
        I = t(rng.standard_normal((1, 1, H, W)))
        g = t(rng.standard_normal((N, 1, H, W)))
        V = H * W
        b_fwd = bound(4 * (2 * N * V + V + N * V), 0)[0]
        b_bwd = bound(4 * (2 * 2 * N * V + N * V + 2 * V), 0)[0]

        def plain_both():
            leaves = (I.clone().requires_grad_(True), p.clone().requires_grad_(True))
            with plain_versions():
                return torch.autograd.grad(warp2d.sample_displacement_unit(*leaves), leaves, g)

        k17 = time_ms(lambda: warp2d._launch(I, p), device, 20)
        k18 = time_ms(lambda: warp2d._launch_bwd(I, p, g), device, 20)
        p_fwd = time_ms(lambda: warp2d.sample_displacement_unit_plain(I, p), device, 20)
        p_both = time_ms(plain_both, device, 20)
        times = {"warp2d_fwd": {"ms": k17, "plain_ms": p_fwd, "library_ms": None,
                                "bound_ms": b_fwd, "bound_by": "bytes"},
                 "warp2d_bwd": {"ms": k18, "plain_ms": p_both - p_fwd, "library_ms": None,
                                "bound_ms": b_bwd, "bound_by": "bytes"}}
        log(f"  K17 {k17:.4f} ms ({k17 / b_fwd:.2f}x its bound {b_fwd:.4f}), K18 "
            f"{k18:.4f} ms ({k18 / b_bwd:.2f}x its bound {b_bwd:.4f}); the plain "
            f"stencil {p_fwd:.4f} ms forward, {p_both:.4f} with autograd's backward "
            f"[{card_line()}]")
    return errs, times


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


def atlas_steps_2d(lt, device, params=PARAMS, launches=STEP2D_ATLAS_LAUNCHES):
    """Phases 6b and 6c, the 2D main paths: ``CHAIN`` chained 2D atlas steps
    with ``FluidMetric(params)`` at 256^2 b8 and 512^2 b8 on bench.py's
    inputs, and at 256^2 b8 on its momenta scaled to max|v0| = 0.5, through
    the kernels and the plain versions, each step's momentum gradient held
    against a float64 one.  The counters are set to 0 just before the 256^2
    bench momenta's kernel steps and read just after: each step must make
    ``launches`` (6b, ``beta == 0``: K8 and K9 once; 6c, ``beta != 0``:
    K10-K13 four times each; both K17 and K18 once), and no other kernel
    may run.  Returns those counts."""
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
# the 3D affine warp per output voxel, one channel: the coordinates A (x -
# o) + T + o (9 products, 9 sums), floors, fractions and 1 - fractions (9),
# 8 corner weights (2 products each), 8 products and 7 sums; its backward
# recomputes the coordinates and weights (43), scatters g w (16), takes the
# 3 slopes (11 each) times g (3) and accumulates d_A and d_T (21)
AFFINE_FWD_OPS = 18 + 9 + 16 + 15
AFFINE_BWD_OPS = 18 + 9 + 16 + 16 + 3 * 11 + 3 + 21


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
    # the affine warp of a batch-1 one-channel atlas by N transforms (the
    # transforms' 12 N floats left out)
    if name == "affine_interp":  # read the atlas; write out
        return atlas + f1, N * V * AFFINE_FWD_OPS
    if name == "affine_interp_bwd":  # read g and the atlas; write d_I
        return f1 + 2 * atlas, N * V * AFFINE_BWD_OPS
    raise KeyError(name)


def pass_work(kind, N, NI, C, V, compose=False):
    """(bytes, operations) of the warp backward's pass in each mode, as K5,
    K6 and K7 run it: the transpose alone (``kind == "transpose"``: read the
    displacement and the cotangent, write the ``NI``-batch image gradient)
    or with the weight gradient (``kind == "pass"``: read the image too,
    write the displacement gradient too; with the compose epilogue, s g + s
    dd); or K6's first pass (``kind == "adstar_first"``, ``C == 3``: read
    phiinv, the ``NI``-batch momenta, the cotangent and the warped momenta,
    write ``d_mw`` and ``d_phiinv``)."""
    if kind == "transpose":
        return 4 * V * (3 * N + N * C + NI * C), N * V * transpose_ops(C)
    if kind == "adstar_first":
        return 4 * V * (5 * 3 * N + 3 * NI), N * V * (JAC_OPS + weight_grad_ops(3) + DIV_OPS + 3)
    return (4 * V * (3 * N + N * C + 2 * NI * C + 3 * N),
            N * V * (transpose_ops(C) + weight_grad_ops(C) + (3 if compose else 0)))


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

    # the warp backward's pass in each mode at the operand shapes the step
    # runs, at b4 and at the atlas cell's b50: with the weight gradient as
    # K5 runs it (C = 1, the atlas summed over the subjects) and K7 (C = 3,
    # the compose epilogue), the transpose alone as K6 (C = 3, NI = N)
    st = stream_of(phiinv)
    PASS_B = 50
    big = (PASS_B,) + FULL[1:]
    p50, v50, g50 = (t(rng.uniform(-0.99, 0.99, big)), t(rng.uniform(-4.9, 4.9, big)),
                     t(rng.standard_normal(big)))
    g1_50 = t(rng.standard_normal((PASS_B, 1, X, Y, Z)))
    for b in (N, PASS_B):
        dI1, d3, dd3 = torch.empty_like(I), torch.empty_like(p50[:b]), torch.empty_like(p50[:b])
        for label, kind, args in (
                ("with the weight gradient C=1 NI=1 (K5)", "pass",
                 (I, p50[:b], 1.0, g1_50[:b], dI1, d3, 1, 1, False)),
                ("transpose alone C=3 NI=N (K6)", "transpose",
                 (None, p50[:b], 1.0, g50[:b], d3, None, b, 3, False)),
                ("with the weight gradient C=3 compose (K7)", "pass",
                 (p50[:b], v50[:b], -0.2, g50[:b], d3, dd3, b, 3, True))):
            img_, disp, s, cot, out_t, out_dd, NI, C, compose = args
            if kind == "pass":
                fn = (lambda img_=img_, disp=disp, s=s, cot=cot, out_t=out_t, out_dd=out_dd,
                      NI=NI, C=C, compose=compose: _build.call(
                          "lagomorph_warp_dd", img_.data_ptr(), disp.data_ptr(), s,
                          cot.data_ptr(), out_t.data_ptr(), out_dd.data_ptr(), b, NI, C, X, Y,
                          Z, int(compose), st))
            else:
                fn = (lambda disp=disp, s=s, cot=cot, out_t=out_t, NI=NI, C=C: _build.call(
                    "lagomorph_warp_transpose", disp.data_ptr(), s, cot.data_ptr(),
                    out_t.data_ptr(), b, NI, C, X, Y, Z, st))
            k1 = time_ms(fn, device, 10)
            k2 = time_ms(fn, device, 10)
            b_ms, b_by = bound(*pass_work(kind, b, NI, C, V, compose))
            log(f"time pass {label}: {k1:.4f}/{k2:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"{(k1 + k2) / 2 / b_ms:.2f}x the bound, per call at 128^3 b{b} [{card}]")
    del p50, v50, g50, g1_50
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


# Phase 6f: the atlas builder (``LDDMMAtlasBuilder``) at the JAX package's
# end-to-end configuration (scripts/atlas_e2e_tpu.py, through
# profile_atlas.py: blobs from seed 0 offset by up to 2 voxels,
# FluidMetric([0.05, 0, 0.05]), reg_weight 1e-2, learning rates 1e-3 (pose)
# and 50 (image), 5 integration steps)
BUILDER_3D = (128, 8, 4, 3)  # resolution, subjects, batch, epochs
BUILDER_2D = (256, 16, 8, 2)
BUILDER_WALLS = (128, 32, 4, 2)
BUILDER_CLI = (64, 8, 4, 2)
BIG = (1, 3, 256, 256, 256)  # bench.py's EXTRA_CONFIGS, 256cubed_b1
# the builder through the kernels against the plain versions, float32:
# every iteration's loss (relative), the atlas (of max|I|), each
# minibatch's momenta (relative L2)
BUILDER_LOSS_TOL, BUILDER_ATLAS_TOL, BUILDER_M_TOL = 1e-5, 1e-5, 1e-3
# an atlas step with gradient checkpointing: each of the 4 substeps' forward
# kernels (3D: K1, K2 and its K3 solve; 2D at beta != 0: K10, K11) runs
# again in the backward
STEP_CKPT_LAUNCHES = {**STEP_LAUNCHES, "ad_star_fwd": 8, "compose_fwd": 8, "fluid_flat": 14}
STEP2D_BETA_CKPT_LAUNCHES = {**STEP2D_BETA_LAUNCHES, "ad_star2d_fwd": 8, "compose2d_fwd": 8}
BUILDER_BETA = (0.05, 0.05, 0.05)  # the end-to-end metric with beta != 0
# the north-star run's pose learning rate, offsets and integration steps
# (BASELINE.md, "North-star"), whose momenta move
BUILDER_ACTIVE = {"offset": 8.0, "learning_rate_pose": 500.0, "lddmm_integration_steps": 10}


def builder_run(b, plain=False):
    """Run the builder ``b`` through the kernels (or the plain versions),
    the launch counters set to 0 just before and read just after.  Returns
    its launches (the kernels launched), its wall in seconds and its peak
    device memory in GiB."""
    from lagomorph_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with kernels.plain_versions() if plain else contextlib.nullcontext():
        b.run()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launched = {k: n for k, n in kernels.launch_counts().items() if n}
    return launched, wall, torch.cuda.max_memory_allocated(device) / 2**30


def builder_state(b):
    """The builder's atlas and momenta (float64, on the host) and its
    iteration and epoch losses."""
    ms = [m if isinstance(m, torch.Tensor) else torch.from_numpy(m) for m in b.ms]
    return (b.I.detach().double().cpu(), [m.detach().double().cpu() for m in ms],
            list(b.iter_losses), list(b.epoch_losses))


def builder_diff(got, ref):
    """(largest relative loss difference, atlas max abs difference over
    max|ref atlas|, largest relative L2 difference of a minibatch's
    momenta)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got[2], ref[2]))
    atlas = max_err(got[0], ref[0]) / float(ref[0].abs().max())
    return loss, atlas, max(rel_l2(a, b) for a, b in zip(got[1], ref[1]))


def builder_compare(label, got, ref):
    """Hold a builder run through the kernels against the plain versions'
    (``BUILDER_*_TOL``)."""
    check(len(got[2]) == len(ref[2]) and len(got[1]) == len(ref[1]), f"{label}: runs differ")
    loss, atlas, mom = builder_diff(got, ref)
    log(f"  {label}: kernels vs plain: iteration losses rel {loss:.3e} (tol "
        f"{BUILDER_LOSS_TOL:g}), atlas {atlas:.3e} of max|I| ({BUILDER_ATLAS_TOL:g}), momenta "
        f"rel l2 {mom:.3e} ({BUILDER_M_TOL:g}); epoch losses {got[3]} (plain {ref[3]})")
    check(all(np.isfinite(x) for x in got[2]) and bool(torch.isfinite(got[0]).all()),
          f"{label}: non-finite loss or atlas")
    for name, err, tol in (("loss", loss, BUILDER_LOSS_TOL), ("atlas", atlas, BUILDER_ATLAS_TOL),
                           ("momenta", mom, BUILDER_M_TOL)):
        check(err <= tol, f"{label}: {name} differs from the plain run by {err:.3e} > {tol:g}")


def builder_equal(label, got, ref):
    same = (torch.equal(got[0], ref[0]) and all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
            and got[2] == ref[2] and got[3] == ref[3])
    log(f"  {label}: atlas, momenta and losses torch.equal: {same}")
    check(same, f"{label}: results differ")


def want_launches(per_step, iterations):
    return {k: n * iterations for k, n in per_step.items() if n}


def ckpt_step_ab(lt, device, card, shape, label):
    """One atlas step at ``shape`` on bench.py's inputs through the kernels
    with and without gradient checkpointing: each step's launches, its
    results equal both ways, its ms per step (in turns: without, with,
    with, without) and its peak device memory."""
    from lagomorph_tpu_torch.ops import kernels

    metric = lt.FluidMetric(PARAMS)
    I, m, img = bench_inputs(device, shape)
    steps = {ckpt: lt.make_lddmm_atlas_step(metric, reg_weight=REG_WEIGHT,
                                            learning_rate_pose=LR_POSE, integration_steps=STEPS,
                                            checkpoints=ckpt) for ckpt in (False, True)}
    out, peak = {}, {}
    for ckpt, step in steps.items():
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launches()
        out[ckpt] = step(I, m, img)
        torch.cuda.synchronize(device)
        peak[ckpt] = torch.cuda.max_memory_allocated(device) / 2**30
        launched = {k: n for k, n in kernels.launch_counts().items() if n}
        want = STEP_CKPT_LAUNCHES if ckpt else STEP_LAUNCHES
        check(launched == want, f"{label} checkpoints={ckpt}: launches {launched}, want {want}")
    same = all(torch.equal(a, b) for a, b in zip(out[False], out[True]))
    samples = {False: [], True: []}
    for ckpt in (False, True, True, False):
        samples[ckpt].append(time_ms(lambda: float(steps[ckpt](I, m, img)[2]), device, 3,
                                     warmup=1))
    a, b = samples[False], samples[True]
    log(f"time atlas step ({label}, {shape[2]}^3 b{shape[0]}): without checkpoints "
        f"{a[0]:.3f}/{a[1]:.3f} ms, peak {peak[False]:.3f} GiB; with checkpoints "
        f"{b[0]:.3f}/{b[1]:.3f} ms, peak {peak[True]:.3f} GiB; results torch.equal: {same} "
        f"[{card}]")
    check(same, f"{label}: the checkpointed step differs")
    check(all(bool(torch.isfinite(x).all()) for x in out[False]), f"{label}: non-finite step")
    return I, m, img, out[False]


def atlas_builder(lt, device, card):
    """Phase 6f, the atlas builder over epochs (``BUILDER_*``): the 3D
    builder at 128^3 through the kernels, the plain versions and in float64;
    gradient checkpointing (equal, with the recomputed forwards' launches;
    the step at 128^3 b4 and 256^3 b1); momenta on a half grid; the data on
    the device and bfloat16 images; the 2D builder at 256^2 with ``beta =
    0`` (K8, K9) and at ``beta = 0.05`` under checkpointing (K10-K13);
    epoch walls at 32 subjects; the ``lddmm atlas`` command."""
    import importlib
    import tempfile

    from profile_atlas import e2e_builder, subjects
    from lagomorph_tpu_torch.ops import kernels

    torch.cuda.empty_cache()  # the earlier phases' cached blocks

    have = {}
    for mod in ("h5py", "tqdm"):
        try:
            importlib.import_module(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    log(f"builder: on this machine h5py imports: {have['h5py']}, tqdm imports: {have['tqdm']}")

    # the 3D builder at 128^3: kernels, plain versions, float64
    res, n, batch, epochs = BUILDER_3D
    imgs = list(subjects(res, n, 2.0, device))
    iters = epochs * (n // batch)
    label = f"3D builder {res}^3, {n} subjects b{batch}, {epochs} epochs"
    b = e2e_builder(lt, imgs, device, epochs, batch)
    launched, wall, peak = builder_run(b)
    kern = builder_state(b)
    log(f"{label} through the kernels: {wall:.2f} s, peak {peak:.3f} GiB, epoch losses "
        f"{b.epoch_losses}; launches {launched}")
    check(launched == want_launches(STEP_LAUNCHES, iters),
          f"{label}: launches {launched}, want {STEP_LAUNCHES} x {iters}")
    check(b.epoch_losses[-1] < b.epoch_losses[0], f"{label}: the epoch loss did not fall")
    b = e2e_builder(lt, imgs, device, epochs, batch)
    launched, wall, _ = builder_run(b, plain=True)
    check(not launched, f"{label}: the plain run launched {launched}")
    plain = builder_state(b)
    log(f"{label} through the plain versions: {wall:.2f} s")
    builder_compare(label, kern, plain)
    # float64 takes the plain versions, whose intermediates at 128^3 b4 in
    # float64 outgrow the card unless each substep is rematerialised
    b = e2e_builder(lt, imgs, device, epochs, batch, dtype=np.float64,
                    gradient_checkpointing=True)
    launched, wall, _ = builder_run(b)
    check(not launched, f"{label} float64: launched {launched}")
    ref64 = builder_state(b)
    for name, st in (("kernels", kern), ("plain float32", plain)):
        loss, atlas, mom = builder_diff(st, ref64)
        log(f"  {label}: drift of the {name} run from a float64 plain run ({wall:.2f} s) after "
            f"{epochs} epochs: atlas max {atlas:.3e} of max|I|, rel l2 {rel_l2(st[0], ref64[0]):.3e};"
            f" momenta rel l2 {mom:.3e}; iteration losses rel {loss:.3e}; final epoch loss "
            f"{st[3][-1]!r} (float64 {ref64[3][-1]!r})")
    del b, kern, plain, ref64

    # the same builder with moving momenta: the pose learning rate, offsets
    # and integration steps of the JAX package's north-star run
    # (BASELINE.md), through the kernels, the plain versions and in float64
    imgs_far = list(subjects(res, n, BUILDER_ACTIVE["offset"], device))
    kw = {k: v for k, v in BUILDER_ACTIVE.items() if k != "offset"}
    st = {}
    for name, plain, dtype in (("kernels", False, np.float32), ("plain float32", True, np.float32),
                               ("float64", False, np.float64)):
        b = e2e_builder(lt, imgs_far, device, epochs, batch, dtype=dtype,
                        gradient_checkpointing=dtype == np.float64, **kw)
        launched, wall, _ = builder_run(b, plain)
        st[name] = builder_state(b)
        log(f"{label}, moving momenta {BUILDER_ACTIVE} ({name}): {wall:.2f} s, epoch losses "
            f"{b.epoch_losses}, max|m| {max(float(m.abs().max()) for m in st[name][1]):.4e}; "
            f"launches {launched}")
    check(st["kernels"][3][-1] < st["kernels"][3][0], "moving momenta: the loss did not fall")
    for name in ("kernels", "plain float32"):
        loss, atlas, mom = builder_diff(st[name], st["float64"])
        log(f"  moving momenta: drift of the {name} run from float64 after {epochs} epochs: "
            f"atlas max {atlas:.3e} of max|I|, rel l2 {rel_l2(st[name][0], st['float64'][0]):.3e}"
            f"; momenta rel l2 {mom:.3e}; iteration losses rel {loss:.3e}")
    builder_compare(f"{label}, moving momenta", st["kernels"], st["plain float32"])
    del b, st, imgs_far

    # gradient checkpointing: one epoch each way, then one step at 128^3 b4
    # and at 256^3 b1
    runs = {}
    for ckpt in (False, True):
        b = e2e_builder(lt, imgs, device, 1, batch, gradient_checkpointing=ckpt)
        launched, wall, peak = builder_run(b)
        runs[ckpt] = builder_state(b)
        want = want_launches(STEP_CKPT_LAUNCHES if ckpt else STEP_LAUNCHES, n // batch)
        log(f"3D builder one epoch, gradient_checkpointing={ckpt}: {wall:.2f} s, peak "
            f"{peak:.3f} GiB; launches {launched}")
        check(launched == want, f"checkpointing={ckpt}: launches {launched}, want {want}")
    builder_equal("3D builder with gradient checkpointing vs without", runs[True], runs[False])
    ckpt_step_ab(lt, device, card, FULL, "bench inputs")
    I, m, img, big = ckpt_step_ab(lt, device, card, BIG, "bench inputs")
    with kernels.plain_versions():
        ref = make_step(lt, lt.FluidMetric(PARAMS))(I, m, img)
    rel = abs(float(big[2]) - float(ref[2])) / abs(float(ref[2]))
    e_I = max_err(big[1], ref[1]) / float(ref[1].abs().max())
    log(f"  step at {BIG[2]}^3 b{BIG[0]} (route {lt.ops.fluid.fluid_route(BIG, PARAMS)}) vs the plain "
        f"versions: loss rel {rel:.3e}, I_grad rel {e_I:.3e}")
    check(rel <= 1e-5 and e_I <= 1e-5, f"the step at {BIG[2]}^3 differs from the plain versions")
    del I, m, img, big, ref

    # momenta on a half grid (the CLI's --deformation_downscale 2)
    half = (res // 2,) * 3
    st = {}
    for plain in (False, True):
        b = e2e_builder(lt, imgs, device, 1, batch, momentum_shape=half)
        launched, wall, _ = builder_run(b, plain)
        st[plain] = builder_state(b)
        log(f"3D builder one epoch, momenta at {half} on {res}^3 images "
            f"({'plain' if plain else 'kernels'}): {wall:.2f} s; launches {launched}")
        if not plain:
            check(all(launched.get(k, 0) > 0 for k in ("ad_star_fwd", "compose_fwd", "fluid_flat",
                                                        "ad_star_bwd", "compose_bwd")),
                  f"half grid: a shooting kernel was not launched: {launched}")
    check(tuple(st[False][1][0].shape[2:]) == half, "half grid: momenta of the wrong shape")
    builder_compare("half-grid momenta", st[False], st[True])

    # the data kept on the device; bfloat16 images
    b = e2e_builder(lt, imgs, device, 1, batch, keep_data_on_device=True)
    builder_run(b)
    builder_equal("keep_data_on_device vs streaming", builder_state(b), runs[False])
    b = e2e_builder(lt, imgs, device, 1, batch, image_dtype="bfloat16")
    builder_run(b)
    check(b._staged(0)[0].dtype == torch.bfloat16, "bfloat16: images not staged in bfloat16")
    log(f"  image_dtype=bfloat16: epoch loss {b.epoch_losses[0]!r} (float32 images "
        f"{runs[False][3][0]!r})")
    check(np.isfinite(b.epoch_losses[0]), "bfloat16: non-finite loss")
    del b, runs, st, imgs

    # the 2D builder at 256^2: beta = 0 (K8, K9), then beta = 0.05 (K10-K13)
    res2, n2, batch2, epochs2 = BUILDER_2D
    imgs2 = list(subjects(res2, n2, 2.0, device, dim=2))
    label = f"2D builder {res2}^2, {n2} subjects b{batch2}, {epochs2} epochs"
    st = {}
    for plain in (False, True):
        b = e2e_builder(lt, imgs2, device, epochs2, batch2)
        launched, wall, peak = builder_run(b, plain)
        st[plain] = builder_state(b)
        log(f"{label} ({'plain' if plain else 'kernels'}): {wall:.2f} s, peak {peak:.3f} GiB, "
            f"epoch losses {b.epoch_losses}; launches {launched}")
        want = {} if plain else want_launches(STEP2D_ATLAS_LAUNCHES, epochs2 * (n2 // batch2))
        check(launched == want, f"{label}: launches {launched}, want {want}")
    check(st[False][3][-1] < st[False][3][0], f"{label}: the epoch loss did not fall")
    builder_compare(label, st[False], st[True])
    for ckpt in (False, True):
        b = e2e_builder(lt, imgs2, device, 1, batch2, params=BUILDER_BETA,
                        gradient_checkpointing=ckpt)
        launched, wall, peak = builder_run(b)
        st[ckpt] = builder_state(b)
        want = want_launches(STEP2D_BETA_CKPT_LAUNCHES if ckpt else STEP2D_BETA_LAUNCHES,
                             n2 // batch2)
        log(f"2D builder one epoch, beta={BUILDER_BETA[1]}, gradient_checkpointing={ckpt}: {wall:.2f} s, "
            f"peak {peak:.3f} GiB; launches {launched}")
        check(launched == want, f"2D beta checkpointing={ckpt}: launches {launched}, want {want}")
    builder_equal("2D builder, beta = 0.05, with gradient checkpointing vs without",
                  st[True], st[False])
    del b, st, imgs2

    # epoch walls at 32 subjects, streaming and on the device
    res, n, batch, epochs = BUILDER_WALLS
    imgs = list(subjects(res, n, 2.0, device))
    for on_device in (False, True):
        b = e2e_builder(lt, imgs, device, epochs, batch, keep_data_on_device=on_device)
        b.initialize()
        walls = []
        for b._epoch in range(epochs):
            t0 = time.perf_counter()
            b.epoch()
            torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t0)
        img, m = b._staged(0)[:2]
        step_ms = time_ms(lambda: float(b._step(b.I, m, img)[2]), device, 3, warmup=1)
        iters = n // batch
        log(f"epoch walls, {res}^3, {n} subjects b{batch}, "
            f"{'keep_data_on_device' if on_device else 'streaming'}: "
            f"{', '.join(f'{w:.4f}' for w in walls)} s; {iters} x the builder's step "
            f"({step_ms:.3f} ms) = {iters * step_ms / 1e3:.4f} s; the rest (staging and host): "
            f"{', '.join(f'{w - iters * step_ms / 1e3:.4f}' for w in walls)} s [{card}]")
        del b, img, m
    del imgs

    # the lddmm atlas command
    if not have["h5py"]:
        log("builder CLI: did not run: h5py does not import on this machine")
        return
    import h5py

    res, n, batch, epochs = BUILDER_CLI
    imgs = subjects(res, n, 2.0, device)
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "images.h5"), os.path.join(tmp, "atlas.h5")
        with h5py.File(src, "w") as f:
            f.create_dataset("images", data=imgs)
        args = ["--num_epochs", str(epochs), "--batch_size", str(batch), "--fluid_alpha", "0.05",
                "--fluid_gamma", "0.05", "--reg_weight", "0.01", "--learning_rate_m", "1e-3",
                "--learning_rate_I", "50"]
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "lagomorph_tpu_torch", "lddmm", "atlas", src, out,
                            *args], cwd=HERE, capture_output=True, text=True, timeout=600,
                           env=dict(os.environ, PYTHONPATH=HERE))
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"the lddmm atlas command failed:\n{r.stderr[-3000:]}")
        b = e2e_builder(lt, lt.data.H5Dataset(src), device, epochs, batch)
        b.run()
        with h5py.File(out, "r") as f:
            got = (torch.from_numpy(f["atlas"][...]).double(),
                   [torch.from_numpy(f["momenta"][...]).double()],
                   list(f["iter_losses"][...]), list(f["epoch_losses"][...]))
        ref = builder_state(b)
        ref = (ref[0], [torch.cat(ref[1])], ref[2], ref[3])
        diff = builder_diff(got, ref)
        same = torch.equal(got[0], ref[0]) and torch.equal(got[1][0], ref[1][0])
        losses = got[3]
        log(f"builder CLI: python -m lagomorph_tpu_torch lddmm atlas at {res}^3, {n} subjects "
            f"b{batch}, {epochs} epochs: {wall:.2f} s (process start included); epoch losses "
            f"{[float(x) for x in losses]}; against the builder in this process: losses rel {diff[0]:.3e}, atlas "
            f"{diff[1]:.3e}, momenta rel l2 {diff[2]:.3e}, torch.equal {same}")
        check(max(diff) <= 1e-6 and losses[-1] < losses[0], "the lddmm atlas command's result")


# Phase 6g: the affine stack at examples/affine_atlas.py's configuration
# lifted to 3D: subjects drawn as the example draws them (A = eye + 0.05 x
# a standard normal, a shift uniform in +-3 voxels, an anisotropic Gaussian
# blob, here of widths res/5, res/7, res/9), minibatches of 16, the
# example's learning rates and no ridge terms
AFFINE_3D = (128, 32, 16, 3)  # resolution, subjects, batch, epochs
AFFINE_RATES = {"learning_rate_A": 1e-3, "learning_rate_T": 1e-1, "learning_rate_I": 1e2}
AFFINE_LDDMM_BATCH = 4  # the LDDMM epoch over the standardized subjects
# float32 on the card against float64 on the card (PERF.md, PR 19):
# affine_interp's output (of max|I|), d_I (of max|d_I|) and d_A, d_T (of
# their max|ref|: a slope of the linear interpolation jumps where a float32
# coordinate lands across an integer from the float64 one); affine_atlas's
# iteration losses (relative), atlas (of max|I|), As and Ts (relative L2:
# their gradients cancel to a few thousandths of their terms, so those
# jumps weigh more), and the standardized images (of max|image|)
AFFINE_OUT_TOL, AFFINE_DI_TOL, AFFINE_DAT_TOL = 1e-5, 1e-4, 2e-3
AFFINE_LOSS_TOL, AFFINE_ATLAS_TOL, AFFINE_AT_TOL, AFFINE_STD_TOL = 1e-5, 1e-5, 0.1, 1e-5


def affine_subjects(res, n, device, seed=0):
    """``(n, 1, res, res, res)`` float32 subjects drawn with numpy from
    ``seed`` (``AFFINE_3D``'s comment), evaluated on ``device``."""
    rng = np.random.default_rng(seed)
    axis = torch.arange(res, dtype=torch.float64, device=device)
    grid = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"))
    c = (res - 1) / 2
    widths = (res / 5, res / 7, res / 9)
    out = np.empty((n, 1) + (res,) * 3, dtype=np.float32)
    for i in range(n):
        A = torch.tensor(np.eye(3) + 0.05 * rng.standard_normal((3, 3)), device=device)
        t = torch.tensor(rng.uniform(-3, 3, 3) + c, device=device)
        x = torch.einsum("ab,b...->a...", A, grid - c) + t.view(3, 1, 1, 1)
        r2 = sum(((x[d] - c) / widths[d]) ** 2 for d in range(3))
        out[i, 0] = torch.exp(-r2 / 2).float().cpu().numpy()
    return out


def affine_grid(I, A, T):
    """``F.grid_sample``'s grid (align_corners=True) for ``affine_interp(I,
    A, T)`` of a 3D ``I``: the same coordinates, normalised to [-1, 1], last
    axis (z, y, x)."""
    from lagomorph_tpu_torch.ops.sampling import identity_grid

    spatial = tuple(I.shape[2:])
    o = torch.tensor([(n - 1) * 0.5 for n in spatial], dtype=I.dtype, device=I.device)
    grid = identity_grid(spatial, dtype=I.dtype, device=I.device) - o.view(3, 1, 1, 1)
    coords = torch.einsum("nab,b...->na...", A, grid) + (T + o).view(-1, 3, 1, 1, 1)
    size = torch.tensor(spatial, dtype=I.dtype, device=I.device).view(1, 3, 1, 1, 1)
    return (2.0 * coords / (size - 1) - 1.0).flip(1).permute(0, 2, 3, 4, 1).contiguous()


@contextlib.contextmanager
def epoch_walls(lt, device):
    """Record the wall of each epoch of ``affine_atlas`` (run with
    ``progress_bar=True``), synchronised at each epoch's start and end,
    through the progress helper it wraps its epochs in; the other progress
    bars are left out.  Yields the list of walls in seconds."""
    walls = []
    helpers = (lt.affine, lt.data)
    saved = [h.progress for h in helpers]

    def timed(iterable, desc=None, **kw):
        if desc != "epoch":
            return iterable

        def epochs():
            for x in iterable:
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                yield x
                torch.cuda.synchronize(device)
                walls.append(time.perf_counter() - t0)
        return epochs()

    for h in helpers:
        h.progress = timed
    try:
        yield walls
    finally:
        for h, p in zip(helpers, saved):
            h.progress = p


def affine_interp_checks(lt, device, card, imgs):
    """Phase 6g (a) and (b): ``affine_interp`` at 128^3 b16 in float32
    against float64 on the card, value and gradients, for the broadcast
    atlas and a batch-N image; two float32 runs of d_I; then its times,
    forward and with its backward, one atlas step with its peak, and the
    ``grid_sample`` yardstick, beside the bound."""
    import torch.nn.functional as F

    from lagomorph_tpu_torch.affine import make_affine_atlas_step

    N = AFFINE_3D[2]
    res, V = imgs.shape[-1], imgs[0].size
    rng = np.random.default_rng(7)
    A = torch.tensor(np.eye(3) + rng.uniform(-0.05, 0.05, (N, 3, 3)), dtype=torch.float32,
                     device=device)
    T = torch.tensor(rng.uniform(-3, 3, (N, 3)), dtype=torch.float32, device=device)
    gen = torch.Generator(device).manual_seed(7)
    g = torch.randn((N, 1) + imgs.shape[2:], generator=gen, device=device)
    atlas = torch.from_numpy(imgs.mean(axis=0, keepdims=True)).to(device)
    batch = torch.from_numpy(imgs[:N]).to(device)
    fidelity = {}
    for label, I in (("broadcast atlas", atlas), ("batch-N images", batch)):
        runs = {}
        for name, dtype in (("float32", torch.float32), ("float32 again", torch.float32),
                            ("float64", torch.float64)):
            leaves = [x.to(dtype, copy=True).requires_grad_(True) for x in (I, A, T)]
            out = lt.affine_interp(*leaves)
            runs[name] = (out.detach(), *torch.autograd.grad(out, leaves, g.to(dtype)))
            del out, leaves
        got, ref = runs["float32"], runs["float64"]
        errs = {}
        for i, (part, tol) in enumerate((("out", AFFINE_OUT_TOL), ("d_I", AFFINE_DI_TOL),
                                         ("d_A", AFFINE_DAT_TOL), ("d_T", AFFINE_DAT_TOL))):
            scale = float(I.abs().max()) if part == "out" else float(ref[i].abs().max())
            errs[part] = (max_err(got[i], ref[i]) / scale, rel_l2(got[i], ref[i]), tol)
        again = runs["float32 again"][1]
        rerun = max_err(again, got[1]) / float(ref[1].abs().max())
        fidelity[label] = {"errors (max of scale, rel l2, tol)": errs,
                      "d_I run to run (of max|d_I|)": rerun,
                      "d_I runs torch.equal": bool(torch.equal(again, got[1]))}
        log(f"affine_interp at {res}^3 b{N}, {label}, float32 against float64 on the card: "
            + "; ".join(f"{k} {e:.3e} of max (rel l2 {r:.3e}, tol {t:g})"
                        for k, (e, r, t) in errs.items())
            + f"; two float32 runs of d_I: {rerun:.3e} of max|d_I|, torch.equal "
            f"{torch.equal(again, got[1])}")
        for part, (e, _, tol) in errs.items():
            check(e <= tol, f"affine_interp {label}: {part} {e:.3e} > {tol:g} of max")
        del runs, got, ref, again

    # (b) times, float32, the broadcast atlas (the atlas step's operand)
    leaves = [x.clone().requires_grad_(True) for x in (atlas, A, T)]

    def fwd_bwd():
        out = lt.affine_interp(*leaves)
        return torch.autograd.grad(out, leaves, g)

    ms = {"forward": time_ms(lambda: lt.affine_interp(atlas, A, T), device, 10),
          "forward+backward": time_ms(fwd_bwd, device, 10)}
    grid = affine_grid(atlas, A, T)
    wide = atlas.expand(N, -1, -1, -1, -1)
    ys = F.grid_sample(wide, grid, mode="bilinear", padding_mode="border", align_corners=True)
    ys_err = max_err(ys, lt.affine_interp(atlas, A, T)) / float(atlas.abs().max())
    leaf = atlas.clone().requires_grad_(True)

    def ys_fwd_bwd():
        out = F.grid_sample(leaf.expand(N, -1, -1, -1, -1), grid, mode="bilinear",
                            padding_mode="border", align_corners=True)
        return torch.autograd.grad(out, leaf, g)

    ms["grid_sample forward"] = time_ms(
        lambda: F.grid_sample(wide, grid, mode="bilinear", padding_mode="border",
                              align_corners=True), device, 10)
    ms["grid_sample forward+backward (d_I)"] = time_ms(ys_fwd_bwd, device, 10)
    step = make_affine_atlas_step(3, learning_rate_A=AFFINE_RATES["learning_rate_A"],
                                  learning_rate_T=AFFINE_RATES["learning_rate_T"])
    A0, T0 = A - torch.eye(3, device=device), T.clone()
    mask = torch.ones(N, device=device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    float(step(atlas, A0, T0, batch, mask)[3])
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    ms["atlas step"] = time_ms(lambda: float(step(atlas, A0, T0, batch, mask)[3]), device, 5)
    fb, fo = work("affine_interp", N, V), work("affine_interp_bwd", N, V)
    b_fwd, by_fwd = bound(*fb)
    b_all, by_all = bound(fb[0] + fo[0], fb[1] + fo[1])
    log(f"time affine_interp at {res}^3 b{N} (broadcast atlas, float32): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
        + f"; bound forward {b_fwd:.4f} ms ({by_fwd}), forward+backward {b_all:.4f} ms "
        f"({by_all}): forward {ms['forward'] / b_fwd:.1f}x, forward+backward "
        f"{ms['forward+backward'] / b_all:.1f}x; grid_sample's output from affine_interp's "
        f"{ys_err:.3e} of max|I|; atlas step (affine_steps 1) peak {peak:.3f} GiB [{card}]")
    return fidelity, ms, {"forward": b_fwd, "forward+backward": b_all}, peak


def affine_phase(lt, device, card):
    """Phase 6g: the affine stack on the card at ``AFFINE_3D``:
    ``affine_interp`` (a, b; :func:`affine_interp_checks`); ``affine_atlas``
    in float32 and float64 and with ``keep_data_on_device`` (c);
    ``StandardizedDataset`` over the subjects with the recovered transforms
    against float64, then one LDDMM builder epoch on the standardized
    subjects through the kernels (d).  Prints one JSON line of its
    numbers."""
    from profile_atlas import e2e_builder

    torch.cuda.empty_cache()  # phase 6f's cached blocks
    res, n, batch, epochs = AFFINE_3D
    t0 = time.perf_counter()
    imgs = affine_subjects(res, n, device)
    log(f"affine: {n} subjects at {res}^3 drawn in {time.perf_counter() - t0:.2f} s")
    record = {"card": card, "config": {"res": res, "subjects": n, "batch": batch,
                                       "epochs": epochs, **AFFINE_RATES}}
    (record["affine_interp fidelity"], record["ms"], record["bound ms"],
     record["atlas step peak GiB"]) = affine_interp_checks(lt, device, card, imgs)

    # (c) affine_atlas end to end: float32, float64, float32 on the device
    items = list(imgs)
    runs = {}
    for label, dtype, on_device in (("float32", np.float32, False), ("float64", np.float64, False),
                                    ("float32 keep_data_on_device", np.float32, True)):
        As, Ts = np.zeros((n, 3, 3), dtype), np.zeros((n, 3), dtype)
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with epoch_walls(lt, device) as walls:
            out = lt.affine_atlas(items, As, Ts, num_epochs=epochs, batch_size=batch,
                                  keep_data_on_device=on_device, device=device, **AFFINE_RATES)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        check(out[1] is As and out[2] is Ts, f"affine_atlas {label}: As, Ts not updated in place")
        runs[label] = out
        record[f"affine_atlas {label}"] = {"wall s": wall, "epoch walls s": walls,
                                           "peak GiB": peak, "epoch losses": out[3]}
        log(f"affine_atlas {label}, {n} subjects at {res}^3 b{batch}, {epochs} epochs: {wall:.2f} s "
            f"(set-up included), epoch walls {', '.join(f'{w:.4f}' for w in walls)} s, peak "
            f"{peak:.3f} GiB, epoch losses {out[3]}, max|A| {np.abs(As).max():.4e}, max|T| "
            f"{np.abs(Ts).max():.4e} [{card}]")
        check(len(walls) == epochs, f"affine_atlas {label}: {len(walls)} epoch walls")
        check(all(np.isfinite(x) for x in out[4]) and bool(torch.isfinite(out[0]).all()),
              f"affine_atlas {label}: non-finite loss or atlas")
    ref = runs["float64"]
    check(runs["float32"][3][-1] < runs["float32"][3][0], "affine_atlas: the epoch loss did not fall")
    for label in ("float32", "float32 keep_data_on_device"):
        base = ref if label == "float32" else runs["float32"]
        got = runs[label]
        errs = {"iteration losses": max(abs(a - b) / abs(b) for a, b in zip(got[4], base[4])),
                "atlas": max_err(got[0], base[0]) / float(base[0].abs().max()),
                "As": rel_l2(torch.from_numpy(got[1]), torch.from_numpy(base[1])),
                "Ts": rel_l2(torch.from_numpy(got[2]), torch.from_numpy(base[2]))}
        against = "float64" if label == "float32" else "the streamed float32 run"
        record[f"affine_atlas {label} against {against}"] = errs
        log(f"  affine_atlas {label} against {against}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol: losses {AFFINE_LOSS_TOL:g} rel, "
            f"atlas {AFFINE_ATLAS_TOL:g} of max|I|, As and Ts {AFFINE_AT_TOL:g} rel l2)")
        for k, tol in (("iteration losses", AFFINE_LOSS_TOL), ("atlas", AFFINE_ATLAS_TOL),
                       ("As", AFFINE_AT_TOL), ("Ts", AFFINE_AT_TOL)):
            check(errs[k] <= tol, f"affine_atlas {label}: {k} {errs[k]:.3e} > {tol:g}")

    # (d) the workflow's last two stages: standardize, then an LDDMM epoch
    As, Ts = runs["float32"][1], runs["float32"][2]
    del runs, ref
    t0 = time.perf_counter()
    std = lt.data.MemoryDataset(lt.StandardizedDataset(items, As, Ts, device=device),
                                progress_bar=False)
    std_s = time.perf_counter() - t0
    std64 = lt.StandardizedDataset([x.astype(np.float64) for x in items], As.astype(np.float64),
                                   Ts.astype(np.float64), device=device)
    err = max(float(np.abs(std[i] - std64[i]).max()) / float(np.abs(std64[i]).max())
              for i in range(n))
    check(all(x.dtype == np.float32 and x.shape == items[0].shape for x in std.elements),
          "StandardizedDataset: items of the wrong dtype or shape")
    log(f"StandardizedDataset over {n} subjects at {res}^3 on the card: {std_s:.2f} s; float32 "
        f"against float64: {err:.3e} of max|image| (tol {AFFINE_STD_TOL:g})")
    check(err <= AFFINE_STD_TOL, f"StandardizedDataset: {err:.3e} > {AFFINE_STD_TOL:g}")
    record["StandardizedDataset"] = {"s": std_s, "float32 against float64": err}
    b = e2e_builder(lt, std, device, 1, AFFINE_LDDMM_BATCH)
    launched, wall, peak = builder_run(b)
    want = want_launches(STEP_LAUNCHES, n // AFFINE_LDDMM_BATCH)
    log(f"LDDMM builder, one epoch over the {n} standardized subjects at {res}^3 "
        f"b{AFFINE_LDDMM_BATCH}: {wall:.2f} s, peak {peak:.3f} GiB, epoch loss "
        f"{b.epoch_losses}; launches {launched} [{card}]")
    check(launched == want, f"LDDMM epoch on standardized subjects: launches {launched}, "
          f"want {want}")
    check(np.isfinite(b.epoch_losses[0]), "LDDMM epoch on standardized subjects: non-finite loss")
    record["LDDMM epoch"] = {"wall s": wall, "peak GiB": peak, "loss": b.epoch_losses[0],
                             "launches": launched}
    log(json.dumps({"phase": "6g affine", **record}))


# 6h. the rest of the core API (A.5) at the headline shape, the global warp
# mode's forced tiers at 64^3 b4, and the models (A.8)
ADVECT_STEPS = 5
# float32 on the card against float64 on the card, of max|ref|: the
# scatters, warps and differences; the actions with fluid solves (sym,
# Ad_dagger) as the solves are held in phase 3; expmap_advect's phiinv of
# 1 + max|ref| (voxels) as the slice's; two float32 splats, of max|ref|
A5_TOL, A5_SOLVE_TOL, ADVECT_TOL, SPLAT_RERUN_TOL = 1e-5, 1e-4, 1e-5, 1e-6
# examples/pairwise_registration.py's configuration (BASELINE.json config 3)
# at the bench shapes: its blobs (source width res/6; targets of widths
# res/5, res/7 (and res/6 along z in 3D), the first shifted by (+3, -2)
# (and 0 along z) as the example's, the others by shifts in +-3 voxels from
# numpy seed 0), its metric and rates; 10 of its 100 iterations
REGISTER_PARAMS = (0.1, 0.0, 0.03)
REGISTER = {"num_iters": 10, "learning_rate": 5e-2, "reg_weight": 1e-3, "integration_steps": 5}
REGISTER_2D, REGISTER_3D = FULL2D, FULL
AFFINE_REGISTER = {"num_iters": 5, "learning_rate_A": 1e-2, "learning_rate_T": 3e2}
RIGID_REGISTER = {"num_iters": 5, "learning_rate_v": 1e-1, "learning_rate_T": 3e2}
# the registrations through the kernels against the plain versions,
# float32: every loss (relative) and the momenta (relative L2)
REGISTER_LOSS_TOL, REGISTER_M_TOL = 1e-5, 1e-3
# examples/deep_lddmm_atlas.py's configuration: its blobs (offsets in
# +-2.5 voxels, widths res/6 (1 + 0.2 N(0, 1)), numpy seed 0), metric and
# rates, batch 8 (4 at 128^3); resolution, subjects, batch, epochs
DEEP_PARAMS = (0.05, 0.0, 0.05)
DEEP = {"integration_steps": 4, "reg_weight": 1e-2, "learning_rate_net": 1e-3,
        "learning_rate_image": 30.0}
DEEP_2D, DEEP_3D = (256, 16, 8, 2), (128, 8, 4, 1)
# DeepLDDMMAtlas through the kernels against the plain versions, float32:
# each epoch loss (relative), the atlas (of max|I|)
DEEP_LOSS_TOL, DEEP_ATLAS_TOL = 1e-5, 1e-5
# launches per iteration (recounted from the code): an LDDMM registration
# step of 5 integration steps in 3D (the peeled first step's solve, then 4
# substeps of K1, K3, K2; the backward K6, K7 and K3 for each; the warp is
# the general gather: no K4, K5), the final shooting of lddmm_register (no
# backward), a DeepLDDMMAtlas step of 4 integration steps, and the 2D
# steps at beta = 0 (one K8, its backward one K9)
REGISTER_STEP_3D = {"ad_star_fwd": 4, "compose_fwd": 4, "fluid_flat": 10, "ad_star_bwd": 4,
                    "compose_bwd": 4}
REGISTER_FINAL_3D = {"ad_star_fwd": 4, "compose_fwd": 4, "fluid_flat": 5}
DEEP_STEP_3D = {"ad_star_fwd": 3, "compose_fwd": 3, "fluid_flat": 8, "ad_star_bwd": 3,
                "compose_bwd": 3}
STEP2D_FINAL = {"shoot2d_fwd": 1}


def blob(res, dim, shift, widths, device):
    """A Gaussian blob on a ``res``^``dim`` grid, centred ``shift`` voxels
    off the grid centre, of ``widths`` (standard deviations) by axis,
    float32, evaluated on ``device`` in float64."""
    axis = torch.arange(res, dtype=torch.float64, device=device)
    grid = torch.meshgrid(*[axis] * dim, indexing="ij")
    c = (res - 1) / 2
    r2 = sum(((grid[d] - c - shift[d]) / widths[d]) ** 2 for d in range(dim))
    return torch.exp(-r2 / 2).float()


def register_pair(shape, device):
    """``REGISTER``'s source ``(1, 1, *spatial)`` and ``N`` targets at
    ``shape`` ``(N, dim, *spatial)`` (see its comment)."""
    N, dim, res = shape[0], shape[1], shape[2]
    shifts = np.random.default_rng(0).uniform(-3, 3, (N, dim))
    shifts[0] = (3, -2, 0)[:dim]
    widths = (res / 5, res / 7, res / 6)[:dim]
    src = blob(res, dim, (0.0,) * dim, (res / 6,) * dim, device)[None, None]
    tgt = torch.stack([blob(res, dim, s, widths, device) for s in shifts])[:, None]
    return src, tgt


def deep_subjects(res, n, dim, device):
    """``(n, 1, *[res] * dim)`` float32 blobs drawn as
    examples/deep_lddmm_atlas.py draws them (its ``make_dataset``), on the
    host."""
    rng = np.random.default_rng(0)
    out = np.empty((n, 1) + (res,) * dim, dtype=np.float32)
    for i in range(n):
        off = rng.uniform(-2.5, 2.5, dim)
        w = res / 6 * (1 + 0.2 * rng.standard_normal())
        out[i, 0] = blob(res, dim, off, (w,) * dim, device).cpu().numpy()
    return out


def counted(fn):
    """``fn()`` with the launch counters set to 0 just before and read just
    after: ``(result, {kernel: launches} of the kernels launched)``."""
    from lagomorph_tpu_torch.ops import kernels

    kernels.reset_launches()
    out = fn()
    return out, {k: n for k, n in kernels.launch_counts().items() if n}


def a5_checks(lt, device, card):
    """Phase 6h (a): the A.5 functions at 128^3 b4 in float32 (the kernels
    where they reach one) against float64 on the card, their launches, two
    float32 splats, splat's time beside its bound; then one atlas step at
    64^3 b4 under each forced global warp mode, with no unit-regime kernel
    launched and its momentum gradient against float64.  Returns the
    record."""
    from lagomorph_tpu_torch import lddmm

    N, _, X, Y, Z = FULL
    V = X * Y * Z
    rng = np.random.default_rng(31)
    metric = lt.FluidMetric(PARAMS)

    def pair(a):
        return (torch.as_tensor(a, dtype=torch.float32, device=device),
                torch.as_tensor(a, dtype=torch.float64, device=device))

    u = pair(rng.uniform(-3, 3, FULL))
    phi_unit = pair(rng.uniform(-0.9, 0.9, FULL))
    vals, v, w = (pair(rng.standard_normal(FULL)) for _ in range(3))
    atlas = pair(rng.standard_normal((1, 1, X, Y, Z)))
    m0 = bench_inputs(device)[1]
    m0 = m0 * (0.5 / float(metric.sharp(m0).abs().max()))
    m0 = (m0, m0.double())
    calls = {
        "splat": (lambda i: lt.splat(vals[i], u[i]), A5_TOL, 0.0, {}),
        "interp_hessian_diagonal_image": (
            lambda i: lt.interp_hessian_diagonal_image(atlas[i], u[i]), A5_TOL, 0.0, {}),
        "Ad": (lambda i: lt.Ad(u[i], v[i]), A5_TOL, 0.0, {}),
        "ad_star": (lambda i: lt.ad_star(v[i], w[i]), A5_TOL, 0.0, {}),
        "sym": (lambda i: lt.sym(v[i], w[i], metric), A5_SOLVE_TOL, 0.0, {"fluid_flat": 4}),
        "Ad_dagger": (lambda i: lt.Ad_dagger(phi_unit[i], w[i], metric), A5_SOLVE_TOL, 0.0,
                      {"ad_star_fwd": 1, "fluid_flat": 2}),
        "expmap_advect": (lambda i: lt.expmap_advect(metric, m0[i], num_steps=ADVECT_STEPS),
                          ADVECT_TOL, 1.0, {"compose_fwd": ADVECT_STEPS,
                                            "fluid_flat": ADVECT_STEPS}),
    }
    record = {}
    for name, (fn, tol, offset, want) in calls.items():
        with torch.no_grad():
            got, launched = counted(lambda: fn(0))
            ref = fn(1)
        check(got.dtype == torch.float32 and got.shape == ref.shape, f"{name}: bad output")
        err = compare(f"{name} at 128^3 b4, float32 against float64", got, ref, tol, offset)
        log(f"    launches {launched} (want {want})")
        check(launched == want, f"{name}: launches {launched}, want {want}")
        record[name] = {"max_abs_err": err, "max|ref|": float(ref.abs().max()), "tol": tol,
                        "launches": launched}
        if name == "splat":
            again = fn(0)
            rerun = max_err(again, got) / float(ref.abs().max())
            log(f"  two float32 splats: {rerun:.3e} of max|ref| apart (tol {SPLAT_RERUN_TOL:g}), "
                f"torch.equal {torch.equal(again, got)}")
            check(rerun <= SPLAT_RERUN_TOL, f"splat run to run {rerun:.3e} > {SPLAT_RERUN_TOL:g}")
            record[name].update({"run to run (of max|ref|)": rerun,
                                 "runs torch.equal": bool(torch.equal(again, got))})
        del got, ref
    ms = time_ms(lambda: lt.splat(vals[0], u[0]), device, 10)
    # read the values and the displacement, write the grid; per voxel the
    # weights (floors, fractions, 8 corner products of 2) and per channel 8
    # products and 8 sums
    b_ms, b_by = bound(4 * N * V * (3 + 3 + 3), N * V * (9 + 16 + 16 * 3))
    log(f"time splat at 128^3 b4 (3 channels, |u| < 3, float32): {ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}): {ms / b_ms:.1f}x [{card}]")
    record["splat"].update({"ms": ms, "bound_ms": b_ms, "bound_by": b_by})
    del u, phi_unit, vals, v, w, atlas, m0

    # the global warp mode's forced tiers: one atlas step at 64^3 b4 each
    I, m, img = bench_inputs(device, FULL64)
    m = m * (0.5 / float(metric.sharp(m).abs().max()))
    step = make_step(lt, metric)
    for mode in ("bounded", "general"):
        prev = lt.set_warp_mode(mode)
        try:
            check(lddmm._fast_integrator(metric, m, 0.2, None) is None,
                  f"warp mode {mode}: the hoisted path's gate is open")
            t0 = time.perf_counter()
            out = step_chain(step, I, m, img, "kernels", steps=1)[0][0]
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            launched = {k: n for k, n in out[4].items() if n}
            grads = {k: momentum_grads(metric, I, [m], img, k)[0] for k in ("kernels", "float64")}
        finally:
            lt.set_warp_mode(prev)
        l2 = rel_l2(grads["kernels"][0], grads["float64"][0])
        applied = max_err(out[1], m - LR_POSE * grads["kernels"][0])
        log(f"atlas step at 64^3 b4 under set_warp_mode({mode!r}): {wall:.3f} s (first call), "
            f"launches {launched}; p against float64 relative l2 {l2:.3e} (tol "
            f"{FALLBACK_P_TOL:g}); loss {out[3]!r}, float64 {grads['float64'][1]!r}; m_new - "
            f"(m - lr p) {applied:.3e}")
        check(launched == {"fluid_flat": 2 * STEPS},
              f"warp mode {mode}: launches {launched}, want only K3's {2 * STEPS}")
        check(np.isfinite(out[3]) and l2 <= FALLBACK_P_TOL,
              f"warp mode {mode}: p differs from float64 by {l2:.3e} > {FALLBACK_P_TOL:g}")
        record[f"atlas step 64^3 b4, warp mode {mode}"] = {
            "s": wall, "launches": launched, "p rel l2 against float64": l2}
    check(lt.ops.get_warp_mode() == "auto", "the global warp mode was not restored")
    return record


def registration_run(fn, plain=False):
    """``fn()`` through the kernels (or the plain versions), counted and
    timed (synchronised): ``(result, launches, wall s, peak GiB)``."""
    from lagomorph_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with kernels.plain_versions() if plain else contextlib.nullcontext():
        out, launched = counted(fn)
    torch.cuda.synchronize(device)
    return out, launched, time.perf_counter() - t0, torch.cuda.max_memory_allocated(device) / 2**30


def lddmm_register_checks(lt, device, card):
    """Phase 6h (b): ``lddmm_register`` at ``REGISTER`` on 256^2 b8 (K8,
    K9) and 128^3 b4 (K1-K3, K6, K7) through the kernels against the plain
    versions (losses, momenta), the loss falling, the launches, ms an
    iteration; the float64 run's drift logged."""
    from lagomorph_tpu_torch.models import lddmm_register

    record = {}
    iters = REGISTER["num_iters"]
    for shape, per_step, final in ((REGISTER_2D, STEP2D_LAUNCHES, STEP2D_FINAL),
                                   (REGISTER_3D, REGISTER_STEP_3D, REGISTER_FINAL_3D)):
        label = "x".join(map(str, shape))
        src, tgt = register_pair(shape, device)
        metric = lt.FluidMetric(REGISTER_PARAMS)

        def run(dtype=torch.float32):
            return lddmm_register(src.to(dtype), tgt.to(dtype), metric, **REGISTER)
        got, launched, first, peak = registration_run(run)
        ref, plain_launched, plain_wall, _ = registration_run(run, plain=True)
        r64 = registration_run(lambda: run(torch.float64))[0]
        wall = registration_run(run)[2]  # warm: the first run set up cuFFT plans and buffers
        want = {k: per_step.get(k, 0) * iters + final.get(k, 0) for k in {*per_step, *final}}
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got[2].tolist(), ref[2].tolist()))
        m_err, m64 = rel_l2(got[0], ref[0]), rel_l2(got[0], r64[0])
        h_err = max_err(got[1], ref[1])
        losses = got[2].tolist()
        log(f"lddmm_register at {label}, {iters} iterations: {wall:.3f} s through the kernels "
            f"({wall / iters * 1e3:.2f} ms an iteration, the final shooting included; the first "
            f"run {first / iters * 1e3:.2f}; plain {plain_wall / iters * 1e3:.2f}), peak "
            f"{peak:.3f} GiB; losses {losses[0]!r} -> "
            f"{losses[-1]!r}; kernels vs plain: losses rel {loss_err:.3e} (tol "
            f"{REGISTER_LOSS_TOL:g}), m rel l2 {m_err:.3e} (tol {REGISTER_M_TOL:g}), phiinv "
            f"{h_err:.3e} voxel (max|phiinv| {float(ref[1].abs().max()):.4e}); float64 drift: m "
            f"rel l2 {m64:.3e}, losses rel {max(abs(a - b) / abs(b) for a, b in zip(losses, r64[2].tolist())):.3e}; "
            f"launches {launched} [{card}]")
        check(launched == want, f"lddmm_register {label}: launches {launched}, want {want}")
        check(not plain_launched, f"lddmm_register {label}: the plain run launched a kernel")
        check(all(np.isfinite(losses)) and bool(torch.isfinite(got[1]).all()),
              f"lddmm_register {label}: non-finite loss or phiinv")
        check(losses[-1] < losses[0], f"lddmm_register {label}: the loss did not fall")
        check(loss_err <= REGISTER_LOSS_TOL and m_err <= REGISTER_M_TOL,
              f"lddmm_register {label}: kernels vs plain losses {loss_err:.3e}, m {m_err:.3e}")
        record[f"lddmm_register {label}"] = {
            "ms an iteration": wall / iters * 1e3, "first run ms an iteration": first / iters * 1e3,
            "plain ms an iteration": plain_wall / iters * 1e3,
            "peak GiB": peak, "losses": [losses[0], losses[-1]], "loss rel err": loss_err,
            "m rel l2": m_err, "m rel l2 against float64": m64, "launches": launched}
        del got, ref, r64, src, tgt
    return record


def affine_register_checks(lt, device, card):
    """Phase 6h (c): ``affine_register`` and ``rigid_register`` at 128^3
    b4 on ``REGISTER``'s blobs, float32 against float64 on the card."""
    from lagomorph_tpu_torch.models import affine_register, rigid_register

    src, tgt = register_pair(REGISTER_3D, device)
    record = {}
    for name, fn, kw in (("affine_register", affine_register, AFFINE_REGISTER),
                         ("rigid_register", rigid_register, RIGID_REGISTER)):
        got, launched, first, peak = registration_run(lambda: fn(src, tgt, **kw))
        ref = fn(src.double(), tgt.double(), **kw)
        wall = registration_run(lambda: fn(src, tgt, **kw))[2]  # warm
        errs = {"losses": max(abs(a - b) / abs(b) for a, b in zip(got[2].tolist(),
                                                                  ref[2].tolist())),
                "params": rel_l2(got[0], ref[0]), "T": rel_l2(got[1], ref[1])}
        losses = got[2].tolist()
        log(f"{name} at 128^3 b4, {kw['num_iters']} iterations: {wall / kw['num_iters'] * 1e3:.2f} "
            f"ms an iteration (the first run {first / kw['num_iters'] * 1e3:.2f}), peak "
            f"{peak:.3f} GiB; losses {losses[0]!r} -> {losses[-1]!r}; "
            f"float32 against float64: losses rel {errs['losses']:.3e} (tol {AFFINE_LOSS_TOL:g}), "
            f"A/v rel l2 {errs['params']:.3e}, T {errs['T']:.3e} (tol {AFFINE_AT_TOL:g}); max|T| "
            f"{float(got[1].abs().max()):.4e} [{card}]")
        check(not launched, f"{name}: launched {launched}")
        check(losses[-1] < losses[0], f"{name}: the loss did not fall")
        check(errs["losses"] <= AFFINE_LOSS_TOL and max(errs["params"], errs["T"]) <= AFFINE_AT_TOL,
              f"{name}: float32 against float64 {errs}")
        record[name] = {"ms an iteration": wall / kw["num_iters"] * 1e3,
                        "first run ms an iteration": first / kw["num_iters"] * 1e3, "peak GiB": peak,
                        "losses": [losses[0], losses[-1]], "against float64": errs}
    return record


def momentum_net_ms(device, card, x):
    """ms of one forward and backward (the parameters' gradients) of a
    fresh ``MomentumNet`` on ``x`` (CUDA events, 3 calls), as the port runs
    its convolutions (TF32 off) and, as yardsticks, with cuDNN's TF32 on and
    with its autotuner (``cudnn.benchmark``), each setting restored after;
    beside the float32 bound of its convolutions' operations."""
    import torch.nn.functional as F

    from lagomorph_tpu_torch.models import MomentumNet
    from lagomorph_tpu_torch.models.deep_atlas import init_momentum_net

    dim = x.dim() - 2
    net = init_momentum_net(MomentumNet(dim=dim, in_channels=x.shape[1])).to(device)
    params = list(net.parameters())
    conv = F.conv3d if dim == 3 else F.conv2d

    def fwd_bwd():
        y = x
        for i, c in enumerate(net.convs):
            y = conv(y, c.weight, c.bias, padding=1)
            if i < len(net.convs) - 1:
                y = F.gelu(y, approximate="tanh")
        return torch.autograd.grad(y.square().sum(), params)

    # multiply-adds per voxel: the forward and the weight gradients of every
    # convolution, the input gradients of all but the first
    macs = [c.weight[0].numel() * c.weight.shape[0] for c in net.convs]
    flops = 2 * x.shape[0] * x[0, 0].numel() * (2 * sum(macs) + sum(macs[1:]))
    b_ms, b_by = bound(0, flops)
    cd = torch.backends.cudnn
    prev = (cd.allow_tf32, cd.benchmark)
    ms = {}
    try:
        for label, tf32, bench in (("TF32 off (the port's)", False, False), ("TF32 on", True, False),
                                   ("TF32 off, cudnn.benchmark", False, True)):
            cd.allow_tf32, cd.benchmark = tf32, bench
            ms[label] = time_ms(fwd_bwd, device, 3)
    finally:
        cd.allow_tf32, cd.benchmark = prev
    log(f"MomentumNet forward+backward at {'x'.join(map(str, x.shape))}: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + f"; float32 bound {b_ms:.3f} ms ({b_by}, {flops / 1e9:.1f} GFLOP) [{card}]")
    return {"ms": ms, "bound_ms": b_ms, "GFLOP": flops / 1e9}


def deep_atlas_checks(lt, device, card):
    """Phase 6h (d): ``DeepLDDMMAtlas`` at ``DEEP`` on 16 subjects at 256^2
    over 2 epochs (K8, K9, cuDNN conv2d) and 8 at 128^3 b4 for 1 epoch
    (K1-K3, K6, K7, cuDNN conv3d), through the kernels against the plain
    versions (epoch losses, atlas), the launches, epoch walls and peaks;
    the float64 run's drift logged."""
    from lagomorph_tpu_torch.models import DeepLDDMMAtlas
    from lagomorph_tpu_torch.ops import kernels

    record = {}
    for (res, n, batch, epochs), dim, per_step in ((DEEP_2D, 2, STEP2D_LAUNCHES),
                                                   (DEEP_3D, 3, DEEP_STEP_3D)):
        label = f"{n} subjects at {res}^{dim} b{batch}"
        imgs = list(deep_subjects(res, n, dim, device))
        runs = {}
        for mode, dtype in (("kernels", np.float32), ("plain", np.float32),
                            ("float64", np.float64)):
            model = DeepLDDMMAtlas(imgs, metric=lt.FluidMetric(DEEP_PARAMS), batch_size=batch,
                                   dtype=dtype, progress_bar=False, device=device, **DEEP)
            walls = []
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            kernels.reset_launches()
            with kernels.plain_versions() if mode == "plain" else contextlib.nullcontext():
                for _ in range(epochs):
                    t0 = time.perf_counter()
                    model.fit(num_epochs=1)
                    torch.cuda.synchronize(device)
                    walls.append(time.perf_counter() - t0)
            launched = {k: c for k, c in kernels.launch_counts().items() if c}
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            runs[mode] = (list(model.epoch_losses), model.I.detach().double(), walls, peak,
                          launched)
            if mode == "kernels":  # one epoch more, timed only: the first set up cuDNN
                t0 = time.perf_counter()
                model.fit(num_epochs=1)
                torch.cuda.synchronize(device)
                warm = time.perf_counter() - t0
            del model
        got, ref, r64 = runs["kernels"], runs["plain"], runs["float64"]
        want = want_launches(per_step, epochs * (n // batch))
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0]))
        atlas_err = max_err(got[1], ref[1]) / float(ref[1].abs().max())
        drift = (max(abs(a - b) / abs(b) for a, b in zip(got[0], r64[0])),
                 max_err(got[1], r64[1]) / float(r64[1].abs().max()))
        log(f"DeepLDDMMAtlas, {label}, {epochs} epoch(s): epoch walls "
            f"{', '.join(f'{x:.4f}' for x in got[2])} s and one more {warm:.4f} s (plain "
            f"{', '.join(f'{x:.4f}' for x in ref[2])}, "
            f"float64 {', '.join(f'{x:.4f}' for x in r64[2])}), peak {got[3]:.3f} GiB; epoch losses "
            f"{got[0]} (plain {ref[0]}); kernels vs plain: losses rel {loss_err:.3e} (tol "
            f"{DEEP_LOSS_TOL:g}), atlas {atlas_err:.3e} of max|I| (tol {DEEP_ATLAS_TOL:g}); float64 "
            f"drift: losses rel {drift[0]:.3e}, atlas {drift[1]:.3e}; launches {got[4]} [{card}]")
        check(got[4] == want, f"DeepLDDMMAtlas {label}: launches {got[4]}, want {want}")
        check(not ref[4], f"DeepLDDMMAtlas {label}: the plain run launched {ref[4]}")
        check(all(np.isfinite(got[0])) and bool(torch.isfinite(got[1]).all()),
              f"DeepLDDMMAtlas {label}: non-finite loss or atlas")
        check(loss_err <= DEEP_LOSS_TOL and atlas_err <= DEEP_ATLAS_TOL,
              f"DeepLDDMMAtlas {label}: kernels vs plain losses {loss_err:.3e}, atlas "
              f"{atlas_err:.3e}")
        record[f"DeepLDDMMAtlas {label}"] = {
            "epoch walls s": got[2], "one more epoch s": warm, "plain epoch walls s": ref[2],
            "peak GiB": got[3],
            "epoch losses": got[0], "loss rel err": loss_err, "atlas err": atlas_err,
            "float64 drift (losses, atlas)": drift, "launches": got[4]}
        del runs, got, ref, r64
        x = torch.from_numpy(np.stack(imgs[:batch])).to(device)
        record[f"MomentumNet {label}"] = momentum_net_ms(device, card, x)
        del x
    return record


def models_phase(lt, device, card):
    """Phase 6h: the A.5 functions and the global warp mode (a), then the
    models: ``lddmm_register`` (b), ``affine_register`` and
    ``rigid_register`` (c), ``DeepLDDMMAtlas`` (d).  Prints one JSON line
    of its numbers."""
    torch.cuda.empty_cache()  # phase 6g's cached blocks
    t0 = time.perf_counter()
    record = {"card": card}
    record["a5"] = a5_checks(lt, device, card)
    record.update(lddmm_register_checks(lt, device, card))
    record.update(affine_register_checks(lt, device, card))
    record.update(deep_atlas_checks(lt, device, card))
    record["wall s"] = time.perf_counter() - t0
    log(f"phase 6h: {record['wall s']:.1f} s")
    log(json.dumps({"phase": "6h models", **record}))


# Phase 6i: the data path.  profile_atlas.py's subjects at 256^3, downscaled
# by 2 on the host to the builder's 128^3 (README.md's `data downscale`
# step), then the builder at the end-to-end configuration over them with
# each loader, the debug mode and the profiling helpers
DATA_SUBJECTS = (256, 8)  # resolution, subjects
DATA_BUILDER = (4, 2)  # batch, epochs
DATA_CROP = ("8:-8,0:120,::2", np.s_[:, 8:-8, 0:120, ::2])  # the spec, its numpy slices
DATA_EXPR = "sqrt(abs(x)) * 2 + where(x > 0.5, x, 0)"
DATA_TOL = 1e-6  # DownscaledDataset (host numpy) against F.avg_pool3d, of max|ref|
OPTIONAL_MODULES = ("h5py", "zarr", "numexpr", "matplotlib", "sklearn")


def loader_run(b, epochs):
    """Run the builder ``b`` epoch by epoch as ``run`` does, the launch
    counters set to 0 just before and read just after.  Returns the kernels
    launched, each epoch's wall in seconds (host clock, ending in a
    synchronise), the set-up's seconds (``initialize``: the batches and the
    cache) and whether a prefetcher was built and degraded."""
    from lagomorph_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    torch.cuda.synchronize(device)
    kernels.reset_launches()
    walls = []
    t0 = time.perf_counter()
    b.initialize()
    setup = time.perf_counter() - t0
    try:
        for b._epoch in range(epochs):
            t0 = time.perf_counter()
            loss, reg = b.epoch()
            torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t0)
            b.epoch_losses.append(loss)
            b.epoch_reg_terms.append(reg)
        pf = getattr(b, "_img_prefetch", None)
        prefetcher = (pf is not None, pf is not None and pf._failed)
    finally:
        b.close_loaders()
    launched = {k: n for k, n in kernels.launch_counts().items() if n}
    return launched, walls, setup, prefetcher


@contextlib.contextmanager
def env(name, value):
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            del os.environ[name]
        else:
            os.environ[name] = prev


def dataset_checks(device, card, have):
    """Phase 6i (a): the subjects downscaled by ``DownscaledDataset`` against
    ``F.avg_pool3d`` on the card, ``CropDataset`` through
    ``parse_slice_spec`` and ``NumexprDataset`` through its vetted fallback
    against numpy, and the ``data downscale`` command where h5py imports.
    Returns the downscaled subjects and the phase's numbers."""
    import tempfile

    import torch.nn.functional as F
    from profile_atlas import subjects
    from lagomorph_tpu_torch import data as tdata

    res, n = DATA_SUBJECTS
    t0 = time.perf_counter()
    big = subjects(res, n, 2.0, device)
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    down = tdata.DownscaledDataset(list(big), 2)
    small = np.stack([down[i] for i in range(len(down))])
    host_s = time.perf_counter() - t0
    on_card = torch.from_numpy(big).to(device)
    ref = F.avg_pool3d(on_card, 2)
    card_ms = time_ms(lambda: F.avg_pool3d(on_card, 2), device, 3)
    del on_card
    err = max_err(torch.from_numpy(small), ref.cpu())
    bound = DATA_TOL * float(ref.abs().max())
    log(f"data (a): {n} subjects at {res}^3 ({big.nbytes / 2**30:.3f} GiB, made in {made:.2f} s) "
        f"downscaled by 2 on the host in {host_s:.2f} s to {small.shape} {small.dtype}; against "
        f"F.avg_pool3d on the card ({card_ms:.3f} ms): max abs err {err:.3e} (bound {bound:.3e}) "
        f"[{card}]")
    check(small.shape == (n, 1) + (res // 2,) * 3 and small.dtype == np.float32,
          "DownscaledDataset: wrong shape or dtype")
    check(np.isfinite(small).all() and err <= bound, "DownscaledDataset differs from avg_pool3d")
    del ref

    spec, slices = DATA_CROP
    crop = tdata.CropDataset(list(small), tdata.parse_slice_spec(spec))
    crop_ok = all(np.array_equal(crop[i], small[i][slices]) for i in range(n))
    saved = sys.modules.get("numexpr")
    sys.modules["numexpr"] = None  # the vetted fallback, whether or not numexpr imports
    try:
        expr = tdata.NumexprDataset(list(small), DATA_EXPR)
        x = small[3]
        expr_ok = np.array_equal(expr[3], np.sqrt(np.abs(x)) * 2 + np.where(x > 0.5, x, 0))
    finally:
        if saved is None:
            del sys.modules["numexpr"]
        else:
            sys.modules["numexpr"] = saved
    log(f"data (a): CropDataset({spec!r}) equal to numpy: {crop_ok}; NumexprDataset("
        f"{DATA_EXPR!r}) through the vetted fallback equal to numpy: {expr_ok}")
    check(crop_ok and expr_ok, "CropDataset or NumexprDataset differs from numpy")
    record = {"subjects": f"{n} x {res}^3", "downscale host s": host_s,
              "avg_pool3d ms on the card": card_ms, "downscale max abs err": err}

    if not have["h5py"]:
        log("data (a): the data downscale command did not run: h5py does not import here")
        return small, record
    import h5py

    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "subjects.h5"), os.path.join(tmp, "down.h5")
        with h5py.File(src, "w") as f:
            f.create_dataset("images", data=big)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "lagomorph_tpu_torch", "data", "downscale", src,
                            out, "--scale", "2"], cwd=HERE, capture_output=True, text=True,
                           timeout=600, env=dict(os.environ, PYTHONPATH=HERE))
        record["data downscale command s"] = time.perf_counter() - t0
        check(r.returncode == 0, f"data downscale failed:\n{r.stderr[-3000:]}")
        with h5py.File(out, "r") as f:
            same = np.array_equal(f["images"][...], small)
    log(f"data (a): python -m lagomorph_tpu_torch data downscale: "
        f"{record['data downscale command s']:.2f} s, equal to DownscaledDataset: {same}")
    check(same, "the data downscale command differs from DownscaledDataset")
    return small, record


def loader_checks(lt, device, card, small):
    """Phase 6i (b): the builder over the downscaled subjects at 128^3 with
    the thread loader, the process loader, the process loader over the
    native cache and the thread loader over it: each run ``torch.equal`` to
    the thread loader's, its launches ``STEP_LAUNCHES`` an iteration, the
    cache a ``NativeBatchCache``, no prefetcher degraded
    (``LM_PREFETCH_TIMEOUT=30``); then one ``ProcessPrefetcher`` alone over
    the minibatches.  Returns the walls."""
    import tempfile
    import warnings

    from profile_atlas import e2e_builder
    from lagomorph_tpu_torch import data as tdata
    from lagomorph_tpu_torch.native import NativeBatchCache

    batch, epochs = DATA_BUILDER
    imgs = list(small)
    iters = epochs * (len(imgs) // batch)
    want = want_launches(STEP_LAUNCHES, iters)
    record = {}
    ref = None
    with tempfile.TemporaryDirectory() as tmp, env("LM_PREFETCH_TIMEOUT", "30"):
        for label, opts in (
                ("thread", {"loader_mode": "thread"}),
                ("process", {"loader_mode": "process"}),
                ("process + cache", {"loader_mode": "process",
                                     "dataloader_cache": os.path.join(tmp, "p")}),
                ("thread + cache", {"loader_mode": "thread",
                                    "dataloader_cache": os.path.join(tmp, "t")})):
            b = e2e_builder(lt, imgs, device, epochs, batch, loader_workers=2, **opts)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                launched, walls, setup, (built, failed) = loader_run(b, epochs)
            degraded = [str(w.message) for w in caught
                        if issubclass(w.category, RuntimeWarning) and "degraded" in str(w.message)]
            st = builder_state(b)
            kind = type(b._batches).__name__
            log(f"data (b): {label}: epoch walls {', '.join(f'{w:.4f}' for w in walls)} s, "
                f"set-up {setup:.3f} s, batches {kind}, prefetcher built {built}, degraded "
                f"{failed}, warnings {degraded}; launches {launched} [{card}]")
            record[label] = {"epoch walls s": walls, "setup s": setup, "batches": kind}
            check(launched == want, f"loader {label}: launches {launched}, want {want}")
            check(not degraded and not failed, f"loader {label}: the prefetcher degraded")
            check(built == (opts["loader_mode"] == "process"),
                  f"loader {label}: prefetcher built: {built}")
            if "dataloader_cache" in opts:
                check(isinstance(b._batches, NativeBatchCache),
                      f"loader {label}: the cache is a {kind}, not a NativeBatchCache")
            if ref is None:
                ref = st
            else:
                builder_equal(f"loader {label} vs thread", st, ref)
            del b
    thread = record["thread"]["epoch walls s"][-1]
    for label, r in record.items():
        log(f"data (b): second epoch {r['epoch walls s'][-1]:.4f} s with {label}, "
            f"{r['epoch walls s'][-1] / thread:.3f} x the thread loader's")

    batches = list(tdata.batch_iterator(imgs, batch))
    pf = tdata.ProcessPrefetcher(batches, workers=2)
    try:
        with env("LM_PREFETCH_TIMEOUT", "30"):
            t0 = time.perf_counter()
            for i in range(len(batches)):
                pf.submit(i)
            got = [pf.get(i) for i in range(len(batches))]
            wall = time.perf_counter() - t0
        same = all(np.array_equal(g, x) for g, x in zip(got, batches))
        failed = pf._failed
    finally:
        pf.close()
    log(f"data (b): ProcessPrefetcher alone, 2 workers, {len(batches)} batches of "
        f"{batches[0].nbytes / 2**20:.0f} MiB: equal to the direct reads {same}, degraded "
        f"{failed}, {wall:.3f} s (fork included)")
    check(same and not failed, "ProcessPrefetcher alone: a batch differs or it degraded")
    record["prefetcher alone s"] = wall
    return record


def debug_checks(lt, device, card):
    """Phase 6i (c) and (d): one 64^3 b4 atlas step (bench.py's inputs, the
    default route, K1-K7) with the debug mode on ``torch.equal`` to the step
    with it off, its ms both ways; a NaN in one voxel of ``m`` raises
    ``FloatingPointError`` naming a kernel; the mode off again.  Then
    ``profiling``: ``device_time`` of the step, a ``trace`` around it
    holding the port's kernels, a ``Timer``."""
    import glob
    import tempfile

    from lagomorph_tpu_torch import lddmm, profiling
    from lagomorph_tpu_torch.ops import kernels

    metric = lt.FluidMetric(PARAMS)
    I, m, img = bench_inputs(device, FULL64)

    def grads(mm):
        m_ = mm.detach().requires_grad_(True)
        I_ = I.detach().requires_grad_(True)
        loss, _ = lddmm._lddmm_loss(I_, m_, img, metric, REG_WEIGHT, STEPS)
        return (*torch.autograd.grad(loss, (m_, I_)), loss.detach())

    record = {}
    out = {}
    try:
        for on in (False, True):
            lt.set_debug_mode(on)
            out[on], launched = counted(lambda: grads(m))
            check(launched == STEP_LAUNCHES, f"debug={on}: launches {launched}")
            record[f"step ms, debug {'on' if on else 'off'}"] = time_ms(lambda: grads(m), device, 3)
        same = all(torch.equal(a, b) for a, b in zip(out[False], out[True]))
        bad = m.clone()
        bad[1, 2, 7, 9, 11] = float("nan")
        try:
            grads(bad)
            raised = None
        except FloatingPointError as e:
            raised = str(e)
    finally:
        lt.set_debug_mode(False)
    named = raised is not None and any(raised.startswith(k) for k in kernels.KERNELS)
    log(f"data (c): 64^3 b4 step (p, I_grad, loss) with the debug mode torch.equal to without: "
        f"{same}; ms off {record['step ms, debug off']:.3f}, on {record['step ms, debug on']:.3f} "
        f"[{card}]; a NaN in m raised: {raised!r}; mode off after: {not kernels.debug_mode()}")
    check(same, "the debug mode changed the step")
    check(named, "a NaN in m did not raise FloatingPointError naming a kernel")
    check(not kernels.debug_mode(), "the debug mode is still on")

    record["device_time ms"] = profiling.device_time(lambda: grads(m), warmup=1, iters=5) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            grads(m)
        paths = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        check(len(paths) == 1, f"trace wrote {paths}")
        ours = [e for e in device_events(paths[0])
                if e.get("cat") == "kernel" and "lagomorph::" in e["name"]]
    timer = profiling.Timer()
    for _ in range(3):
        with timer("step"):
            grads(m)
            torch.cuda.synchronize(device)
    summary = timer.summary()
    log(f"data (d): profiling.device_time of the step {record['device_time ms']:.3f} ms; "
        f"profiling.trace caught {len(ours)} kernel events of the port "
        f"({len({e['name'] for e in ours})} kernels); Timer {summary}")
    check(len(ours) > 0, "profiling.trace holds no kernel of the port")
    record["trace kernel events"] = len(ours)
    record["timer mean ms"] = summary["step"]["mean_s"] * 1e3
    return record


def data_phase(lt, device, card):
    """Phase 6i, the data path: (a) the datasets, (b) the builder's
    loaders, (c) the debug mode, (d) profiling.  Prints one JSON line of
    its numbers."""
    import importlib

    torch.cuda.empty_cache()  # phase 6h's cached blocks
    t0 = time.perf_counter()
    have = {}
    for mod in OPTIONAL_MODULES:
        try:
            importlib.import_module(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    log(f"data: on this machine these import: {have}")
    record = {"card": card, "imports": have}
    small, record["datasets"] = dataset_checks(device, card, have)
    record["loaders"] = loader_checks(lt, device, card, small)
    del small
    record["debug and profiling"] = debug_checks(lt, device, card)
    record["wall s"] = time.perf_counter() - t0
    log(f"phase 6i: {record['wall s']:.1f} s")
    log(json.dumps({"phase": "6i data", **record}))


# 6j. parallel/: the spatially sharded atlas step (X slabs on a mesh naming
# the one card several times), data parallelism on such a mesh, and two
# processes over torch.distributed
SPATIAL_CASES = ((FULL, 2), (FULL, 4), (BIG, 4))  # shape, slabs
# launches of one spatially sharded atlas step per slab: its 4 substeps'
# K1 and K2 and their backwards K6 and K7; the fluid solves are the pencil
# solve on torch.fft and the atlas warp the gather (no K3, K4, K5)
SPATIAL_STEP_LAUNCHES = {"ad_star_fwd": STEPS - 1, "compose_fwd": STEPS - 1,
                         "ad_star_bwd": STEPS - 1, "compose_bwd": STEPS - 1}
# the sharded step's loss against the dense step's, through the kernels
# (relative); the float64 sharded run (plain versions) against the float64
# dense run: p and the loss, of max|ref|
SPATIAL_LOSS_TOL, SPATIAL_F64_TOL = 1e-5, 1e-9
# the builders and models with a 2-entry mesh against none: every loss
# (relative) and the atlas (of max|ref|); the momenta and the affine
# transforms in relative L2 norm, to their float32 gradients' own accuracy
# against float64 (P_TOL, AFFINE_AT_TOL): a shard of the minibatch pairs
# other subjects' components in K3's packed solve (x[:F] + i x[F:]), and
# sums each subject's voxels in other blocks, so the gradients round
# differently
MESH_TOL, MESH_M_TOL = 1e-6, P_TOL
MESH_BUILDER = (128, 8, 2)  # resolution, subjects, epochs (6f's subjects)
MESH_AFFINE = (128, 32, 16, 1)  # resolution, subjects, batch, epochs (6g's)
MESH_DEEP = (256, 16, 8, 1)  # 6h's 2D DeepLDDMMAtlas, one epoch
# two processes on the card (gloo), each 2 subjects a minibatch, against one
# process over the same global minibatches: losses (relative), the atlas
# (of max|ref|), the momenta as the mesh's
MP_BUILDER = (128, 8, 2, 2)  # resolution, subjects, per-process batch, epochs
MP_TOL = 1e-5
MP_TIMEOUT_S = 300


def spatial_grads(metric, mesh, I, m, img, dtype, plain):
    """The momentum gradient ``p`` and the loss of ``sharded_atlas_loss`` on
    X slabs of ``mesh``, in ``dtype``, through the kernels or the plain
    versions (float64 rematerialises the substeps, to bound its memory)."""
    from lagomorph_tpu_torch.ops import kernels
    from lagomorph_tpu_torch.parallel import sharded_atlas_loss, spatial_sharding
    from lagomorph_tpu_torch.parallel.mesh import Sharded

    sp = spatial_sharding(mesh, 5)
    ms, Is = (Sharded([x.detach().requires_grad_(True) for x in sp.put(v.detach().to(dtype))],
                      2, mesh) for v in (m, I))
    with kernels.plain_versions() if plain else contextlib.nullcontext():
        loss, _ = sharded_atlas_loss(metric, Is, ms, sp.put(img.to(dtype)), mesh,
                                     reg_weight=REG_WEIGHT, num_steps=STEPS,
                                     checkpoints=dtype == torch.float64)
        grads = torch.autograd.grad(loss, [*ms, *Is])
    return ms.like(list(grads[:mesh.size])).gather(), float(loss.detach())


def dense_grads64(metric, I, m, img):
    """``p`` and the loss of the dense ``_lddmm_loss`` in float64 on the
    plain versions (substeps rematerialised)."""
    from lagomorph_tpu_torch import lddmm
    from lagomorph_tpu_torch.ops import kernels

    with kernels.plain_versions():
        m_ = m.detach().double().requires_grad_(True)
        I_ = I.detach().double().requires_grad_(True)
        loss, _ = lddmm._lddmm_loss(I_, m_, img.double(), metric, REG_WEIGHT, STEPS, True)
        return torch.autograd.grad(loss, (m_, I_))[0], float(loss.detach())


def peak_of(fn, device):
    """``fn()``'s peak device memory in GiB."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) / 2**30


def spatial_checks(lt, device, card):
    """Phase 6j (a): one spatially sharded atlas step (bench.py's inputs)
    at 128^3 b4 over 2 and 4 slabs and at 256^3 b1 over 4, every slab on the
    one card: its launches (K1, K2, K6, K7 once per slab per substep, no
    other kernel), its loss against the dense kernel step's, its ``p``
    against a float64 sharded run on the plain versions, that run against
    the float64 dense run, and the ms of both steps with their peaks."""
    from lagomorph_tpu_torch.parallel import spatial_sharding
    from lagomorph_tpu_torch.parallel.mesh import Mesh

    metric = lt.FluidMetric(PARAMS)
    record = {}
    for shape, n in SPATIAL_CASES:
        label = f"{shape[2]}^3 b{shape[0]} over {n} slabs"
        I, m, img = bench_inputs(device, shape)
        mesh = Mesh([device] * n)
        sp = spatial_sharding(mesh, 5)
        dense = make_step(lt, metric)
        spatial = lt.make_lddmm_atlas_step(metric, reg_weight=REG_WEIGHT,
                                           learning_rate_pose=LR_POSE, lddmm_steps=1,
                                           integration_steps=STEPS, spatial_mesh=mesh)
        Is, ms, imgs = sp.put(I), sp.put(m), sp.put(img)
        loss_d = float(dense(I, m, img)[2])
        torch.cuda.synchronize(device)
        out, launched = counted(lambda: spatial(Is, ms, imgs))
        loss_s = float(out[2])
        want = {k: v * n for k, v in SPATIAL_STEP_LAUNCHES.items()}
        rel = abs(loss_s - loss_d) / abs(loss_d)
        check(len(out[0]) == n and all(tuple(x.shape) == (shape[0], 3, shape[2] // n) + shape[3:]
                                       for x in out[0]), f"spatial {label}: slabs of the wrong shape")
        check(all(bool(torch.isfinite(x).all()) for x in (*out[0], *out[1])),
              f"spatial {label}: non-finite momenta or atlas gradient")
        check(launched == want, f"spatial {label}: launches {launched}, want {want}")
        check(rel <= SPATIAL_LOSS_TOL, f"spatial {label}: loss {loss_s!r} against the dense "
              f"step's {loss_d!r}: {rel:.3e} > {SPATIAL_LOSS_TOL:g}")
        p32, _ = spatial_grads(metric, mesh, I, m, img, torch.float32, plain=False)
        p64, l64 = spatial_grads(metric, mesh, I, m, img, torch.float64, plain=True)
        pd64, ld64 = dense_grads64(metric, I, m, img)
        p_rel = rel_l2(p32, p64)
        f64_err = max_err(p64, pd64) / float(pd64.abs().max())
        f64_loss = abs(l64 - ld64) / abs(ld64)
        del p32, p64, pd64
        check(p_rel <= P_TOL, f"spatial {label}: p against float64 {p_rel:.3e} > {P_TOL:g}")
        check(f64_err <= SPATIAL_F64_TOL and f64_loss <= SPATIAL_F64_TOL,
              f"spatial {label}: float64 sharded against dense: p {f64_err:.3e}, loss "
              f"{f64_loss:.3e} > {SPATIAL_F64_TOL:g}")
        ms_s = time_ms(lambda: spatial(Is, ms, imgs), device, 3)
        ms_d = time_ms(lambda: dense(I, m, img), device, 3)
        peak_s = peak_of(lambda: spatial(Is, ms, imgs), device)
        peak_d = peak_of(lambda: dense(I, m, img), device)
        log(f"spatial {label}: loss {loss_s!r} (dense {loss_d!r}, rel {rel:.3e}); p against "
            f"float64 sharded rel l2 {p_rel:.3e} (tol {P_TOL:g}); float64 sharded against dense "
            f"p {f64_err:.3e}, loss {f64_loss:.3e} of max (tol {SPATIAL_F64_TOL:g}); launches "
            f"{launched}; step {ms_s:.3f} ms, peak {peak_s:.3f} GiB (dense step {ms_d:.3f} ms, "
            f"peak {peak_d:.3f} GiB); the slabs share one card, so nothing here measures "
            f"communication [{card}]")
        record[label] = {"loss rel to dense": rel, "p rel l2 to float64": p_rel,
                         "float64 sharded vs dense p": f64_err, "launches": launched,
                         "step ms": ms_s, "dense step ms": ms_d, "peak GiB": peak_s,
                         "dense peak GiB": peak_d}
        del I, m, img, Is, ms, imgs, out
        torch.cuda.empty_cache()
    return record


def rel_max(got, ref):
    return max_err(got, ref) / float(ref.double().abs().max())


def mesh_diff(got, ref):
    """(largest relative loss difference, atlas max abs difference of
    max|ref|, momenta relative L2 difference, momenta max abs difference of
    max|ref|) of two ``builder_state``s."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got[2], ref[2]))
    mg, mr = torch.cat(got[1]), torch.cat(ref[1])
    return loss, rel_max(got[0], ref[0]), rel_l2(mg, mr), rel_max(mg, mr)


def mesh_checks(lt, device, card):
    """Phase 6j (b): the builder (8 of 6f's subjects at 128^3, 2 epochs, in
    minibatches of 4 and of 3: padding and the mask) with a 2-entry mesh of
    the card against no mesh, its launches the step's twice an iteration;
    ``affine_atlas`` at 128^3 b16 for 1 epoch and ``DeepLDDMMAtlas`` on 16
    subjects at 256^2 for 1 epoch, each with a 2-entry mesh against none."""
    from profile_atlas import e2e_builder, subjects
    from lagomorph_tpu_torch.models import DeepLDDMMAtlas
    from lagomorph_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh([device] * 2)
    record = {}
    res, n, epochs = MESH_BUILDER
    imgs = list(subjects(res, n, 2.0, device))
    for batch in (4, 3):
        runs = {}
        for label, kw in (("none", {}), ("mesh", {"mesh": mesh})):
            b = e2e_builder(lt, imgs, device, epochs, batch, **kw)
            launched, wall, peak = builder_run(b)
            runs[label] = (builder_state(b), launched, wall)
        iters = epochs * -(-n // batch)
        want = want_launches(STEP_LAUNCHES, 2 * iters)
        diffs = mesh_diff(runs["mesh"][0], runs["none"][0])
        log(f"mesh builder, {n} subjects at {res}^3 b{batch} over 2 entries, {epochs} epochs: "
            f"losses rel {diffs[0]:.3e}, atlas {diffs[1]:.3e} of max (tol {MESH_TOL:g}), momenta "
            f"rel l2 {diffs[2]:.3e} (tol {MESH_M_TOL:g}), {diffs[3]:.3e} of max; walls "
            f"{runs['mesh'][2]:.3f} s (no mesh {runs['none'][2]:.3f} s); launches "
            f"{runs['mesh'][1]} [{card}]")
        check(runs["mesh"][1] == want, f"mesh builder b{batch}: launches {runs['mesh'][1]}, "
              f"want {want}")
        check(diffs[0] <= MESH_TOL and diffs[1] <= MESH_TOL and diffs[2] <= MESH_M_TOL,
              f"mesh builder b{batch}: {diffs}")
        record[f"builder b{batch}"] = {"losses rel": diffs[0], "atlas": diffs[1],
                                       "momenta rel l2": diffs[2], "momenta of max": diffs[3],
                                       "wall s": runs["mesh"][2],
                                       "no mesh wall s": runs["none"][2]}
    del imgs

    res, n, batch, epochs = MESH_AFFINE
    items = list(affine_subjects(res, n, device))
    out = {}
    for label, kw in (("none", {}), ("mesh", {"mesh": mesh})):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out[label] = lt.affine_atlas(items, np.zeros((n, 3, 3), np.float32),
                                     np.zeros((n, 3), np.float32), num_epochs=epochs,
                                     batch_size=batch, device=device, progress_bar=False,
                                     **AFFINE_RATES, **kw)
        torch.cuda.synchronize(device)
        out[label] += (time.perf_counter() - t0,)
    got, ref = out["mesh"], out["none"]
    As, Ts = ((torch.from_numpy(got[k]), torch.from_numpy(ref[k])) for k in (1, 2))
    diffs = {"losses rel": max(abs(a - b) / abs(b) for a, b in zip(got[4], ref[4])),
             "atlas": rel_max(got[0], ref[0]), "As rel l2": rel_l2(*As),
             "Ts rel l2": rel_l2(*Ts), "As of max": rel_max(*As), "Ts of max": rel_max(*Ts)}
    log(f"mesh affine_atlas, {n} subjects at {res}^3 b{batch} over 2 entries, {epochs} epoch: "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()) + f" (tol: losses and atlas "
        f"{MESH_TOL:g}, As and Ts rel l2 {AFFINE_AT_TOL:g}); {got[5]:.3f} s (no mesh "
        f"{ref[5]:.3f} s) [{card}]")
    check(diffs["losses rel"] <= MESH_TOL and diffs["atlas"] <= MESH_TOL
          and diffs["As rel l2"] <= AFFINE_AT_TOL and diffs["Ts rel l2"] <= AFFINE_AT_TOL,
          f"mesh affine_atlas: {diffs}")
    record["affine_atlas"] = {**diffs, "s": got[5], "no mesh s": ref[5]}
    del items, out, got, ref

    res, n, batch, epochs = MESH_DEEP
    imgs = list(deep_subjects(res, n, 2, device))
    models = {}
    for label, kw in (("none", {}), ("mesh", {"mesh": mesh})):
        model = DeepLDDMMAtlas(imgs, metric=lt.FluidMetric(DEEP_PARAMS), batch_size=batch,
                               progress_bar=False, device=device, **DEEP, **kw)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        model.fit(num_epochs=epochs)
        torch.cuda.synchronize(device)
        models[label] = (model, time.perf_counter() - t0)
    got, ref = models["mesh"][0], models["none"][0]
    net = max(rel_max(a.detach(), b.detach())
              for a, b in zip(got.net.parameters(), ref.net.parameters()))
    diffs = {"losses rel": max(abs(a - b) / abs(b)
                               for a, b in zip(got.epoch_losses, ref.epoch_losses)),
             "atlas": rel_max(got.I, ref.I)}
    log(f"mesh DeepLDDMMAtlas, {n} subjects at {res}^2 b{batch} over 2 entries, {epochs} epoch: "
        f"epoch losses rel {diffs['losses rel']:.3e}, atlas {diffs['atlas']:.3e} (tol "
        f"{MESH_TOL:g}); the net's parameters {net:.3e} of max; {models['mesh'][1]:.3f} s (no "
        f"mesh {models['none'][1]:.3f} s) [{card}]")
    check(all(v <= MESH_TOL for v in diffs.values()), f"mesh DeepLDDMMAtlas: {diffs}")
    record["DeepLDDMMAtlas"] = {**diffs, "net params": net, "s": models["mesh"][1],
                                "no mesh s": models["none"][1]}
    return record


def mp_worker(mode, rank, world, port, outdir):
    """One process of phase 6j (c), on the card: ``gloo``, rank ``rank`` of
    a ``world`` over TCP, runs the builder over its shard of
    ``MP_BUILDER``'s subjects; ``nccl``, a one-rank world started as the
    command line starts one (``cpu:gloo,cuda:nccl``), sums a CUDA tensor
    (NCCL) and a host float64 one (gloo), runs one epoch of the builder in
    the group and one without.  Writes its results to ``outdir``."""
    import argparse as _argparse
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, HERE)
    import lagomorph_tpu_torch as lt
    from lagomorph_tpu_torch.ops import kernels
    from lagomorph_tpu_torch.ops.kernels import _build
    from lagomorph_tpu_torch.utils import _init_process_group
    from profile_atlas import e2e_builder, subjects

    rank, world = int(rank), int(world)
    device = torch.device("cuda", 0)
    _build.library()
    res, n, batch, epochs = MP_BUILDER
    imgs = list(subjects(res, n, 2.0, device))
    out = {}
    if mode == "gloo":
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=MP_TIMEOUT_S))
        b = e2e_builder(lt, imgs, device, epochs, batch)
        kernels.reset_launches()
        t0 = time.perf_counter()
        b.run()
        torch.cuda.synchronize(device)
        out["wall"] = np.float64(time.perf_counter() - t0)
        out["launches"] = np.asarray(json.dumps(
            {k: c for k, c in kernels.launch_counts().items() if c}))
        out.update(atlas=b.I.cpu().numpy(), momenta=np.concatenate(b._momenta_host()),
                   iter_losses=np.asarray(b.iter_losses), epoch_losses=np.asarray(b.epoch_losses),
                   world=np.int64(b._world))
    else:
        _init_process_group(_argparse.Namespace(coordinator_address=f"127.0.0.1:{port}",
                                                num_processes=1, process_id=0), device)
        out["backend"] = np.asarray(str(dist.get_backend()))
        x = torch.arange(4, dtype=torch.float32, device=device)
        dist.all_reduce(x)
        h = torch.arange(3, dtype=torch.float64)
        dist.all_reduce(h)
        out["collectives"] = np.asarray(bool(torch.equal(x.cpu(), torch.arange(4.0)))
                                        and bool(torch.equal(h, torch.arange(3.0, dtype=h.dtype))))
        states = []
        for grouped in (True, False):
            if not grouped:
                dist.destroy_process_group()
            b = e2e_builder(lt, imgs, device, 1, 4)
            b.run()
            states.append(builder_state(b))
        out["equal"] = np.asarray(bool(
            torch.equal(states[0][0], states[1][0]) and states[0][2] == states[1][2]
            and all(torch.equal(a, c) for a, c in zip(states[0][1], states[1][1]))))
    np.savez(os.path.join(outdir, f"{mode}{rank}.npz"), **out)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def spawn_workers(mode, world, outdir):
    """Run ``world`` processes of :func:`mp_worker` (``mode``), each with a
    timeout; every process is ended before this returns."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=HERE)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mp-worker", mode,
                               str(r), str(world), str(port), outdir], cwd=HERE, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{mode} worker {r} failed:\n{o[-3000:]}")
    return [dict(np.load(os.path.join(outdir, f"{mode}{r}.npz"))) for r in range(world)]


def process_checks(lt, device, card):
    """Phase 6j (c): two processes on the card over gloo (the builder at
    ``MP_BUILDER``): both ranks hold the same atlas and losses, equal to one
    process over the same global minibatches (the subjects reordered as
    tests/test_multiprocess.py reorders them); then a one-rank world on
    ``cpu:gloo,cuda:nccl``."""
    import tempfile

    from profile_atlas import e2e_builder, subjects

    res, n, batch, epochs = MP_BUILDER
    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        r0, r1 = spawn_workers("gloo", 2, tmp)
        wall = time.perf_counter() - t0
        imgs = subjects(res, n, 2.0, device)
        shard0, shard1 = list(range(0, n, 2)), list(range(1, n, 2))
        order = []
        for k in range(len(shard0) // batch):
            order += shard0[k * batch:(k + 1) * batch] + shard1[k * batch:(k + 1) * batch]
        b = e2e_builder(lt, [imgs[i] for i in order], device, epochs, 2 * batch)
        builder_run(b)
        ref = builder_state(b)
        ms_ref = torch.cat(ref[1])
        mp = torch.zeros_like(ms_ref)
        for r, rr in enumerate((r0, r1)):
            for subj, m in zip(range(r, n, 2), rr["momenta"]):
                mp[order.index(subj)] = torch.from_numpy(m).double()
        t = torch.from_numpy
        ranks = (max_err(t(r0["atlas"]), t(r1["atlas"])),
                 float(np.abs(r0["iter_losses"] - r1["iter_losses"]).max()))
        diffs = {"losses rel": max(abs(a - b) / abs(b) for a, b in zip(r0["iter_losses"], ref[2])),
                 "atlas": rel_max(t(r0["atlas"]), ref[0]),
                 "momenta rel l2": rel_l2(mp, ms_ref), "momenta of max": rel_max(mp, ms_ref)}
        log(f"processes: 2 gloo processes on the card, {n} subjects at {res}^3, {batch} a "
            f"minibatch each, {epochs} epochs, world {int(r0['world'])}: rank 0 against rank 1 "
            f"atlas {ranks[0]:.3e}, losses {ranks[1]:.3e}; against one process over the global "
            f"minibatches: " + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
            + f" (tol {MP_TOL:g}, momenta rel l2 {MESH_M_TOL:g}); launches per rank {str(r0['launches'])}; walls "
            f"{float(r0['wall']):.2f}, {float(r1['wall']):.2f} s (spawn to exit {wall:.2f} s) "
            f"[{card}]")
        check(int(r0["world"]) == 2, "processes: the builder did not see two processes")
        check(ranks == (0.0, 0.0), f"processes: the ranks differ: {ranks}")
        check(diffs["losses rel"] <= MP_TOL and diffs["atlas"] <= MP_TOL
              and diffs["momenta rel l2"] <= MESH_M_TOL, f"processes: {diffs}")
        record["gloo"] = {**diffs, "rank walls s": [float(r0["wall"]), float(r1["wall"])],
                          "spawn to exit s": wall}

        (w,) = spawn_workers("nccl", 1, tmp)
        log(f"processes: one-rank world, backend {str(w['backend'])}: an all_reduce of a CUDA "
            f"tensor and of a host float64 tensor right: {bool(w['collectives'])}; one builder "
            f"epoch in the group torch.equal to one without: {bool(w['equal'])}; no NCCL traffic "
            f"between two cards ran (one card)")
        check(bool(w["collectives"]) and bool(w["equal"]), "one-rank NCCL world failed")
        record["nccl one rank"] = {"backend": str(w["backend"]), "equal": bool(w["equal"])}
    return record


def parallel_phase(lt, device, card):
    """Phase 6j, ``parallel/``: (a) the spatially sharded step, (b) data
    parallelism on a mesh, (c) processes.  Prints one JSON line of its
    numbers."""
    torch.cuda.empty_cache()  # phase 6i's cached blocks
    t0 = time.perf_counter()
    record = {"card": card}
    record["spatial"] = spatial_checks(lt, device, card)
    record["mesh"] = mesh_checks(lt, device, card)
    record["processes"] = process_checks(lt, device, card)
    record["wall s"] = time.perf_counter() - t0
    log(f"phase 6j: {record['wall s']:.1f} s")
    log(json.dumps({"phase": "6j parallel", **record}))


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
    warp2d_errs, warp2d_times = warp2d_checks(device, FULL2D_512, seed=25, timed=True)
    errs.update(warp2d_errs)
    for name, err in warp2d_checks(device, ODD2D, seed=26)[0].items():
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
    main.update({k: main2d[k] for k in KERNELS_2D + KERNELS_WARP2D})
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
    times.update(warp2d_times)

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

    # 6f. the atlas builder over epochs, its options and its command, then
    # 6g. the affine stack and the registration workflow's last stages:
    # after phases 7 and 8, so that they run as they did before (6f's
    # float64 and 256^3 runs fill the allocator's cache)
    atlas_builder(lt, device, card)
    affine_phase(lt, device, card)
    # 6h. the rest of the core API, the global warp mode and the models
    models_phase(lt, device, card)
    # 6i. the data path: the datasets, the builder's loaders, the debug
    # mode and profiling
    data_phase(lt, device, card)
    # 6j. parallel/: the spatially sharded step, a mesh, processes
    parallel_phase(lt, device, card)

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
    ap.add_argument("--mp-worker", nargs=5, metavar=("MODE", "RANK", "WORLD", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mp_worker and torch.cuda.is_available():
        return mp_worker(*args.mp_worker)
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
