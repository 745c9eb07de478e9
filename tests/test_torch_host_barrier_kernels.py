"""The kernels with shared memory and barriers, compiled for the host and
run on the CPU against their plain versions.

K3 (``csrc/fft_unit.cu``), K14 and K15 (``fft_radix.cu``), K16
(``fft_whole.cu``), K8/K9 (``shoot2d.cu``) and the 3D stencils K1, K2 and
K4-K7 (``warp_unit.cu``, ``epdiff_unit.cu``: the warp's backward pass,
which K5, K6 and K7 launch, marches along x staging each x-plane of a tile
and its halo in a ring in shared memory, its copies synchronous here and
its waits the block's barrier; K1, K2 and K6's first pass march along x
through planes staged with their halo) share memory within a block and wait at barriers, and
K8, K9 and K16 are cooperative launches whose phases meet at grid-wide
barriers.  ``tests/cuda_host/threaded/cuda_runtime.h`` runs each CUDA
thread as an OS thread (a block's barrier, a warp's vote, a block's
shared-memory buffer; every block of a cooperative launch at once, with a
barrier of the grid), and this test rewrites each launch (template
kernels included), each dynamic shared-memory declaration and each
cooperative launch for it, so g++ builds the sources into a host library
with the kernels' C entry points.  The wrappers then call it in place of
the card's library.  So the kernels' indexing, tiles, rings and halos,
clamp folds, batch-1 sums, flags, stage loops, bit-reversed bookkeeping,
phase order, K3's three paths (whole planes in registers, register line
passes, tile passes through the scratch; its in-place passes and the
exchanges of ``csrc/fft_reg.cuh``) and K14's register paths (a whole (Y,
Z) plane per block, or two line passes; both K3's passes with the
spectrum in bit-reversed order, so the pipeline K14, K15, K14 is bit-equal
to K3 there) are checked here; the card itself is checked by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances, float32 against the plain versions on the same inputs: the
transforms 1e-5 * max|ref| (they round in another order than the plain
versions; the solves amplify low frequencies by 1/gamma^2 = 1e4); the
stencil forwards bit-equal (they round each operation like the plain
versions), their backwards 1e-5 * (1 + max|ref|) (another summation order
than autograd).
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch.ops import fluid, kernels
from lagomorph_tpu_torch.ops.kernels import (_build, epdiff_unit, fft_radix, fft_unit, fft_whole,
                                             shoot2d, warp_unit)

torch.set_num_threads(2)

SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_host", "threaded")
HEADERS = ("fft_lines.cuh", "fft_reg.cuh", "fft_plane.cuh", "cooperative.cuh", "stencil.cuh",
           "stencil2d.cuh", "tile2d.cuh")
SOURCES = ("fft_unit.cu", "fft_radix.cu", "fft_whole.cu", "shoot2d.cu", "warp_unit.cu",
           "epdiff_unit.cu")
# the 3D stencils: per-thread (K4) or marching through staged planes (K1,
# K2, K5-K7's pass, K6's first pass)
STENCIL_KERNELS = ("warp_unit_fwd", "warp_unit_bwd", "ad_star_fwd", "compose_fwd",
                   "ad_star_bwd", "compose_bwd")
ENTRY_POINTS = ("lagomorph_fluid_flat", "lagomorph_fluid_radix_zy", "lagomorph_fluid_radix_x",
                "lagomorph_fluid_whole", "lagomorph_fluid_whole_grid", "lagomorph_shoot2d_fwd",
                "lagomorph_shoot2d_fwd_grid", "lagomorph_shoot2d_bwd", "lagomorph_shoot2d_bwd_grid",
                "lagomorph_ad_star_bwd_first", "lagomorph_warp_transpose", "lagomorph_warp_dd",
                *(f"lagomorph_{k}" for k in STENCIL_KERNELS))
RTOL = 1e-5
BWD_RTOL = 1e-5  # of 1 + max|ref|: the stencils' backwards
PARAMS = (0.1, 0.0, 0.01)
LAUNCH_SYNTAX = re.compile(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", re.S)


def _top_level_args(text):
    """Split a launch configuration at its top-level commas."""
    args, depth, cur = [], 0, ""
    for ch in text:
        depth += ch == "("
        depth -= ch == ")"
        if ch == "," and depth == 0:
            args.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return args + [cur.strip()]


def _host_source(text):
    """The CUDA source rewritten for the threaded emulation."""
    def launch(m):
        grid, block, smem = (_top_level_args(m.group(2)) + ["0"])[:3]
        return f"emu_launch({grid}, {block}, {smem}, [&] {{ {m.group(1)}({m.group(3)}); }});"
    text = LAUNCH_SYNTAX.sub(launch, text)
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(float2?) (\w+)\[\];",
                  r"\1* \2 = (\1*)emu_smem_ptr;", text)
    text = re.sub(r"launch_cooperative\(\(const void\*\)(\w+),", r"emu_launch_cooperative(\1,",
                  text)
    return text.replace("#include <cooperative_groups.h>", '#include "cooperative_groups.h"')


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """The barrier kernels built as a threaded host library (skips without
    a g++ that has C++20's <barrier>)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' sources for the host")
    out = tmp_path_factory.mktemp("host_barrier_kernels")
    for name in HEADERS + SOURCES:
        with open(os.path.join(_build.CSRC, name)) as f:
            (out / name).write_text(_host_source(f.read()))
    so = out / "libhost_barrier_kernels.so"  # warp_unit.cu defines lagomorph_error_string
    cmd = [gxx, "-x", "c++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
           "-I", SHIM, "-I", str(out), "-o", str(so), *(str(out / s) for s in SOURCES)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0 and "barrier" in r.stderr and "No such file" in r.stderr:
        pytest.skip("needs a g++ with C++20's <barrier>")
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    for name in ENTRY_POINTS:
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.lagomorph_error_string.argtypes = [ctypes.c_int]
    lib.lagomorph_error_string.restype = ctypes.c_char_p
    return lib


@pytest.fixture
def host_kernels(monkeypatch, host_library):
    """The wrappers of K1-K9 and K14-K16 launch the host library on CPU
    tensors, as on the card: float32 and contiguous, or they raise."""
    def check_cpu_f32(name, *tensors):
        for t in tensors:
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: kernel takes contiguous tensors")

    monkeypatch.setattr(_build, "library", lambda: host_library)
    for mod in (fft_unit, fft_radix, fft_whole, shoot2d, warp_unit, epdiff_unit):
        monkeypatch.setattr(mod, "use_kernel", lambda _t: not kernels._PLAIN.get())
        monkeypatch.setattr(mod, "check_cuda_f32", check_cpu_f32)
        monkeypatch.setattr(mod, "stream_of", lambda _t: None)


def f32(a):
    return torch.as_tensor(a, dtype=torch.float32)


def close(name, got, ref, rtol=RTOL):
    err = float((got.double() - ref.double()).abs().max())
    bound = rtol * float(ref.double().abs().max())
    assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"


def close_stencil(name, got, ref, rtol):
    """The stencils' bound: ``rtol * (1 + max|ref|)`` (0: bit-equal)."""
    err = float((got.double() - ref.double()).abs().max())
    bound = rtol * (1.0 + float(ref.double().abs().max()))
    assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"


def _multiplier(route, spatial):
    return fluid.form_multiplier(fluid.multiplier_form(route), spatial, PARAMS, True,
                                 torch.float32, "cpu")


@pytest.mark.parametrize("spatial", [(4, 8, 16), (2, 256, 128), (32, 64, 64), (4, 2, 512),
                                     (512, 2, 4)])
def test_host_radix_kernels_match_plain(rng, host_kernels, spatial):
    """K14 forward and inverse, K15 on K14's spectrum and the pipeline
    K14, K15, K14 (directly and under autograd: 3 launches each way)
    against their plain versions, at (Y, Z) planes that take K14's two
    register line passes (8 x 16; 256 x 128, beyond a block's shared
    memory) and its plane path (64 x 64, a plane per block of 512
    threads), and at axes of 512 (K14's z pass and K15 in a tile of
    radix-2 stages).  On the register paths the pipeline runs K3's passes
    with the spectrum in bit-reversed order, so it is bit-equal to K3
    (``Mn`` in natural order), forward and backward."""
    x = f32(rng.standard_normal((2 if spatial[1] > 8 else 6,) + spatial))
    Mbr = _multiplier("fluid_radix", spatial)
    Mn = _multiplier("fluid_flat", spatial)
    kernels.reset_launches()
    spec = fft_radix.radix_zy(x, False)
    inv = fft_radix.radix_zy(spec, True)
    pipeline = fft_radix.fluid_radix(x, Mbr)
    for got, fn, args in ((spec, fft_radix.radix_zy, (x, False)),
                          (inv, fft_radix.radix_zy, (spec, True)),
                          (fft_radix.radix_x(spec, Mbr), fft_radix.radix_x, (spec, Mbr)),
                          (pipeline, fft_radix.fluid_radix, (x, Mbr))):
        with kernels.plain_versions():
            close(fn.__name__, got, fn(*args))
    counts = kernels.launch_counts()
    assert counts["fluid_radix_zy"] == 4 and counts["fluid_radix_x"] == 2
    on_k3_path = not fft_unit.needs_scratch(*spatial)  # K3's register passes
    if on_k3_path:
        assert torch.equal(pipeline, fft_unit.fluid_flat(x, Mn)), "K14, K15, K14 differ from K3"
    leaves = [x.clone().requires_grad_(True) for _ in range(3)]
    cot = f32(rng.standard_normal(tuple(x.shape)))
    (got,) = torch.autograd.grad(fft_radix.fluid_radix(leaves[0], Mbr), leaves[0], cot)
    assert kernels.launch_counts()["fluid_radix_zy"] == 8
    with kernels.plain_versions():
        (ref,) = torch.autograd.grad(fft_radix.fluid_radix(leaves[1], Mbr), leaves[1], cot)
    close("fluid_radix backward", got, ref)
    if on_k3_path:
        (flat,) = torch.autograd.grad(fft_unit.fluid_flat(leaves[2], Mn), leaves[2], cot)
        assert torch.equal(got, flat), "the pipeline's backward differs from K3's"


# K3's and K16's paths: the line path at power-of-two axes up to 256 that
# are not square planes of 64 or 128 (one thread per line up to 16 points,
# then 4 x 8, 8 x 8, 8 x 16 and 16 x 16 threads x elements; lengths 1 and 2;
# a 256 x 128 plane, beyond a block's shared memory), the plane path at 64^2
# and 128^2 planes (512 and 1024 threads a plane; x = 32 gives K16's x phase
# an exchange through shared memory), and the tile path, through
# the scratch, at an odd shape (direct sums) and at a power-of-two axis
# longer than 256 (radix-2 in a tile)
SOLVE_SHAPES = {"line": [(4, 8, 16), (2, 256, 128), (1, 2, 32), (16, 64, 4), (4, 32, 32)],
                "plane": [(32, 64, 64), (1, 128, 128)],
                "tile": [(5, 6, 7), (2, 3, 512)]}


@pytest.mark.parametrize("spatial", [s for shapes in SOLVE_SHAPES.values() for s in shapes])
def test_host_fluid_solves_match_plain(rng, host_kernels, host_library, spatial):
    """K3 (three or five passes) and K16 (one cooperative launch of 4
    blocks, so its grid-stride loops iterate) against their plain version,
    the ``torch.fft`` packed solve, at shapes that take each of their three
    paths, with the scratch only where the tile path needs it (which fails
    without it); both under autograd (K3 and K16 their own backwards: one
    launch each way).  On the plane and line paths K16 runs K3's passes as
    its phases, so it is bit-equal to K3, forward and backward."""
    x = f32(rng.standard_normal((6,) + spatial))
    Mn = _multiplier("fluid_whole", spatial)
    ref = fft_unit.fluid_flat_plain(x, Mn)
    path = next(p for p, shapes in SOLVE_SHAPES.items() if spatial in shapes)
    cfg = fft_whole.launch_config(*spatial)
    assert (cfg["path"], cfg["blocks"]) == (path, 4)
    assert cfg["threads"] == ({64: 512, 128: 1024}[spatial[1]] if path == "plane" else 256)
    kernels.reset_launches()
    whole, flat = fft_whole.fluid_whole(x, Mn), fft_unit.fluid_flat(x, Mn)
    close("fluid_whole", whole, ref)
    close("fluid_flat", flat, ref)
    assert fft_unit.needs_scratch(*spatial) == (path == "tile")
    if path != "tile":
        assert torch.equal(whole, flat), "K16 differs from K3 on a register path"
    else:
        F = x.shape[0] // 2
        y = torch.empty_like(x)
        err = host_library.lagomorph_fluid_whole(
            x[:F].data_ptr(), x[F:].data_ptr(), Mn.data_ptr(), y[:F].data_ptr(),
            y[F:].data_ptr(), None, F, *spatial, None)
        assert err != 0, "the tile path ran without its scratch"
    cot = f32(rng.standard_normal(tuple(x.shape)))
    grads = []
    for fn in (fft_whole.fluid_whole, fft_unit.fluid_flat):
        leaf = x.clone().requires_grad_(True)
        (got,) = torch.autograd.grad(fn(leaf, Mn), leaf, cot)
        close(f"{fn.__name__} backward", got, fft_unit.fluid_flat_plain(cot, Mn))
        grads.append(got)
    if path != "tile":
        assert torch.equal(*grads), "K16's backward differs from K3's on a register path"
    assert kernels.launch_counts()["fluid_whole"] == 3
    assert kernels.launch_counts()["fluid_flat"] == 3


# The paths of K8 and K9 (one chooser picks both): (2, 2, 8, 16) and (3, 2,
# 12, 10) their tile path (an axis not a power of two from 32 to 256), (2,
# 2, 32, 64) their register path with G > 1 threads a line on both axes;
# each beside forced tile heights (the entry points' `tile`) whose tiles
# straddle subjects, so that a tile holds rows of two subjects and a halo
# row of K9's phase 3 lies in the next or the previous one: 5 rows on the
# register path; on the tile path 16 lines (K8: 16 rows; K9: 14 rows and
# the halo) and 4 (K8: 4 rows; K9: 2)
SHOOT2D_SHAPES = {(2, 2, 8, 16): ("tile", (0,)), (2, 2, 32, 64): ("register", (0, 5)),
                  (3, 2, 12, 10): ("tile", (0, 16, 4))}


def _k8_matches_plain(phi0, m0, Mn, tiles, ok):
    """K8 at each tile height, with the stash and without it, against
    shoot2d_fwd_plain: within 1e-5 * max|ref|, traj_phiinv[0] and traj_mw[0]
    (computed before any transform) bit-equal, the flag ``ok`` both ways, the
    ping-pong planes' phiinv_T bit-equal to the stash's, a second launch
    bit-identical.  Returns the plain trajectory."""
    ref = shoot2d.shoot2d_fwd_plain(phi0, m0, Mn, -0.2, 4)
    assert bool(ref[1]) == ok
    for tile in tiles:
        got = shoot2d._launch_fwd(phi0, m0, Mn, -0.2, 4, True, tile)
        assert bool(got[1]) == ok, f"K8 (tile {tile}): flag {bool(got[1])}"
        if ok:
            for what, g, r in zip(("phiinv_T", "traj_phiinv", "traj_v", "traj_mw"),
                                  got[:1] + got[2:], ref[:1] + ref[2:]):
                close(f"K8 {what} (tile {tile})", g, r)
        assert torch.equal(got[2][0], ref[2][0]), f"K8 traj_phiinv[0] (tile {tile})"
        assert torch.equal(got[4][0], ref[4][0]), f"K8 traj_mw[0] (tile {tile})"
        bare = shoot2d._launch_fwd(phi0, m0, Mn, -0.2, 4, False, tile)
        assert bool(bare[1]) == ok and torch.equal(bare[0], got[0]), \
            f"K8 without the stash (tile {tile})"
        again = shoot2d._launch_fwd(phi0, m0, Mn, -0.2, 4, True, tile)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            f"K8 is not deterministic (tile {tile})"
    return ref


@pytest.mark.parametrize("shape", list(SHOOT2D_SHAPES))
def test_host_shoot2d_kernels_match_plain(rng, host_kernels, shape):
    """K8 (phiinv_T, the flag, the stashed trajectory) and K9 (both
    gradients) against their plain versions, at their own tile heights and
    the forced ones, 4 substeps at s = -0.2 from momenta at max|v0| = 0.5,
    batch-N and batch-1 momenta (whose d_m0 K9 sums over the subjects in a
    phase of its own), within 1e-5 * max|ref|: K8 with and without the stash
    (``_k8_matches_plain``), a rerun of each bit-identical.  Then a
    displacement of 1.5 in phiinv0 trips both flags, K8's at every tile
    height with and without the stash, and K9 on that trajectory still
    gives finite gradients equal to the plain version's."""
    N, _, H, W = shape
    path, tiles = SHOOT2D_SHAPES[shape]
    assert shoot2d.bwd_launch_config(N, H, W)["path"] == path
    assert shoot2d.fwd_launch_config(N, H, W)["path"] == path
    for tile in tiles[1:]:
        assert shoot2d.fwd_launch_config(N, H, W, tile)["tile"] == tile
    Mn = lt.FluidMetric(PARAMS).packed_multiplier((H, W), torch.float32, "cpu")
    for nb in (N, 1):
        m0 = f32(rng.standard_normal((nb, 2, H, W)))
        m0 = m0 * (0.5 / float(shoot2d.fluid2d_plain(m0, Mn).abs().max()))
        phi0 = (-0.2 * shoot2d.fluid2d_plain(m0, Mn)).expand(N, -1, -1, -1).contiguous()
        ref = _k8_matches_plain(phi0, m0, Mn, tiles, True)
        g = f32(rng.standard_normal((N, 2, H, W)))
        want = shoot2d.shoot2d_bwd_plain(m0, g, *ref[2:], Mn, -0.2)
        for tile in tiles:
            d = shoot2d._launch_bwd(m0, g, *ref[2:], Mn, -0.2, tile)
            for what, a, b in zip(("d_phiinv0", "d_m0"), d, want):
                close(f"K9 {what} (tile {tile}, m0 batch {nb})", a, b)
        again = shoot2d._launch_bwd(m0, g, *ref[2:], Mn, -0.2, tiles[-1])
        assert all(torch.equal(a, b) for a, b in zip(d, again)), "K9 is not deterministic"
    bad = phi0.clone()
    bad.view(-1)[bad.numel() // 3] = 1.5
    ref = _k8_matches_plain(bad, m0, Mn, tiles, False)
    d = shoot2d._launch_bwd(m0, g, *ref[2:], Mn, -0.2)
    for what, a, b in zip(("d_phiinv0", "d_m0"), d, shoot2d.shoot2d_bwd_plain(m0, g, *ref[2:], Mn,
                                                                                -0.2)):
        assert bool(torch.isfinite(a).all()), f"K9 {what} on a tripped trajectory"
        close(f"K9 {what} on a tripped trajectory", a, b)


@pytest.mark.parametrize("shape", [(2, 3, 6, 5, 7), (3, 3, 2, 9, 4)])
def test_host_kernels_match_plain(rng, host_kernels, shape):
    """Every stencil kernel, forward and backward, against its plain
    version: K4/K5 with a batch-1 one-channel and a batch-N three-channel
    image, K1/K6 with batch-1 and batch-N momenta (with the warped-momentum
    residual and the flag), K2/K7 at s = -0.2; displacements inside the
    unit regime and pushed to its edges (taps clamped, folds taken)."""
    N, _, X, Y, Z = shape
    kernels.reset_launches()
    for p in (f32(rng.uniform(-0.99, 0.99, shape)),
              f32(np.where(rng.uniform(size=shape) < 0.5, -0.999, 0.999))):
        for nb, C in ((1, 1), (N, 3)):
            I = f32(rng.standard_normal((nb, C, X, Y, Z)))
            g = f32(rng.standard_normal((N, C, X, Y, Z)))
            close_stencil("K4", warp_unit.sample_displacement_unit(I, p),
                  warp_unit.sample_displacement_unit_plain(I, p), 0.0)
            for name, got, ref in zip(("K5 dI", "K5 d_disp"), warp_unit._launch_bwd(I, p, g),
                                      warp_unit.sample_displacement_unit_bwd_plain(I, p, g)):
                close_stencil(name, got, ref, BWD_RTOL)
        for nb in (1, N):
            m0 = f32(rng.standard_normal((nb, 3, X, Y, Z)))
            out, flag, mw = epdiff_unit._launch_ad_star(p, m0, want_mw=True)
            r_out, r_flag, r_mw = epdiff_unit.ad_star_plain(p, m0, want_mw=True)
            close_stencil("K1", out, r_out, 0.0)
            close_stencil("K1 mw", mw, r_mw, 0.0)
            assert bool(flag) is bool(r_flag) is True
            g = f32(rng.standard_normal(shape))
            for name, got, ref in zip(("K6 d_phiinv", "K6 d_m0"),
                                      epdiff_unit._launch_ad_star_bwd(p, m0, g, mw),
                                      epdiff_unit.ad_star_bwd_plain(p, m0, g, r_mw)):
                close_stencil(name, got, ref, BWD_RTOL)
        v = f32(rng.uniform(-4.9, 4.9, shape))
        out, flag = epdiff_unit.compose(p, v, -0.2)
        r_out, r_flag = epdiff_unit.compose_plain(p, v, -0.2)
        close_stencil("K2", out, r_out, 0.0)
        assert bool(flag) is bool(r_flag) is True
        g = f32(rng.standard_normal(shape))
        for name, got, ref in zip(("K7 d_phiinv", "K7 d_v"),
                                  epdiff_unit._launch_compose_bwd(p, v, -0.2, g),
                                  epdiff_unit.compose_bwd_plain(p, v, -0.2, g)):
            close_stencil(name, got, ref, BWD_RTOL)
    bad = f32(rng.uniform(-0.9, 0.9, shape))
    bad.view(-1)[bad.numel() // 2 + 5] = 1.0  # the unit regime's upper bound is open
    assert not bool(epdiff_unit.ad_star(bad, bad)[1])
    assert not bool(epdiff_unit.compose(bad, bad, 1.0)[1])
    assert all(kernels.launch_counts()[k] > 0 for k in STENCIL_KERNELS)


def test_host_atlas_step_matches_plain(rng, host_kernels, monkeypatch):
    """One atlas step through the host-built kernels (K3 plain on both
    sides) against the plain versions, at momenta like the bench's
    (x 2e-6), with the launches of one step on the hoisted path."""
    monkeypatch.setattr(fft_unit, "use_kernel", lambda _t: False)
    shape = (2, 3, 8, 6, 10)
    metric = lt.FluidMetric((0.1, 0.0, 0.01))
    m = f32(rng.standard_normal(shape) * 2e-6)
    I = f32(rng.standard_normal((1, 1) + shape[2:]))
    img = f32(rng.standard_normal((2, 1) + shape[2:]))
    step = lt.make_lddmm_atlas_step(metric, reg_weight=0.1, learning_rate_pose=1e-6)
    kernels.reset_launches()
    got = step(I, m, img)
    assert kernels.launch_counts() == {
        "fluid_flat": 0, "warp_unit_fwd": 1, "warp_unit_bwd": 1, "ad_star_fwd": 4,
        "compose_fwd": 4, "ad_star_bwd": 4, "compose_bwd": 4, "shoot2d_fwd": 0,
        "shoot2d_bwd": 0, "ad_star2d_fwd": 0, "compose2d_fwd": 0, "ad_star2d_bwd": 0,
        "compose2d_bwd": 0, "fluid_radix_zy": 0, "fluid_radix_x": 0, "fluid_whole": 0,
        "warp2d_fwd": 0, "warp2d_bwd": 0}
    assert not fft_unit.use_kernel(m)  # K3 took its plain version
    with kernels.plain_versions():
        ref = step(I, m, img)
    update, r_update = got[0] - m, ref[0] - m
    assert float((update - r_update).abs().max()) <= 1e-5 * float(r_update.abs().max())
    assert float((got[1] - ref[1]).abs().max()) <= 1e-5 * float(ref[1].abs().max())
    assert abs(float(got[2]) - float(ref[2])) <= 1e-6 * abs(float(ref[2]))


def test_host_pass_launches_in_atlas_steps(rng, host_kernels, monkeypatch):
    """Through the host-built kernels (K3 plain), one 3D atlas step launches
    the warp backward's pass 5 times with the weight gradient (K5 once, a
    one-channel image being one chunk, and K7 4 times) and 4 times without
    (K6), as ``kernels.launch_counts()`` counts them; one 2D step (K8/K9)
    never."""
    monkeypatch.setattr(fft_unit, "use_kernel", lambda _t: False)
    metric = lt.FluidMetric((0.1, 0.0, 0.01))
    for shape, want in (((2, 3, 4, 6, 8), (5, 4)), ((2, 2, 8, 16), (0, 0))):
        m = f32(rng.standard_normal(shape) * 2e-6)
        I = f32(rng.standard_normal((1, 1) + shape[2:]))
        img = f32(rng.standard_normal((2, 1) + shape[2:]))
        step = lt.make_lddmm_atlas_step(metric, reg_weight=0.1, learning_rate_pose=1e-6)
        kernels.reset_launches()
        step(I, m, img)
        counts = kernels.launch_counts()
        assert (counts["warp_unit_bwd"] + counts["compose_bwd"], counts["ad_star_bwd"]) == want, \
            shape


# shapes against the backward pass's column, a 16 x 32 (y, z) tile of
# outputs marching along x: smaller than one tile on every axis, straddling
# tiles on y and z, with axes of length 1 and 2, and 17 voxels along x (the
# ring of 2 staged steps turns 8 times, and a remainder)
EDGE_SHAPES = [(2, 3, 3, 5, 7), (3, 3, 5, 9, 37), (2, 3, 1, 2, 6), (2, 3, 6, 2, 1),
               (2, 3, 17, 3, 5)]


def _edge_disp(rng, shape, scale=1.0):
    """Displacements in (-0.99, 0.99), with about one voxel in eight set
    outside [-1, 1) (floor(d) not in {-1, 0}: zero weights) or to -1 or 0
    exactly, times ``scale``."""
    d = rng.uniform(-0.99, 0.99, shape)
    pick = rng.uniform(size=shape) < 0.125
    d[pick] = rng.choice([-2.5, -1.5, 1.0, 1.5, 3.7, -1.0, 0.0], size=int(pick.sum()))
    return f32(d * scale)


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_host_warp_passes_edge_cases(rng, host_kernels, shape):
    """The warp forward K4 and the backward pass that K5, K6 and K7
    launch, at shapes smaller than one tile, straddling tiles and with axes
    of length 1 or 2, on displacements with voxels
    outside the unit regime and at its edges: K4 (and K1, K2) bit-equal to
    the plain versions; K5 with one-, three-, four- and five-channel images
    (four and five: two launches of the pass, each counted) of batch 1 and
    N, K6 with batch-1 and batch-N
    momenta (where no axis has length 1), and K7's compose epilogue at s = -0.2 and s = 0.7, within
    1e-5 * (1 + max|ref|); a second launch of each backward bit-identical
    to the first."""
    N, _, X, Y, Z = shape
    p = _edge_disp(rng, shape)

    def hold(name, fn, plain, *args, rtol=BWD_RTOL):
        got = fn(*args)
        for what, a, r in zip(("d_0", "d_1"), got, plain(*args)):
            close_stencil(f"{name} {what}", a, r, rtol)
        assert all(torch.equal(a, b) for a, b in zip(got, fn(*args))), f"{name}: rerun differs"

    for nb, C in ((1, 1), (N, 1), (1, 3), (N, 3), (N, 4), (1, 5)):
        I = f32(rng.standard_normal((nb, C, X, Y, Z)))
        close_stencil(f"K4 I({nb},{C})", warp_unit.sample_displacement_unit(I, p),
                      warp_unit.sample_displacement_unit_plain(I, p), 0.0)
        before = kernels.launch_counts()["warp_unit_bwd"]
        hold(f"K5 I({nb},{C})", warp_unit._launch_bwd, warp_unit.sample_displacement_unit_bwd_plain,
             I, p, f32(rng.standard_normal((N, C, X, Y, Z))))
        # two launches of K5 in hold, each one launch a chunk of 3 channels
        assert kernels.launch_counts()["warp_unit_bwd"] - before == 2 * -(-C // 3), C
    # Ad*'s Jacobian refuses an axis of length 1 (as the JAX package does)
    for nb in (1, N) if min(X, Y, Z) > 1 else ():
        m0 = f32(rng.standard_normal((nb, 3, X, Y, Z)))
        out, _, mw = epdiff_unit._launch_ad_star(p, m0, want_mw=True)
        r_out, _, r_mw = epdiff_unit.ad_star_plain(p, m0, want_mw=True)
        close_stencil(f"K1 m0({nb},3)", out, r_out, 0.0)
        close_stencil(f"K1 mw({nb},3)", mw, r_mw, 0.0)
        hold(f"K6 m0({nb},3)", epdiff_unit._launch_ad_star_bwd, epdiff_unit.ad_star_bwd_plain,
             p, m0, f32(rng.standard_normal(shape)), mw)
    for s in (-0.2, 0.7):
        v = _edge_disp(rng, shape, 1.0 / s)
        close_stencil(f"K2 s={s}", epdiff_unit.compose(p, v, s)[0],
                      epdiff_unit.compose_plain(p, v, s)[0], 0.0)
        g = f32(rng.standard_normal(shape))
        hold(f"K7 s={s}", lambda a, b, c: epdiff_unit._launch_compose_bwd(a, b, s, c),
             lambda a, b, c: epdiff_unit.compose_bwd_plain(a, b, s, c), p, v, g)


# The backward pass's walk on the emulated card (2 SMs of 2 blocks: 4
# blocks): Z a multiple of 4 (the TMA path's form) with 6 columns of the
# whole x for NI = N and 12 segments of 8 planes (the last 3) for NI = 1,
# and odd Z (the cp.async path's) with 12 columns, each over 21 planes: X
# longer than two rings of 3 steps plus a remainder, more columns than
# blocks
PASS_SHAPES = [(3, 3, 43, 18, 12), (3, 3, 21, 18, 37)]


def _pass_plain(I, p, s, g, compose):
    """The pass's outputs from the plain warp backward at s * p: the
    transpose, and the weight gradient (s * g + s * it for ``compose``)."""
    dI, dd = warp_unit.sample_displacement_unit_bwd_plain(I, s * p, g)
    return dI, s * g + s * dd if compose else dd


@pytest.mark.parametrize("shape", PASS_SHAPES)
def test_host_warp_pass_modes(rng, host_library, shape):
    """The warp backward's pass through its two C entry points (the
    transpose alone, ``lagomorph_warp_transpose``; with the weight gradient,
    ``lagomorph_warp_dd``) at s = 1 and -0.2, with one-, three- and
    five-channel cotangents (five: two chunks, the second adding its
    channels' weight gradient to the first's) of batch 1 and N, and K7's
    compose epilogue, within 1e-5 * (1 + max|ref|) of the plain versions; a
    second launch bit-identical to the first."""
    N, _, X, Y, Z = shape
    p = _edge_disp(rng, shape)

    def launch(name, *args):
        err = getattr(host_library, name)(*args)
        assert err == 0, f"{name}: error {err}"

    for s, nb, C, compose in ((1.0, 1, 1, False), (1.0, N, 3, False), (-0.2, 1, 5, False),
                              (-0.2, N, 3, True)):
        disp = f32(np.asarray(p) / s)
        I = f32(rng.standard_normal((nb, C, X, Y, Z)))
        g = f32(rng.standard_normal((N, C, X, Y, Z)))
        r_t, r_dd = _pass_plain(I, disp, s, g, compose)
        dims = (N, nb, C, X, Y, Z)
        runs = []
        for _ in range(2):
            out_t, out_dd, only_t = torch.empty_like(I), torch.empty_like(disp), torch.empty_like(I)
            launch("lagomorph_warp_dd", I.data_ptr(), disp.data_ptr(), s, g.data_ptr(),
                   out_t.data_ptr(), out_dd.data_ptr(), *dims, int(compose), None)
            launch("lagomorph_warp_transpose", disp.data_ptr(), s, g.data_ptr(), only_t.data_ptr(),
                   *dims, None)
            runs.append((out_t, out_dd, only_t))
        label = f"pass s={s} I({nb},{C}) compose={compose}"
        for what, got, ref in zip(("transpose", "weight gradient", "transpose alone"), runs[0],
                                  (r_t, r_dd, r_t)):
            close_stencil(f"{label} {what}", got, ref, BWD_RTOL)
        assert all(torch.equal(a, b) for a, b in zip(*runs)), f"{label}: rerun differs"


# K6's first pass at (shape, march length; 0: the one K6 takes): its blocks
# march along x over 8 x 32 (y, z) tiles; x one march plus a remainder (two
# blocks along x) or less than one, y and z straddling the tile
FIRST_PASS_CASES = [((2, 3, 19, 11, 35), 16), ((2, 3, 19, 11, 35), 0), ((2, 3, 5, 9, 33), 0)]


def _ad_star_bwd_first(phiinv, m0, g, mw, march=0):
    """K6's first pass alone, through its C entry point: (d_mw, d_phiinv)."""
    N, _, X, Y, Z = phiinv.shape
    d_mw, d_p = torch.empty_like(phiinv), torch.empty_like(phiinv)
    _build.call("lagomorph_ad_star_bwd_first", phiinv.data_ptr(), m0.data_ptr(), g.data_ptr(),
                mw.data_ptr(), d_mw.data_ptr(), d_p.data_ptr(), N, m0.shape[0], X, Y, Z, march,
                None)
    return d_mw, d_p


@pytest.mark.parametrize("shape, march", FIRST_PASS_CASES)
@pytest.mark.parametrize("m_batch", [1, "N"])
def test_host_adstar_first_pass(rng, host_kernels, shape, march, m_batch):
    """K6's first pass alone (``lagomorph_ad_star_bwd_first``) with batch-1
    and batch-N momenta, on displacements with voxels outside the unit
    regime and at its edges, at shapes that cross its march and its tile:
    d_mw bit-equal to the plain Jacobian transpose (it rounds in the same
    order), d_phiinv within 1e-5 * (1 + max|ref|), and a second launch
    bit-identical to the first."""
    N, _, X, Y, Z = shape
    p = _edge_disp(rng, shape)
    m0 = f32(rng.standard_normal((N if m_batch == "N" else 1, 3, X, Y, Z)))
    g = f32(rng.standard_normal(shape))
    mw = epdiff_unit.ad_star_plain(p, m0, want_mw=True)[2]
    d_mw, d_p = _ad_star_bwd_first(p, m0, g, mw, march)
    r_mw, r_p = epdiff_unit.ad_star_bwd_first_plain(p, m0, g, mw)
    close_stencil("K6 first pass d_mw", d_mw, r_mw, 0.0)
    close_stencil("K6 first pass d_phiinv", d_p, r_p, BWD_RTOL)
    again = _ad_star_bwd_first(p, m0, g, mw, march)
    assert all(torch.equal(a, b) for a, b in zip((d_mw, d_p), again))


def _compose_fwd(phiinv, v, s, march=0):
    """K2 through its C entry point, marching over ``march`` planes (0: the
    length K2 takes): (out, flag)."""
    N, _, X, Y, Z = phiinv.shape
    out = torch.empty_like(phiinv)
    flag = torch.ones((), dtype=torch.int32)
    _build.call("lagomorph_compose_fwd", phiinv.data_ptr(), v.data_ptr(), s, out.data_ptr(),
                flag.data_ptr(), N, X, Y, Z, march, None)
    return out, bool(flag)


@pytest.mark.parametrize("shape, march", FIRST_PASS_CASES)
@pytest.mark.parametrize("s", [-0.2, 0.7])
def test_host_compose_march(rng, host_kernels, shape, march, s):
    """K2 (``lagomorph_compose_fwd``: 8 x 32 (y, z) tiles marching along x,
    the 8 live taps from staged planes) at K6's first-pass shapes, which
    cross its march and its tile, on displacements with voxels outside the
    unit regime and at its edges: out bit-equal to the plain version, the
    flags equal, a second launch bit-identical; then on displacements
    inside the regime, the flag true, and false once one voxel on the last
    plane of a march (the corner of a partial tile, the last subject)
    leaves it."""
    N, _, X, Y, Z = shape
    p = _edge_disp(rng, shape)
    v = _edge_disp(rng, shape, 1.0 / s)
    out, flag = _compose_fwd(p, v, s, march)
    ref, r_flag = epdiff_unit.compose_plain(p, v, s)
    close_stencil("K2", out, ref, 0.0)
    assert flag is bool(r_flag)
    again = _compose_fwd(p, v, s, march)
    assert torch.equal(out, again[0]) and again[1] is flag
    v = f32(rng.uniform(-0.99, 0.99, shape) / s)
    out, flag = _compose_fwd(p, v, s, march)
    close_stencil("K2 in the regime", out, epdiff_unit.compose_plain(p, v, s)[0], 0.0)
    assert flag
    # the emulated card has 2 SMs, so K2's own length is 128 planes here
    last = min(march or 128, X) - 1
    v[N - 1, 1, last, Y - 1, Z - 1] = 1.5 / s
    assert not _compose_fwd(p, v, s, march)[1]
    assert not bool(epdiff_unit.compose_plain(p, v, s)[1])


def _ad_star_fwd(phiinv, m0, want_mw, march=0):
    """K1 through its C entry point, marching over ``march`` planes (0: the
    length K1 takes): (out, flag, mw or None)."""
    N, _, X, Y, Z = phiinv.shape
    out = torch.empty_like(phiinv)
    mw = torch.empty_like(phiinv) if want_mw else None
    flag = torch.ones((), dtype=torch.int32)
    _build.call("lagomorph_ad_star_fwd", phiinv.data_ptr(), m0.data_ptr(), out.data_ptr(),
                None if mw is None else mw.data_ptr(), flag.data_ptr(), N, m0.shape[0], X, Y, Z,
                march, None)
    return out, bool(flag), mw


@pytest.mark.parametrize("shape, march", FIRST_PASS_CASES)
@pytest.mark.parametrize("m_batch", [1, "N"])
@pytest.mark.parametrize("want_mw", [True, False])
def test_host_ad_star_march(rng, host_kernels, shape, march, m_batch, want_mw):
    """K1 (``lagomorph_ad_star_fwd``: 8 x 32 (y, z) tiles marching along x,
    m0's 8 live taps and phiinv's face neighbours from staged planes) at K6's
    first-pass shapes, which cross its march and its tile, with batch-1 and
    batch-N momenta, writing ``mw`` and not: on displacements with voxels
    outside the unit regime and at its edges, out and mw bit-equal to the
    plain version, the flags equal, a second launch bit-identical; then on
    displacements inside the regime, the flag true, and false once one
    voxel on the last plane of a march (the corner of a partial tile, the
    last subject) leaves it."""
    N, _, X, Y, Z = shape
    p = _edge_disp(rng, shape)
    m0 = f32(rng.standard_normal((N if m_batch == "N" else 1, 3, X, Y, Z)))
    out, flag, mw = _ad_star_fwd(p, m0, want_mw, march)
    ref, r_flag, r_mw = epdiff_unit.ad_star_plain(p, m0, want_mw=True)
    close_stencil("K1", out, ref, 0.0)
    if want_mw:
        close_stencil("K1 mw", mw, r_mw, 0.0)
    assert flag is bool(r_flag)
    again = _ad_star_fwd(p, m0, want_mw, march)
    assert torch.equal(out, again[0]) and again[1] is flag
    assert not want_mw or torch.equal(mw, again[2])
    p = f32(rng.uniform(-0.99, 0.99, shape))
    out, flag, mw = _ad_star_fwd(p, m0, want_mw, march)
    ref, _, r_mw = epdiff_unit.ad_star_plain(p, m0, want_mw=True)
    close_stencil("K1 in the regime", out, ref, 0.0)
    if want_mw:
        close_stencil("K1 mw in the regime", mw, r_mw, 0.0)
    assert flag
    # the emulated card holds 2 blocks an SM on 2 SMs, so K1's own length is
    # 128 planes here
    last = min(march or 128, X) - 1
    p[N - 1, 2, last, Y - 1, Z - 1] = 1.0  # the unit regime's upper bound is open
    assert not _ad_star_fwd(p, m0, want_mw, march)[1]
    assert not bool(epdiff_unit.ad_star_plain(p, m0)[1])
