"""The 2D stencil kernels' CUDA source, compiled for the host and run on
the CPU against their plain versions.

K10-K13 (``lagomorph_tpu_torch/csrc/epdiff2d.cu``): K10 and K11 on column
strips whose warps march down bands of rows, the halo columns shuffled
between lanes and the flag voted once a block; K12's row tiles, staged in
shared memory between barriers (``csrc/tile2d.cuh``, which K9 shares); and
the per-thread kernels with one ballot.  The source is built with g++
against the threaded emulation of the CUDA runtime
(``tests/cuda_host/threaded/``: each CUDA thread an OS thread, a block's
barrier a ``std::barrier``), each launch and shared-memory declaration
rewritten as ``tests/test_torch_host_barrier_kernels.py`` rewrites its
sources, into a host library with the same C entry points, which the kernel
wrappers then call in place of the card's library.  The 2D unit-regime warp
K17 and its one-pass backward K18 (``csrc/warp2d.cu``, staging a tile and
its halo in shared memory a subject) are built into the same library.  So
the kernels' arithmetic, indexing, tiles and halos, clamp folds, batch-1
sums and flags are checked here, in float32, before the card
sees them; the card itself is checked by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  The other kernels run on the threaded emulation of
``tests/test_torch_host_barrier_kernels.py``; here their wrappers run their
plain versions.

Tolerances, float32 against the plain version on the same inputs: the
forwards (K17 included) round each operation like the plain version
(bit-equal); the
backwards sum in another order than autograd (1e-5 * (1 + max|ref|)); the
tile forms give the per-thread kernels' bits (``torch.equal``).
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import profiling
from lagomorph_tpu_torch.ops import kernels
from lagomorph_tpu_torch.ops.kernels import _build, epdiff2d, warp2d
from test_torch_host_barrier_kernels import SHIM, _host_source

torch.set_num_threads(2)

HEADERS = ("stencil2d.cuh", "tile2d.cuh")
SOURCES = ("epdiff2d.cu", "warp2d.cu")
KERNELS_2D_PER_OP = ("ad_star2d_fwd", "compose2d_fwd", "ad_star2d_bwd", "compose2d_bwd")
WARP2D = ("warp2d_fwd", "warp2d_bwd")  # K17, K18
ENTRY_POINTS = ("lagomorph_ad_star2d_fwd", "lagomorph_compose2d_fwd", "lagomorph_ad_star2d_bwd",
                "lagomorph_compose2d_bwd", "lagomorph_ad_star2d_bwd_grid",
                "lagomorph_epdiff2d_fwd_grid", "lagomorph_warp2d_fwd", "lagomorph_warp2d_bwd")
BWD_RTOL = 1e-5


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """The 2D stencil sources built as a threaded host library (skips
    without a g++ that has C++20's <barrier>)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' sources for the host")
    out = tmp_path_factory.mktemp("host_kernels")
    for name in HEADERS + SOURCES:
        with open(os.path.join(_build.CSRC, name)) as f:
            (out / name).write_text(_host_source(f.read()))
    (out / "error_string.cpp").write_text(
        'extern "C" const char* lagomorph_error_string(int) { return "host emulation"; }\n')
    so = out / "libhost_kernels.so"
    cmd = [gxx, "-x", "c++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
           "-I", SHIM, "-I", str(out), "-o", str(so), *(str(out / src) for src in SOURCES),
           str(out / "error_string.cpp")]
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
    """The 2D stencil wrappers (K10-K13, K17, K18) launch the host library
    on CPU tensors, as on the card: float32 and contiguous, or they
    raise."""
    def check_cpu_f32(name, *tensors):
        for t in tensors:
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name}: kernel takes contiguous float32 tensors")

    monkeypatch.setattr(_build, "library", lambda: host_library)
    for mod in (epdiff2d, warp2d):
        monkeypatch.setattr(mod, "use_kernel", lambda _t: not kernels._PLAIN.get())
        monkeypatch.setattr(mod, "check_cuda_f32", check_cpu_f32)
        monkeypatch.setattr(mod, "stream_of", lambda _t: None)


def f32(a):
    return torch.as_tensor(a, dtype=torch.float32)


def close(name, got, ref, rtol):
    err = float((got.double() - ref.double()).abs().max())
    assert err <= rtol * (1.0 + float(ref.double().abs().max())), f"{name}: {err:.3e}"


@pytest.mark.parametrize("shape", [(2, 2, 9, 12), (3, 2, 2, 7)])
def test_host_stencil2d_matches_plain(rng, host_kernels, shape):
    """K10-K13 (``csrc/epdiff2d.cu``, built on ``stencil2d.cuh``'s per-pixel
    functions, which K8/K9 share) against their plain versions in float32:
    K10 (with the warped momentum ``mw``) with batch-1 and batch-N momenta
    and K11 at s = -0.2 round each operation like the plain versions
    (bit-equal); K12 (d_phiinv, and d_m0 summed over the subjects for
    batch-1 momenta) and K13 (d_phiinv, d_v) within 1e-5 * (1 + max|ref|);
    the flags, in the unit regime, at its edges and out of it."""
    N, _, H, W = shape
    kernels.reset_launches()
    for p in (f32(rng.uniform(-0.99, 0.99, shape)),
              f32(np.where(rng.uniform(size=shape) < 0.5, -0.999, 0.999))):
        for nb in (1, N):
            m0 = f32(rng.standard_normal((nb, 2, H, W)))
            out, flag, mw = epdiff2d._launch_ad_star(p, m0, want_mw=True)
            r_out, r_flag, r_mw = epdiff2d.ad_star2d_plain(p, m0, want_mw=True)
            close("K10", out, r_out, 0.0)
            close("K10 mw", mw, r_mw, 0.0)
            assert bool(flag) is bool(r_flag) is True
            g = f32(rng.standard_normal(shape))
            for name, got, ref in zip(("K12 d_phiinv", "K12 d_m0"),
                                      epdiff2d._launch_ad_star_bwd(p, m0, g, mw),
                                      epdiff2d.ad_star2d_bwd_plain(p, m0, g, r_mw)):
                close(name, got, ref, BWD_RTOL)
        v = f32(rng.uniform(-4.9, 4.9, shape))
        out, flag = epdiff2d.compose2d(p, v, -0.2)
        r_out, r_flag = epdiff2d.compose2d_plain(p, v, -0.2)
        close("K11", out, r_out, 0.0)
        assert bool(flag) is bool(r_flag) is True
        g = f32(rng.standard_normal(shape))
        for name, got, ref in zip(("K13 d_phiinv", "K13 d_v"),
                                  epdiff2d._launch_compose_bwd(p, v, -0.2, g),
                                  epdiff2d.compose2d_bwd_plain(p, v, -0.2, g)):
            close(name, got, ref, BWD_RTOL)
    bad = f32(rng.uniform(-0.9, 0.9, shape))
    bad.view(-1)[bad.numel() // 2 + 1] = 1.0  # the unit regime's upper bound is open
    assert not bool(epdiff2d.ad_star2d(bad, bad)[1])
    assert not bool(epdiff2d.compose2d(bad, bad, 1.0)[1])
    edge = f32(rng.uniform(-0.9, 0.9, shape))
    edge.view(-1)[3] = -1.0  # its lower bound is closed
    assert bool(epdiff2d.ad_star2d(edge, edge)[1]) and bool(epdiff2d.compose2d(edge, edge, 1.0)[1])
    assert all(kernels.launch_counts()[k] > 0 for k in KERNELS_2D_PER_OP)


# Shapes for K10's and K11's strips: a row narrower than a warp's strips,
# W % PX != 0 (7), H = 2, H not a multiple of the band height, a row of one
# strip, a row of several warps' strips at each width the chooser takes (1:
# W = 40, 4 columns in 136, 2 in 66)
STRIP_SHAPES = [(2, 2, 9, 12), (3, 2, 2, 7), (2, 2, 5, 40), (1, 2, 3, 2), (2, 2, 4, 136),
                (2, 2, 3, 66)]
MARCHES = (0, 1, 2)  # the chooser's band height, and bands of 1 and 2 rows


@pytest.mark.parametrize("shape", STRIP_SHAPES)
def test_host_epdiff2d_fwd_strips(rng, host_kernels, shape):
    """K10 (out, with and without ``mw``; batch-1 and batch-N m0) and K11 (s
    = -0.2) on column strips of PX columns marching down bands of RJ rows
    (their route below ``2**31`` elements a field): the library's launch at
    its chooser's geometry and at forced band heights, ``torch.equal`` to
    the plain versions and to the per-thread kernels (``march`` -1), the
    flags equal; across the shapes the chooser takes strips of 1, 2 and 4
    columns for each kernel (here, where no kernel reports a spill; on the
    card K10's 4-column kernel spills and is not taken); and the flag, on the strips at the chooser's
    geometry and on the per-thread kernels, false for one value out of the
    unit regime at several places (the upper bound is open) and true at -1
    (the lower bound is closed)."""
    N, _, H, W = shape
    assert epdiff2d.fwd_route(N, H, W) == "march"
    assert epdiff2d.fwd_route(2**20, 2**5, 2**5) == "thread"  # 2**31 elements: int indices
    assert epdiff2d.fwd_route(2**20 - 1, 2**5, 2**5) == "march"
    cfg = epdiff2d.fwd_launch_config("ad_star2d_fwd", N, H, W, 3)
    assert cfg["rj"] == 3 and cfg["px"] in (1, 2, 4)
    own = epdiff2d.fwd_launch_config("compose2d_fwd", N, H, W)
    assert W % own["px"] == 0 and own["blocks"] >= 1
    for kernel in ("ad_star2d_fwd", "compose2d_fwd"):
        assert {epdiff2d.fwd_launch_config(kernel, n, h, w)["px"]
                for n, _, h, w in STRIP_SHAPES} == {1, 2, 4}, kernel
    p = f32(np.where(rng.uniform(size=shape) < 0.5, rng.uniform(-0.999, -0.001, shape),
                     rng.uniform(0.001, 0.999, shape)))
    v = f32(rng.uniform(-4.9, 4.9, shape))
    for nb, want_mw in ((N, True), (1, False), (1, True)):
        m0 = f32(rng.standard_normal((nb, 2, H, W)))
        ref = epdiff2d.ad_star2d_plain(p, m0, want_mw=True)
        thread = epdiff2d._launch_ad_star(p, m0, want_mw=True, march=epdiff2d.THREAD)
        for rj in MARCHES:
            out, flag, *mw = epdiff2d._launch_ad_star(p, m0, want_mw=want_mw, march=rj)
            assert torch.equal(out, ref[0]) and torch.equal(out, thread[0]), \
                f"K10 out at march {rj}, m0 batch {nb}"
            assert bool(flag) is bool(ref[1]) is bool(thread[1]) is True
            if want_mw:
                assert torch.equal(mw[0], ref[2]) and torch.equal(mw[0], thread[2]), \
                    f"K10 mw at march {rj}, m0 batch {nb}"
    ref = epdiff2d.compose2d_plain(p, v, -0.2)
    thread = epdiff2d._launch_compose(p, v, -0.2, march=epdiff2d.THREAD)
    for rj in MARCHES:
        out, flag = epdiff2d._launch_compose(p, v, -0.2, march=rj)
        assert torch.equal(out, ref[0]) and torch.equal(out, thread[0]), f"K11 at march {rj}"
        assert bool(flag) is bool(ref[1]) is bool(thread[1]) is True
    numel = N * 2 * H * W
    for at in sorted({0, W - 1, numel // 2 + 1, numel - W, numel - 1}):
        bad = f32(rng.uniform(-0.9, 0.9, shape))
        bad.view(-1)[at] = 1.0
        edge = f32(rng.uniform(-0.9, 0.9, shape))
        edge.view(-1)[at] = -1.0
        for march in (0, epdiff2d.THREAD):
            assert not epdiff2d._launch_ad_star(bad, bad, march=march)[1], \
                f"K10 flag at {at}, march {march}"
            assert not epdiff2d._launch_compose(bad, bad, 1.0, march=march)[1], \
                f"K11 flag at {at}, march {march}"
            assert epdiff2d._launch_ad_star(edge, edge, march=march)[1]
            assert epdiff2d._launch_compose(edge, edge, 1.0, march=march)[1]
        assert not bool(epdiff2d.ad_star2d(bad, bad)[1])
        assert not bool(epdiff2d.compose2d(bad, bad, 1.0)[1])


def test_host_atlas_step_2d_beta_matches_plain(rng, host_kernels):
    """Two chained 2D atlas steps with ``beta != 0`` (the per-substep
    kernels K10-K13 and the atlas warp K17, K18, emulated; the fluid solve
    plain on both sides) against the plain versions, at momenta in the unit
    regime (max|v0| = 0.5), with 4 launches of each of K10-K13 and one of
    K17 and K18 per step and no other kernel (``kernels.launch_counts()``),
    in 4 ``lt.substep`` spans and 5 fluid solves on the ``"rfftn"`` route."""
    shape = (2, 2, 12, 10)
    metric = lt.FluidMetric((0.1, 0.05, 0.01))
    m = f32(rng.standard_normal(shape))
    m = m * (0.5 / float(metric.sharp(m).abs().max()))
    I = f32(rng.standard_normal((1, 1) + shape[2:]))
    img = f32(rng.standard_normal((2, 1) + shape[2:]))
    step = lt.make_lddmm_atlas_step(metric, reg_weight=0.1,
                                    learning_rate_pose=1e-6)  # moves m by ~1%
    got, mm = [], m
    for _ in range(2):
        kernels.reset_launches()
        profiling.reset_counters()
        got.append(step(I, mm, img))
        mm = got[-1][0]
        assert kernels.launch_counts() == {
            k: (4 if k in KERNELS_2D_PER_OP else 1 if k in WARP2D else 0)
            for k in kernels.KERNELS}
        counts = profiling.counters()
        assert counts["lt.substep"] == 4
        assert {k: v for k, v in counts.items() if k.startswith("fluid.route.")} == {
            "fluid.route.rfftn": 5}
    ref, mm = [], m
    with kernels.plain_versions():
        for _ in range(2):
            ref.append(step(I, mm, img))
            mm = ref[-1][0]
    for (g_m, g_I, g_loss, _), (r_m, r_I, r_loss, _) in zip(got, ref):
        update, r_update = g_m - m, r_m - m
        assert float((update - r_update).abs().max()) <= 1e-4 * float(r_update.abs().max())
        assert float((g_I - r_I).abs().max()) <= 1e-5 * float(r_I.abs().max())
        assert abs(float(g_loss) - float(r_loss)) <= 1e-6 * abs(float(r_loss))


# Forced tile heights at 3 subjects of 12 x 10: one row a tile (both halo
# rows in other tiles), 4 (tiles within a subject), 5 and 16 (tiles that
# straddle subjects, halo rows in the next or previous subject)
TILE_SHAPE = (3, 2, 12, 10)


@pytest.mark.parametrize("tile", [0, 1, 4, 5, 16])
@pytest.mark.parametrize("m_batch", [1, "N"])
def test_host_epdiff2d_bwd_tiles(rng, host_kernels, tile, m_batch):
    """K12 on row tiles of the height it chooses (0) and of forced ones, for
    batch-N momenta (the launch reporting the height it took), within 1e-5
    * (1 + max|ref|) of the plain version, ``torch.equal`` to the per-thread
    kernels and rerun bit-identical; for a batch-1 m0 the tiles refused and
    the per-thread route (the library's for it) held to the plain version
    and rerun bit-identical, its d_m0 the float32 sum, in subject order, of
    the subjects' own (batch-N, on the tiles) d_m0, bit for bit; and K13,
    one thread a pixel, against the plain version, rerun bit-identical."""
    N, _, H, W = TILE_SHAPE
    cfg = epdiff2d.bwd_launch_config(N, H, W, tile)
    assert cfg["tile"] == (tile or cfg["tile"]) and cfg["blocks"] == -(-N * H // cfg["tile"])
    assert cfg["smem"] == 32 * (cfg["tile"] + 2) * W
    p = f32(rng.uniform(-0.99, 0.99, TILE_SHAPE))
    p.view(-1)[::7] = -0.999  # floor -1 and 0 on either side of the edges
    nb = 1 if m_batch == 1 else N
    m0 = f32(rng.standard_normal((nb, 2, H, W)))
    g = f32(rng.standard_normal(TILE_SHAPE))
    _, _, mw = epdiff2d.ad_star2d_plain(p, m0, want_mw=True)
    v = f32(rng.uniform(-4.9, 4.9, TILE_SHAPE))
    assert epdiff2d.bwd_route(N, nb, H, W) == ("tile" if nb == N else "thread")
    if nb != N:
        with pytest.raises(RuntimeError, match="lagomorph_ad_star2d_bwd"):
            epdiff2d._launch_ad_star_bwd(p, m0, g, mw, tile)
    route = tile if nb == N else epdiff2d.THREAD
    cases = (("K12", lambda: epdiff2d._launch_ad_star_bwd(p, m0, g, mw, route),
              epdiff2d.ad_star2d_bwd_plain(p, m0, g, mw)),
             ("K13", lambda: epdiff2d._launch_compose_bwd(p, v, -0.2, g),
              epdiff2d.compose2d_bwd_plain(p, v, -0.2, g)))
    for name, launch, ref in cases:
        got = launch()
        for what, a, b in zip(("d_phiinv", "d_m0" if name == "K12" else "d_v"), got, ref):
            close(f"{name} {what} (tile {tile}, m0 batch {m_batch})", a, b, BWD_RTOL)
        assert all(torch.equal(a, b) for a, b in zip(got, launch())), \
            f"{name} is not deterministic (tile {tile})"
        if name != "K12":
            continue
        if nb == N:
            thread = epdiff2d._launch_ad_star_bwd(p, m0, g, mw, epdiff2d.THREAD)
            assert all(torch.equal(a, b) for a, b in zip(got, thread)), \
                f"K12 on tiles of {tile} differs from the per-thread kernel"
        else:  # d_m0 summed over the subjects in their order
            m0_n = m0.expand(N, -1, -1, -1).contiguous()
            each = epdiff2d._launch_ad_star_bwd(p, m0_n, g, mw, tile)[1]
            total = torch.zeros_like(m0)
            for n in range(N):
                total = total + each[n:n + 1]
            assert torch.equal(got[1], total), "K12's batch-1 d_m0 is not the ordered sum"


def test_host_epdiff2d_bwd_routes(rng, host_kernels):
    """K12's route by shape: its tiles for batch-N momenta where a stage of
    one row and its halo fits a block's 227 KB (W up to 2421) and a field
    has fewer than 2**31 elements, else one thread a pixel; at W = 2422 the
    wrapper launches it on that route, within 1e-5 * (1 + max|ref|) of the
    plain version, and a tile launch forced there is refused."""
    route = epdiff2d.bwd_route
    assert [route(1, 1, 2, w) for w in (2421, 2422)] == ["tile", "thread"]
    assert route(2**20, 2**20, 2**5, 2**5) == "thread"  # 2**31 elements
    assert route(2**20 - 1, 2**20 - 1, 2**5, 2**5) == "tile"
    shape = (2, 2, 2, 2422)
    p = f32(rng.uniform(-0.99, 0.99, shape))
    m0 = f32(rng.standard_normal(shape))
    g = f32(rng.standard_normal(shape))
    _, _, mw = epdiff2d.ad_star2d_plain(p, m0, want_mw=True)
    kernels.reset_launches()
    for what, a, b in zip(("K12 d_phiinv", "K12 d_m0"), epdiff2d._launch_ad_star_bwd(p, m0, g, mw),
                          epdiff2d.ad_star2d_bwd_plain(p, m0, g, mw)):
        close(what, a, b, BWD_RTOL)
    assert kernels.launch_counts()["ad_star2d_bwd"] == 1
    with pytest.raises(RuntimeError, match="lagomorph_ad_star2d_bwd"):
        epdiff2d._launch_ad_star_bwd(p, m0, g, mw, 0)


# K17/K18 shapes (N, H, W) against the 8 x 32 tiles: odd and crossing tiles
# on both axes (halo rows and columns inside the image), smaller than a
# tile, exact multiples of it, one row, one row and one column past a tile
WARP2D_SHAPES = [(3, 13, 37), (2, 5, 7), (2, 16, 64), (2, 1, 3), (5, 9, 33)]
JUST_UNDER_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def _unit_disp(rng, shape):
    """Displacements in the unit regime, a quarter of them at its edges and
    at the integers: exactly -1 and 0, and just under 1 and -1."""
    p = rng.uniform(-0.999, 0.999, shape)
    edge = rng.uniform(size=shape) < 0.25
    special = rng.choice([-1.0, 0.0, JUST_UNDER_ONE, -JUST_UNDER_ONE], size=shape)
    return f32(np.where(edge, special, p))


@pytest.mark.parametrize("shape", WARP2D_SHAPES)
@pytest.mark.parametrize("batch", ["one", "N"])
def test_host_warp2d_matches_plain(rng, host_kernels, shape, batch):
    """K17 and K18 (``csrc/warp2d.cu``) against the plain 2D stencil and
    its autograd, for I of batch 1 and batch N with 1, 2 and 3 channels
    (two launches of K18, the second adding its weight gradient): K17
    ``torch.equal``; K18's ``dI`` and ``d_disp`` within 1e-5 * (1 +
    max|ref|), through the autograd Function, a rerun bit-identical; a
    batch-1 ``dI`` the float32 sum, in subject order, of the subjects' own
    (batch-N) ``dI``, bit for bit, and its ``d_disp`` theirs; one launch
    of K17 a call and of K18 a pair of channels."""
    N, H, W = shape
    p = _unit_disp(rng, (N, 2, H, W))
    for C in (1, 2, 3):
        nb = 1 if batch == "one" else N
        I = f32(rng.standard_normal((nb, C, H, W)))
        g = f32(rng.standard_normal((N, C, H, W)))
        kernels.reset_launches()
        out = warp2d.sample_displacement_unit(I, p)
        assert torch.equal(out, warp2d.sample_displacement_unit_plain(I, p)), f"K17 C={C}"
        leaves = (I.clone().requires_grad_(True), p.clone().requires_grad_(True))
        got = torch.autograd.grad(warp2d.sample_displacement_unit(*leaves), leaves, g)
        ref = warp2d.sample_displacement_unit_bwd_plain(I, p, g)
        for what, a, b in zip(("dI", "d_disp"), got, ref):
            close(f"K18 {what} (C={C}, I batch {nb})", a, b, BWD_RTOL)
        pairs = -(-C // 2)
        assert kernels.launch_counts()["warp2d_fwd"] == 2
        assert kernels.launch_counts()["warp2d_bwd"] == pairs
        again = warp2d._launch_bwd(I, p, g)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), "K18 is not deterministic"
        if nb == 1:
            each = warp2d._launch_bwd(I.expand(N, -1, -1, -1).contiguous(), p, g)
            total = torch.zeros_like(I)
            for n in range(N):
                total = total + each[0][n:n + 1]
            assert torch.equal(got[0], total), "K18's batch-1 dI is not the ordered sum"
            assert torch.equal(got[1], each[1])


def test_host_warp2d_refuses_bad_inputs(rng, host_kernels):
    """K17's wrapper raises for a displacement that is not ``(N, 2, H,
    W)``, an image of another batch or grid, and (as on the card) a
    non-contiguous or non-float32 tensor; it falls back to nothing."""
    p = _unit_disp(rng, (2, 2, 6, 5))
    I = f32(rng.standard_normal((1, 1, 6, 5)))
    strided = p.transpose(2, 3).contiguous().transpose(2, 3)
    assert strided.shape == p.shape and not strided.is_contiguous()
    for bad_I, bad_p in ((I, p[:, :1]), (I[:, :, :5], p), (I.expand(3, -1, -1, -1), p),
                         (I, strided), (I.double(), p)):
        with pytest.raises((ValueError, TypeError)):
            warp2d.sample_displacement_unit(bad_I, bad_p)


def test_host_atlas_step_2d_warp_matches_plain(rng, host_kernels):
    """Two chained 2D atlas steps with ``beta == 0`` (the whole shoot plain,
    the atlas warp on K17 and K18, emulated) against the plain versions at
    momenta in the unit regime (max|v0| = 0.5): one launch of K17 and one of
    K18 a step, and no other kernel; the updated momenta, the atlas gradient and the loss as
    the plain step's."""
    shape = (3, 2, 13, 37)
    metric = lt.FluidMetric((0.1, 0.0, 0.01))
    m = f32(rng.standard_normal(shape))
    m = m * (0.5 / float(metric.sharp(m).abs().max()))
    I = f32(rng.standard_normal((1, 1) + shape[2:]))
    img = f32(rng.standard_normal((3, 1) + shape[2:]))
    step = lt.make_lddmm_atlas_step(metric, reg_weight=0.1, learning_rate_pose=1e-6)
    got, mm = [], m
    for _ in range(2):
        kernels.reset_launches()
        got.append(step(I, mm, img))
        mm = got[-1][0]
        assert kernels.launch_counts() == {k: (1 if k in WARP2D else 0) for k in kernels.KERNELS}
    ref, mm = [], m
    with kernels.plain_versions():
        for _ in range(2):
            ref.append(step(I, mm, img))
            mm = ref[-1][0]
    for (g_m, g_I, g_loss, _), (r_m, r_I, r_loss, _) in zip(got, ref):
        update, r_update = g_m - m, r_m - m
        assert float((update - r_update).abs().max()) <= 1e-4 * float(r_update.abs().max())
        assert float((g_I - r_I).abs().max()) <= 1e-5 * float(r_I.abs().max())
        assert abs(float(g_loss) - float(r_loss)) <= 1e-6 * abs(float(r_loss))
