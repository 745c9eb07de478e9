"""The 2D per-substep stencil kernels' CUDA source, compiled for the host
and run on the CPU against their plain versions.

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
wrappers then call in place of the card's library.  It is built from
``csrc/profile/epdiff2d_variants.cu``, which includes ``epdiff2d.cu``, so
the forms the library does not take (K10 and K11 one thread a pixel on
their live taps, or at any strip width and band height, with or without the
prefetch; K13 on K12's tiles, K12's tiles for a batch-1 m0), which ``profile_epdiff2d.py`` times on the card, are held
here too.  So the kernels' arithmetic, indexing, tiles and halos, clamp
folds, batch-1 sums and flags are checked here, in float32, before the card
sees them; the card itself is checked by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  The other kernels run on the threaded emulation of
``tests/test_torch_host_barrier_kernels.py``; here their wrappers run their
plain versions.

Tolerances, float32 against the plain version on the same inputs: the
forwards round each operation like the plain version (bit-equal); the
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
from lagomorph_tpu_torch.ops import kernels
from lagomorph_tpu_torch.ops.kernels import _build, epdiff2d
from profile_epdiff2d import FWD10, FWD11, PARTS12, PARTS13, PIXEL12, fwd10, fwd11, parts12, parts13
from test_torch_host_barrier_kernels import SHIM, _host_source

torch.set_num_threads(2)

HEADERS = ("stencil2d.cuh", "tile2d.cuh", "epdiff2d.cu")
SOURCE = os.path.join("profile", "epdiff2d_variants.cu")
KERNELS_2D_PER_OP = ("ad_star2d_fwd", "compose2d_fwd", "ad_star2d_bwd", "compose2d_bwd")
ENTRY_POINTS = ("lagomorph_ad_star2d_fwd", "lagomorph_compose2d_fwd", "lagomorph_ad_star2d_bwd",
                "lagomorph_compose2d_bwd", "lagomorph_ad_star2d_bwd_grid",
                "lagomorph_epdiff2d_fwd_grid")
BWD_RTOL = 1e-5


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """The 2D stencil source built as a threaded host library (skips
    without a g++ that has C++20's <barrier>)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' sources for the host")
    out = tmp_path_factory.mktemp("host_kernels")
    (out / "profile").mkdir()
    for name in HEADERS + (SOURCE,):
        with open(os.path.join(_build.CSRC, name)) as f:
            (out / name).write_text(_host_source(f.read()))
    (out / "error_string.cpp").write_text(
        'extern "C" const char* lagomorph_error_string(int) { return "host emulation"; }\n')
    so = out / "libhost_kernels.so"
    cmd = [gxx, "-x", "c++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
           "-I", SHIM, "-I", str(out), "-o", str(so), str(out / SOURCE),
           str(out / "error_string.cpp")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0 and "barrier" in r.stderr and "No such file" in r.stderr:
        pytest.skip("needs a g++ with C++20's <barrier>")
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    for name in ENTRY_POINTS:
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    for name, types in (("prof_epdiff2d_parts12", PARTS12), ("prof_epdiff2d_parts13", PARTS13),
                        ("prof_epdiff2d_pixel12", PIXEL12), ("prof_ad_star2d_fwd", FWD10),
                        ("prof_compose2d_fwd", FWD11)):
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    lib.lagomorph_error_string.argtypes = [ctypes.c_int]
    lib.lagomorph_error_string.restype = ctypes.c_char_p
    return lib


@pytest.fixture
def host_kernels(monkeypatch, host_library):
    """The 2D stencil wrappers launch the host library on CPU tensors, as on
    the card: float32 and contiguous, or they raise."""
    def check_cpu_f32(name, *tensors):
        for t in tensors:
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name}: kernel takes contiguous float32 tensors")

    monkeypatch.setattr(_build, "library", lambda: host_library)
    for mod in (epdiff2d,):
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
# W % PX != 0 (7, and 9 at PX 2 and 4 against 12), H = 2, H not a multiple
# of the band height, a row of one strip, a row of several warps' strips
STRIP_SHAPES = [(2, 2, 9, 12), (3, 2, 2, 7), (2, 2, 5, 40), (1, 2, 3, 2), (2, 2, 4, 136)]
# (form, PX, RJ) of the profile's entry points: the march (1) at each strip
# width and bands of 1 and 3 rows, without its prefetch (2), and one thread
# a pixel on the live taps (0)
STRIP_FORMS = [(1, px, rj) for px in (1, 2, 4) for rj in (1, 3)] + [(2, 4, 2), (0, 1, 1)]


@pytest.mark.parametrize("shape", STRIP_SHAPES)
def test_host_epdiff2d_fwd_strips(rng, host_kernels, host_library, shape):
    """K10 (out, with and without ``mw``; batch-1 and batch-N m0) and K11 (s
    = -0.2) on column strips of PX columns marching down bands of RJ rows
    (their route below ``2**31`` elements a field):
    the library's launch at its chooser's geometry and at forced band
    heights, and the profile's forms at every strip width, ``torch.equal``
    to the plain versions and to the per-thread kernels (``march`` -1), the
    flags equal; and each form's flag false for one value out of the unit
    regime at several places (the upper bound is open) and true at -1 (the
    lower bound is closed)."""
    N, _, H, W = shape
    assert epdiff2d.fwd_route(N, H, W) == "march"
    assert epdiff2d.fwd_route(2**20, 2**5, 2**5) == "thread"  # 2**31 elements: int indices
    assert epdiff2d.fwd_route(2**20 - 1, 2**5, 2**5) == "march"
    cfg = epdiff2d.fwd_launch_config("ad_star2d_fwd", N, H, W, 3)
    assert cfg["rj"] == 3 and cfg["px"] in (1, 2, 4)
    own = epdiff2d.fwd_launch_config("compose2d_fwd", N, H, W)
    assert W % own["px"] == 0 and own["blocks"] >= 1
    p = f32(np.where(rng.uniform(size=shape) < 0.5, rng.uniform(-0.999, -0.001, shape),
                     rng.uniform(0.001, 0.999, shape)))
    v = f32(rng.uniform(-4.9, 4.9, shape))
    for nb, want_mw in ((N, True), (1, False), (1, True)):
        m0 = f32(rng.standard_normal((nb, 2, H, W)))
        ref = epdiff2d.ad_star2d_plain(p, m0, want_mw=True)
        thread = epdiff2d._launch_ad_star(p, m0, want_mw=True, march=epdiff2d.THREAD)
        got = [epdiff2d._launch_ad_star(p, m0, want_mw=want_mw, march=rj) for rj in (0, 1, 2)]
        got += [fwd10(host_library, f, p, m0, want_mw, None) for f in STRIP_FORMS]
        for geo, (out, flag, *mw) in zip(["own", "rj 1", "rj 2", *STRIP_FORMS], got):
            assert torch.equal(out, ref[0]) and torch.equal(out, thread[0]), \
                f"K10 out at {geo}, m0 batch {nb}"
            assert bool(flag) is bool(ref[1]) is bool(thread[1]) is True
            if want_mw:
                assert torch.equal(mw[0], ref[2]) and torch.equal(mw[0], thread[2]), \
                    f"K10 mw at {geo}, m0 batch {nb}"
    ref = epdiff2d.compose2d_plain(p, v, -0.2)
    thread = epdiff2d._launch_compose(p, v, -0.2, march=epdiff2d.THREAD)
    got = [epdiff2d._launch_compose(p, v, -0.2, march=rj) for rj in (0, 1, 2)]
    got += [fwd11(host_library, f, p, v, -0.2, None) for f in STRIP_FORMS]
    for geo, (out, flag) in zip(["own", "rj 1", "rj 2", *STRIP_FORMS], got):
        assert torch.equal(out, ref[0]) and torch.equal(out, thread[0]), f"K11 at {geo}"
        assert bool(flag) is bool(ref[1]) is bool(thread[1]) is True
    numel = N * 2 * H * W
    for at in sorted({0, W - 1, numel // 2 + 1, numel - W, numel - 1}):
        bad = f32(rng.uniform(-0.9, 0.9, shape))
        bad.view(-1)[at] = 1.0
        edge = f32(rng.uniform(-0.9, 0.9, shape))
        edge.view(-1)[at] = -1.0
        for f in ((1, 4, 3), (1, 1, 1), (0, 1, 1)):
            assert not fwd10(host_library, f, bad, bad, False, None)[1], f"K10 flag at {at}, {f}"
            assert not fwd11(host_library, f, bad, bad, 1.0, None)[1], f"K11 flag at {at}, {f}"
            assert fwd10(host_library, f, edge, edge, False, None)[1]
            assert fwd11(host_library, f, edge, edge, 1.0, None)[1]
        assert not bool(epdiff2d.ad_star2d(bad, bad)[1])
        assert not bool(epdiff2d.compose2d(bad, bad, 1.0)[1])


def test_host_atlas_step_2d_beta_matches_plain(rng, host_kernels):
    """Two chained 2D atlas steps with ``beta != 0`` (the per-substep
    kernels K10-K13, emulated; the fluid solve and the atlas warp plain on
    both sides) against the plain versions, at momenta in the unit regime
    (max|v0| = 0.5), with 4 launches of each per step and no other kernel."""
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
        got.append(step(I, mm, img))
        mm = got[-1][0]
        assert kernels.launch_counts() == {k: (4 if k in KERNELS_2D_PER_OP else 0)
                                           for k in kernels.KERNELS}
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
def test_host_epdiff2d_bwd_tiles(rng, host_kernels, host_library, tile, m_batch):
    """K12 on row tiles of the height it chooses (0) and of forced ones:
    for batch-N momenta the library's tile kernel (the launch reporting the
    height it took), for a batch-1 m0 (which the library sends to the
    per-thread route, refusing its tiles) the profile's tile form that
    writes d_mw for the sum over the subjects; and K13 on the same tiles
    (the profile's form).  Each against the plain version within 1e-5 * (1
    + max|ref|), ``torch.equal`` to the per-thread kernel, a rerun
    bit-identical; a batch-1 m0's d_m0 is the float32 sum, in subject
    order, of the subjects' own (batch-N) d_m0, bit for bit."""
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

    def k12():
        if nb == N:
            return epdiff2d._launch_ad_star_bwd(p, m0, g, mw, tile)
        return parts12(host_library, (3, 3, tile), p, m0, g, mw, None)

    cases = (("K12", k12, lambda: epdiff2d._launch_ad_star_bwd(p, m0, g, mw, epdiff2d.THREAD),
              epdiff2d.ad_star2d_bwd_plain(p, m0, g, mw)),
             ("K13", lambda: parts13(host_library, (3, 3, tile), p, v, -0.2, g, None),
              lambda: epdiff2d._launch_compose_bwd(p, v, -0.2, g),
              epdiff2d.compose2d_bwd_plain(p, v, -0.2, g)))
    for name, launch, thread, ref in cases:
        got = launch()
        for what, a, b in zip(("d_phiinv", "d_m0" if name == "K12" else "d_v"), got, ref):
            close(f"{name} {what} (tile {tile}, m0 batch {m_batch})", a, b, BWD_RTOL)
        assert all(torch.equal(a, b) for a, b in zip(got, thread())), \
            f"{name} on tiles of {tile} differs from the per-thread kernel"
        assert all(torch.equal(a, b) for a, b in zip(got, launch())), \
            f"{name} is not deterministic (tile {tile})"
        if name == "K12" and nb != N:  # d_m0 summed over the subjects in their order
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
