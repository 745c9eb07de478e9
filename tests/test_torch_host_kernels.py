"""The per-pixel 2D stencil kernels' CUDA source, compiled for the host and
run on the CPU against their plain versions.

K10-K13 (``lagomorph_tpu_torch/csrc/epdiff2d.cu``) are per-thread code: no
shared memory, no barriers, one ballot.  With every
``k<<<grid, block, ...>>>(args)`` launch rewritten as a loop over the
grid's threads and ``tests/cuda_host/cuda_runtime.h`` standing in for the
CUDA runtime, g++ compiles them into a host library with the same C entry
points, which the kernel wrappers then call in place of the card's
library.  So the kernels' arithmetic, indexing, clamp folds, batch-1 sums
and flags are checked here, in float32, before the card sees them; the
card itself is checked by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  The 3D stencils K1, K2 and K4-K7 (``warp_unit.cu``,
``epdiff_unit.cu``: the warp's backward passes stage bricks in shared
memory between barriers), the transforms K3 and K14-K16 and K8/K9 run on
the threaded emulation of ``tests/test_torch_host_barrier_kernels.py``;
here their wrappers run their plain versions.

K10-K13 run the per-pixel functions of ``csrc/stencil2d.cuh``, which K8
and K9 share; K8 and K9 themselves (cooperative launches, grid barriers,
shared-memory line transforms) do not fit this emulation.

Tolerances, float32 against the plain version on the same inputs: the
forwards round each operation like the plain version (bit-equal); the
backwards sum in another order than autograd (1e-5 * (1 + max|ref|)).
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
from lagomorph_tpu_torch.ops import kernels
from lagomorph_tpu_torch.ops.kernels import _build, epdiff2d

torch.set_num_threads(2)

SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_host")
SOURCES = ("epdiff2d.cu",)
KERNELS_2D_PER_OP = ("ad_star2d_fwd", "compose2d_fwd", "ad_star2d_bwd", "compose2d_bwd")
BWD_RTOL = 1e-5
LAUNCH = re.compile(r"([\w:]+)\s*<<<(.*?)>>>\s*\((.*?)\);", re.S)


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
    """The CUDA source with each launch rewritten for the host."""
    def launch(m):
        grid, block = _top_level_args(m.group(2))[:2]
        return f"emu_launch({grid}, {block}, [&] {{ {m.group(1)}({m.group(3)}); }});"
    return LAUNCH.sub(launch, text)


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """The 2D stencil source built as a host library (skips without g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' sources for the host")
    out = tmp_path_factory.mktemp("host_kernels")
    for name in ("stencil2d.cuh",) + SOURCES:
        with open(os.path.join(_build.CSRC, name)) as f:
            (out / name).write_text(_host_source(f.read()))
    (out / "error_string.cpp").write_text(
        'extern "C" const char* lagomorph_error_string(int) { return "host emulation"; }\n')
    so = out / "libhost_kernels.so"
    cmd = [gxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-w", "-I", SHIM,
           "-I", str(out), "-o", str(so),
           *(str(out / s) for s in SOURCES + ("error_string.cpp",))]
    r = subprocess.run(cmd, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    for name in ("lagomorph_ad_star2d_fwd", "lagomorph_compose2d_fwd",
                 "lagomorph_ad_star2d_bwd", "lagomorph_compose2d_bwd"):
        getattr(lib, name).argtypes = _build.SIGNATURES[name]
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
