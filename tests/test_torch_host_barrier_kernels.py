"""The kernels with shared memory and barriers, compiled for the host and
run on the CPU against their plain versions.

K3 (``csrc/fft_unit.cu``), K14 and K15 (``fft_radix.cu``), K16
(``fft_whole.cu``) and K8/K9 (``shoot2d.cu``) share memory within a block
and wait at barriers, and K8, K9 and K16 are cooperative launches whose
phases meet at grid-wide barriers.  ``tests/cuda_host/threaded/
cuda_runtime.h`` runs each CUDA thread as an OS thread (a block's barrier,
a warp's vote, a block's shared-memory buffer; every block of a
cooperative launch at once, with a barrier of the grid), and this test
rewrites each launch, each dynamic shared-memory declaration and each
cooperative launch for it, so g++ builds the sources into a host library
with the kernels' C entry points.  The wrappers then call it in place of
the card's library.  So the kernels' indexing, tiles, stage loops,
bit-reversed bookkeeping, phase order and both of K14's paths (a whole
(Y, Z) plane per block, or two line passes when the plane exceeds a block's
227 KB) are checked here; the card itself is checked by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerance, float32 against the plain versions on the same inputs: 1e-5 *
max|ref| (the transforms round in another order than the plain versions;
the solves amplify low frequencies by 1/gamma^2 = 1e4).
"""
import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch.ops import fluid, kernels
from lagomorph_tpu_torch.ops.kernels import _build, fft_radix, fft_unit, fft_whole, shoot2d

torch.set_num_threads(2)

SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_host", "threaded")
HEADERS = ("fft_lines.cuh", "cooperative.cuh", "stencil2d.cuh")
SOURCES = ("fft_unit.cu", "fft_radix.cu", "fft_whole.cu", "shoot2d.cu")
ENTRY_POINTS = ("lagomorph_fluid_flat", "lagomorph_fluid_radix_zy", "lagomorph_fluid_radix_x",
                "lagomorph_fluid_whole", "lagomorph_shoot2d_fwd", "lagomorph_shoot2d_bwd")
RTOL = 1e-5
PARAMS = (0.1, 0.0, 0.01)
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
    """The CUDA source rewritten for the threaded emulation."""
    def launch(m):
        grid, block, smem = (_top_level_args(m.group(2)) + ["0"])[:3]
        return f"emu_launch({grid}, {block}, {smem}, [&] {{ {m.group(1)}({m.group(3)}); }});"
    text = LAUNCH.sub(launch, text)
    text = re.sub(r"extern __shared__ float2 (\w+)\[\];", r"float2* \1 = emu_smem_ptr;", text)
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
    (out / "error_string.cpp").write_text(
        'extern "C" const char* lagomorph_error_string(int) { return "host emulation"; }\n')
    so = out / "libhost_barrier_kernels.so"
    cmd = [gxx, "-x", "c++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
           "-I", SHIM, "-I", str(out), "-o", str(so),
           *(str(out / s) for s in SOURCES + ("error_string.cpp",))]
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
    """The wrappers of K3, K8, K9 and K14-K16 launch the host library on CPU
    tensors, as on the card: float32 and contiguous, or they raise."""
    def check_cpu_f32(name, *tensors):
        for t in tensors:
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: kernel takes contiguous tensors")

    monkeypatch.setattr(_build, "library", lambda: host_library)
    for mod in (fft_unit, fft_radix, fft_whole, shoot2d):
        monkeypatch.setattr(mod, "use_kernel", lambda _t: not kernels._PLAIN.get())
        monkeypatch.setattr(mod, "check_cuda_f32", check_cpu_f32)
        monkeypatch.setattr(mod, "stream_of", lambda _t: None)


def f32(a):
    return torch.as_tensor(a, dtype=torch.float32)


def close(name, got, ref, rtol=RTOL):
    err = float((got.double() - ref.double()).abs().max())
    bound = rtol * float(ref.double().abs().max())
    assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"


def _multiplier(route, spatial):
    return fluid.form_multiplier(fluid.multiplier_form(route), spatial, PARAMS, True,
                                 torch.float32, "cpu")


@pytest.mark.parametrize("spatial", [(4, 8, 16), (2, 256, 128)])
def test_host_radix_kernels_match_plain(rng, host_kernels, spatial):
    """K14 forward and inverse, K15 on K14's spectrum and the pipeline
    K14, K15, K14 (directly and under autograd: 3 launches each way)
    against their plain versions, at a (Y, Z) plane that one block holds
    and at one that exceeds a block's shared memory (256 x 128: two line
    passes)."""
    x = f32(rng.standard_normal((2 if spatial[1] > 8 else 6,) + spatial))
    Mbr = _multiplier("fluid_radix", spatial)
    kernels.reset_launches()
    spec = fft_radix.radix_zy(x, False)
    for got, fn, args in ((spec, fft_radix.radix_zy, (x, False)),
                          (fft_radix.radix_zy(spec, True), fft_radix.radix_zy, (spec, True)),
                          (fft_radix.radix_x(spec, Mbr), fft_radix.radix_x, (spec, Mbr)),
                          (fft_radix.fluid_radix(x, Mbr), fft_radix.fluid_radix, (x, Mbr))):
        with kernels.plain_versions():
            close(fn.__name__, got, fn(*args))
    counts = kernels.launch_counts()
    assert counts["fluid_radix_zy"] == 4 and counts["fluid_radix_x"] == 2
    leaves = [x.clone().requires_grad_(True) for _ in range(2)]
    cot = f32(rng.standard_normal(tuple(x.shape)))
    (got,) = torch.autograd.grad(fft_radix.fluid_radix(leaves[0], Mbr), leaves[0], cot)
    assert kernels.launch_counts()["fluid_radix_zy"] == 8
    with kernels.plain_versions():
        (ref,) = torch.autograd.grad(fft_radix.fluid_radix(leaves[1], Mbr), leaves[1], cot)
    close("fluid_radix backward", got, ref)


@pytest.mark.parametrize("spatial", [(4, 8, 16), (5, 6, 7)])
def test_host_fluid_solves_match_plain(rng, host_kernels, spatial):
    """K16 (one cooperative launch, five phases) and K3 (five passes)
    against their plain version, the ``torch.fft`` packed solve, at a
    power-of-two shape (radix-2 line transforms) and an odd one (direct
    sums); K16 under autograd (one launch each way)."""
    x = f32(rng.standard_normal((6,) + spatial))
    Mn = _multiplier("fluid_whole", spatial)
    ref = fft_unit.fluid_flat_plain(x, Mn)
    kernels.reset_launches()
    close("fluid_whole", fft_whole.fluid_whole(x, Mn), ref)
    close("fluid_flat", fft_unit.fluid_flat(x, Mn), ref)
    leaf = x.clone().requires_grad_(True)
    cot = f32(rng.standard_normal(tuple(x.shape)))
    (got,) = torch.autograd.grad(fft_whole.fluid_whole(leaf, Mn), leaf, cot)
    close("fluid_whole backward", got, fft_unit.fluid_flat_plain(cot, Mn))
    assert kernels.launch_counts()["fluid_whole"] == 3
    assert kernels.launch_counts()["fluid_flat"] == 1


def test_host_shoot2d_kernels_match_plain(rng, host_kernels):
    """K8 (phiinv_T, the flag, the stashed trajectory) and K9 (both
    gradients) against their plain versions, 4 substeps at s = -0.2 from
    momenta at max|v0| = 0.5, batch-N and batch-1 momenta."""
    N, H, W = 2, 8, 16
    Mn = lt.FluidMetric(PARAMS).packed_multiplier((H, W), torch.float32, "cpu")
    for nb in (N, 1):
        m0 = f32(rng.standard_normal((nb, 2, H, W)))
        m0 = m0 * (0.5 / float(shoot2d.fluid2d_plain(m0, Mn).abs().max()))
        phi0 = (-0.2 * shoot2d.fluid2d_plain(m0, Mn)).expand(N, -1, -1, -1).contiguous()
        got = shoot2d._launch_fwd(phi0, m0, Mn, -0.2, 4, True)
        ref = shoot2d.shoot2d_fwd_plain(phi0, m0, Mn, -0.2, 4)
        for what, g, r in zip(("phiinv_T", "traj_phiinv", "traj_v", "traj_mw"),
                              got[:1] + got[2:], ref[:1] + ref[2:]):
            close(f"K8 {what}", g, r)
        assert bool(got[1]) and bool(ref[1])
        g = f32(rng.standard_normal((N, 2, H, W)))
        for what, a, b in zip(("d_phiinv0", "d_m0"),
                              shoot2d._launch_bwd(m0, g, *ref[2:], Mn, -0.2),
                              shoot2d.shoot2d_bwd_plain(m0, g, *ref[2:], Mn, -0.2)):
            close(f"K9 {what}", a, b)
