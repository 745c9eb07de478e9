"""Build and load the CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` of the package to an
object file, one process per source, all started together, and links the
objects into one shared library with a plain C interface, which is loaded
with ``ctypes``.  The library lands in ``lagomorph_tpu_torch/_build/`` under
a name that carries a hash of the sources and flags, so a changed source
rebuilds and an unchanged one is reused.  Nothing is built when a module is
imported.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argument types (every one returns cudaError_t)
SIGNATURES = {
    # I, disp, out, N, NI, C, X, Y, Z, stream
    "lagomorph_warp_unit_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # I, disp, g, dI, d_disp, N, NI, C, X, Y, Z, stream
    "lagomorph_warp_unit_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # the two passes of K5 alone (also K6's and K7's), for timing:
    # disp, s, cot, out, N, NI, C, X, Y, Z, stream
    "lagomorph_warp_transpose": [_P, _F, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # I, disp, s, cot, out, N, NI, C, X, Y, Z, compose, stream
    "lagomorph_warp_dd": [_P, _P, _F, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # phiinv, m0, out, mw (or NULL), flag, N, Nm, X, Y, Z, march (<= 0: K1's length), stream
    "lagomorph_ad_star_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # phiinv, m0, g, mw, d_mw (scratch), d_phiinv, d_m0, N, Nm, X, Y, Z, stream
    "lagomorph_ad_star_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # its first pass alone, for timing and tests (march <= 0: K6's length):
    # phiinv, m0, g, mw, d_mw, d_phiinv, N, Nm, X, Y, Z, march, stream
    "lagomorph_ad_star_bwd_first": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # phiinv, v, s, out, flag, N, X, Y, Z, march (<= 0: K2's length), stream
    "lagomorph_compose_fwd": [_P, _P, _F, _P, _P, _I, _I, _I, _I, _I, _P],
    # phiinv, v, s, g, d_phiinv, d_v, N, X, Y, Z, stream
    "lagomorph_compose_bwd": [_P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _P],
    # x1, x2, Mn, y1, y2, scratch, F, X, Y, Z, stream
    "lagomorph_fluid_flat": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # re, im, out_re, out_im, F, X, Y, Z, inverse, stream
    "lagomorph_fluid_radix_zy": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # re, im, Mbr, out_re, out_im, F, X, Y, Z, stream
    "lagomorph_fluid_radix_x": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x1, x2, Mn, y1, y2, scratch, F, X, Y, Z, stream
    "lagomorph_fluid_whole": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # X, Y, Z, out (4 ints: path, blocks, threads, shared bytes)
    "lagomorph_fluid_whole_grid": [_I, _I, _I, _P],
    # phiinv, m0, out, mw (or NULL), flag, N, Nm, H, W,
    # march (0: the strips' chooser, > 0: rows a band, -1: the per-thread kernel), stream
    "lagomorph_ad_star2d_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # which (0: K10, 1: K11), N, H, W, march, out (4 ints: PX, RJ, blocks, blocks an SM)
    "lagomorph_epdiff2d_fwd_grid": [_I, _I, _I, _I, _I, _P],
    # phiinv, m0, g, mw, d_mw (scratch, or NULL on the tiles), d_phiinv, d_m0,
    # N, Nm, H, W, tile (0: K12's choice, -1: the per-thread route), stream
    "lagomorph_ad_star2d_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # N, H, W, tile, out (3 ints: K12's tile height, blocks, shared bytes)
    "lagomorph_ad_star2d_bwd_grid": [_I, _I, _I, _I, _P],
    # phiinv, v, s, out, flag, N, H, W, march (as K10's), stream
    "lagomorph_compose2d_fwd": [_P, _P, _F, _P, _P, _I, _I, _I, _I, _P],
    # phiinv, v, s, g, d_phiinv, d_v, N, H, W, stream
    "lagomorph_compose2d_bwd": [_P, _P, _F, _P, _P, _P, _I, _I, _I, _P],
    # phi0, m0, Mn, out, flag, traj_p, traj_v, traj_mw (or 3 NULL), pp (or NULL),
    # cbuf, N, Nm, H, W, T, s, tile (0: K8's choice), stream
    "lagomorph_shoot2d_fwd": [_P] * 10 + [_I] * 5 + [_F, _I, _P],
    # N, H, W, tile, out (8 ints: path, tile height, blocks, threads, shared
    # bytes, the tiles of phases A-C)
    "lagomorph_shoot2d_fwd_grid": [_I, _I, _I, _I, _P],
    # m0, g, Mn, traj_p, traj_v, traj_mw, d_m0, d_phi0, cbuf, dmw (or NULL), gbuf,
    # N, Nm, H, W, T, s, tile (0: K9's choice), stream
    "lagomorph_shoot2d_bwd": [_P] * 11 + [_I] * 5 + [_F, _I, _P],
    # N, H, W, tile, out (8 ints: path, tile height, blocks, threads, shared
    # bytes, the tiles of phases 1-3)
    "lagomorph_shoot2d_bwd_grid": [_I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""  # the compiler's output of the build that produced _lib


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc():
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def _run_all(cmds):
    """Run the commands in parallel; raise with the output of the first that
    fails.  Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile_and_link(so):
    """Compile every source to an object in parallel, link them into
    ``so`` (written under a temporary name, then moved in place); returns
    the compiler's output."""
    nvcc = _nvcc()
    tag = f"{so}.{os.getpid()}"
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in _sources()]
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj, src]
                        for obj, src in zip(objs, _sources())])
        log += _run_all([[nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", f"{tag}.tmp", *objs]])
        os.replace(f"{tag}.tmp", so)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return log


def library():
    """The loaded kernel library, built on first use."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"liblagomorph_kernels_{_digest()}.so")
        if not os.path.exists(so):
            build_log = _compile_and_link(so)
        lib = ctypes.CDLL(so)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.lagomorph_error_string.argtypes = [ctypes.c_int]
        lib.lagomorph_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def call(name, *args):
    """Call C entry point ``name``; raise if it reports a CUDA error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.lagomorph_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
