#!/usr/bin/env python3
"""Profile of the unit-regime warp's passes on one CUDA card, by variants.

    python3 profile_warp.py

Nsight Compute does not run on the card's machine, so each cost of the
warp kernels before their redesign is isolated by a variant kernel
(``lagomorph_tpu_torch/csrc/profile/warp_variants.cu``, built here with
nvcc) and timed with CUDA events beside the previous kernel and the
current one (``csrc/warp_unit.cu``), at the operand shapes of the 3D atlas
step at 128^3 b4:

* the transpose at K5's shape (C = 1, batch-1 atlas, summed over N = 4)
  and at K7's (C = 3, NI = N, s = -0.2): the previous kernel, the previous
  kernel reading precomputed weights (no recomputation; nothing staged),
  and the current one (weights computed once per source and staged with
  the cotangent in a brick with its halo);
* the weight-gradient pass at K5's shape (C = 1) and K7's (C = 3 with the
  compose epilogue): the previous kernel (27 taps), the previous kernel on
  the 8 live taps (nothing staged), and the current one (8 live taps, the
  brick of I staged);
* the forward K4 (C = 1, the atlas): 27 taps and 8;
* the current passes built with other brick shapes (``BRICKS``);
* K6's first pass (``lagomorph_ad_star_bwd_first``, batch-N momenta, as
  the step runs it), at 128^3 b4 and at 64^3 b4 (the whole-volume step's
  shape): the previous kernel (27 taps, one thread per voxel, nothing
  staged), the previous kernel on the 8 live taps, and the current one
  (planes staged along an x march, 8 live taps) without its prefetch and
  with it, at the march length it takes and at others (``MARCHES``);
* K2, the compose (``lagomorph_compose_fwd``, s = -0.2), at 128^3 b4 and
  at 64^3 b4: the previous kernel (27 taps, one thread per voxel, nothing
  staged), the previous kernel on the 8 live taps, and the current one
  (planes of phiinv staged along an x march, 8 live taps) without its
  prefetch and with it, at the march length it takes and at ``MARCHES``;
* K1, Ad* (``lagomorph_ad_star_fwd``, batch-N momenta, writing ``mw`` as
  the step calls it), at 128^3 b4 and at 64^3 b4: the previous kernel (27
  taps, one thread per voxel, nothing staged), the previous kernel on the
  8 live taps, and the current one (planes of m0 and phiinv staged along
  an x march, 8 live taps) without its prefetch and with it, at the march
  length it takes and at ``MARCHES``.

Each line gives ms per call (two samples of 20 calls, in turns), the byte
bound of the pass (``chip_smoke.pass_work``) and the largest difference of
each variant's output from the previous kernel's (of each output, for K6's
first pass: ``d_mw`` must be bit-equal and ``d_phiinv`` within 1e-5 * (1 +
max|ref|), or the script fails; K2's output, and K1's out and ``mw``, must
be bit-equal).  Needs a
CUDA card; imports no jax.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPE = (4, 3, 128, 128, 128)
REPS = 20


def ptxas(log, what, kernels=("warp", "transpose", "dd", "fwd", "ad_star")):
    """Print the registers and spills ptxas reports for each kernel whose
    name holds one of ``kernels``."""
    name = None
    for line in log.splitlines():
        if "entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and ("registers" in line or "spill" in line) and any(
                k in name for k in kernels):
            print(f"ptxas ({what}) {name[:60]}: {line.split(':', 1)[-1].strip()}", flush=True)


# other brick shapes (x, y) of the backward passes, beside the built-in 4 x 8 x 32
BRICKS = ((8, 8), (4, 16))
# K6's first pass, K2 and K1 at other march lengths
MARCHES = (8, 16, 32, 64, 128)


def build_variants():
    """The variant kernels as shared libraries (nvcc, the kernels' flags,
    in parallel): one with the library's brick and one per shape of
    ``BRICKS``, whose current passes are timed beside it.  Returns (the
    first library, {brick: library})."""
    from lagomorph_tpu_torch.ops.kernels import _build

    src = os.path.join(_build.CSRC, "profile", "warp_variants.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    defines = [[]] + [[f"-DLAGOMORPH_WARP_BRICK_X={bx}", f"-DLAGOMORPH_WARP_BRICK_Y={by}"]
                      for bx, by in BRICKS]
    sos = [os.path.join(_build.BUILD_DIR, f"libwarp_variants_{os.getpid()}_{k}.so")
           for k in range(len(defines))]
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *d, "-I", _build.CSRC,
                               "-shared", "-o", so, src], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for d, so in zip(defines, sos)]
    for d, p in zip(defines, procs):
        out = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for the variants {d}:\n{out}")
        if not d:
            ptxas(out, "variants")
    libs = [ctypes.CDLL(so) for so in sos]
    lib = libs[0]
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for other in libs[1:]:
        for name in ("lagomorph_warp_transpose", "lagomorph_warp_dd"):
            getattr(other, name).argtypes = _build.SIGNATURES[name]
    sig = {
        "prof_old_fwd": [P, P, P] + [I] * 6 + [P],
        "prof_old_transpose": [P, F, P, P] + [I] * 6 + [P],
        "prof_weights": [P, F, P, I, I, P],
        "prof_preweighted_transpose": [P, P, P] + [I] * 6 + [P],
        "prof_old_dd": [P, P, F, P, P] + [I] * 7 + [P],
        "prof_live_dd": [P, P, F, P, P] + [I] * 7 + [P],
        "prof_transpose_variant": [I, P, F, P, P] + [I] * 6 + [P],
        "prof_adstar_first": [I] + [P] * 6 + [I] * 5 + [P],
        "prof_compose_fwd": [I, P, P, F, P, P] + [I] * 4 + [P],
        "prof_ad_star_fwd": [I] + [P] * 5 + [I] * 5 + [P],
    }
    for name, argtypes in sig.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, dict(zip(BRICKS, libs[1:]))


def main():
    if not torch.cuda.is_available():
        print("profile_warp: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from lagomorph_tpu_torch.ops.kernels import _build, stream_of

    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    _build.library()
    ptxas(_build.build_log, "library")
    var, bricks = build_variants()
    N, _, X, Y, Z = SHAPE
    V = X * Y * Z
    rng = np.random.default_rng(21)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    phiinv = t(rng.uniform(-0.99, 0.99, SHAPE))
    v = t(rng.uniform(-4.9, 4.9, SHAPE))
    I1 = t(rng.standard_normal((1, 1, X, Y, Z)))
    g1 = t(rng.standard_normal((N, 1, X, Y, Z)))
    g3 = t(rng.standard_normal(SHAPE))
    m3 = t(rng.standard_normal(SHAPE))
    st = stream_of(phiinv)
    lib = _build.library()

    def run(fn, name, *args):
        err = getattr(fn, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def transpose_case(label, disp, s, cot, NI, C):
        out = torch.empty((NI, C, X, Y, Z), dtype=torch.float32, device=device)
        w9 = torch.empty((N, 9, X, Y, Z), dtype=torch.float32, device=device)
        dims = (N, NI, C, X, Y, Z)

        def weights():
            run(var, "prof_weights", disp.data_ptr(), s, w9.data_ptr(), N, V, st)

        weights()
        return (label, out, {
            "previous": lambda: run(var, "prof_old_transpose", disp.data_ptr(), s,
                                    cot.data_ptr(), out.data_ptr(), *dims, st),
            "previous, weights precomputed": lambda: run(
                var, "prof_preweighted_transpose", w9.data_ptr(), cot.data_ptr(),
                out.data_ptr(), *dims, st),
            "current": lambda: run(lib, "lagomorph_warp_transpose", disp.data_ptr(), s,
                                   cot.data_ptr(), out.data_ptr(), *dims, st),
            "current, staging alone": lambda: run(
                var, "prof_transpose_variant", 1, disp.data_ptr(), s, cot.data_ptr(),
                out.data_ptr(), *dims, st),
            "current, accumulation alone": lambda: run(
                var, "prof_transpose_variant", 2, disp.data_ptr(), s, cot.data_ptr(),
                out.data_ptr(), *dims, st),
            **{f"current, brick {bx}x{by}x32": (lambda b=b: run(
                b, "lagomorph_warp_transpose", disp.data_ptr(), s, cot.data_ptr(),
                out.data_ptr(), *dims, st)) for (bx, by), b in bricks.items()},
        }, chip_smoke.pass_work("transpose", N, NI, C, V), weights)

    def dd_case(label, I, disp, s, cot, NI, C, compose):
        out = torch.empty(SHAPE, dtype=torch.float32, device=device)
        args = (I.data_ptr(), disp.data_ptr(), s, cot.data_ptr(), out.data_ptr(),
                N, NI, C, X, Y, Z, compose, st)
        return (label, out, {
            "previous (27 taps)": lambda: run(var, "prof_old_dd", *args),
            "previous, 8 live taps": lambda: run(var, "prof_live_dd", *args),
            "current": lambda: run(lib, "lagomorph_warp_dd", *args),
            **{f"current, brick {bx}x{by}x32": (lambda b=b: run(b, "lagomorph_warp_dd", *args))
               for (bx, by), b in bricks.items()},
        }, chip_smoke.pass_work("dd", N, NI, C, V, compose=bool(compose)), None)

    def adstar_first_case(shape):
        from lagomorph_tpu_torch.ops.kernels import epdiff_unit

        n, _, x, y, z = shape
        phi_, m_, g_ = ((phiinv, m3, g3) if shape == SHAPE else
                        (t(rng.uniform(-0.99, 0.99, shape)), t(rng.standard_normal(shape)),
                         t(rng.standard_normal(shape))))
        _, _, mw = epdiff_unit._launch_ad_star(phi_, m_, want_mw=True)
        outs = (torch.empty(shape, dtype=torch.float32, device=device),
                torch.empty(shape, dtype=torch.float32, device=device))
        operands = (phi_, m_, g_, mw, *outs)  # the closures keep them alive

        def call(fn, name, *pre, march=None):
            tail = (n, n, x, y, z) + (() if march is None else (march,)) + (st,)
            return lambda: run(fn, name, *pre, *(a.data_ptr() for a in operands), *tail)
        return (f"K6 first pass (batch-N m0) at {x}^3 b{n}", outs, {
            "previous (27 taps)": call(var, "prof_adstar_first", 0),
            "previous, 8 live taps": call(var, "prof_adstar_first", 1),
            "current, no prefetch": call(var, "prof_adstar_first", 2),
            "current": call(lib, "lagomorph_ad_star_bwd_first", march=0),
            **{f"current, march {m}": call(lib, "lagomorph_ad_star_bwd_first", march=m)
               for m in MARCHES if m <= x},
        }, chip_smoke.pass_work("adstar_first", n, n, 3, x * y * z), None, (0.0, 1e-5))

    def compose_case(shape):
        n, _, x, y, z = shape
        phi_, v_ = ((phiinv, v) if shape == SHAPE else
                    (t(rng.uniform(-0.99, 0.99, shape)), t(rng.uniform(-4.9, 4.9, shape))))
        out = torch.empty(shape, dtype=torch.float32, device=device)
        flag = torch.ones((), dtype=torch.int32, device=device)
        operands = (phi_, v_, out, flag)  # the closures keep them alive

        def call(fn, name, *pre, march=None):
            tail = (n, x, y, z) + (() if march is None else (march,)) + (st,)
            return lambda: run(fn, name, *pre, *(a.data_ptr() for a in operands[:2]), -0.2,
                               *(a.data_ptr() for a in operands[2:]), *tail)
        return (f"K2 compose (s = -0.2) at {x}^3 b{n}", (out,), {
            "previous (27 taps)": call(var, "prof_compose_fwd", 0),
            "previous, 8 live taps": call(var, "prof_compose_fwd", 1),
            "current, no prefetch": call(var, "prof_compose_fwd", 2),
            "current": call(lib, "lagomorph_compose_fwd", march=0),
            **{f"current, march {m}": call(lib, "lagomorph_compose_fwd", march=m)
               for m in MARCHES if m <= x},
        }, chip_smoke.work("compose_fwd", n, x * y * z), None, (0.0,))

    def ad_star_case(shape):
        n, _, x, y, z = shape
        phi_, m_ = ((phiinv, m3) if shape == SHAPE else
                    (t(rng.uniform(-0.99, 0.99, shape)), t(rng.standard_normal(shape))))
        outs = (torch.empty(shape, dtype=torch.float32, device=device),
                torch.empty(shape, dtype=torch.float32, device=device))
        flag = torch.ones((), dtype=torch.int32, device=device)
        operands = (phi_, m_, *outs, flag)  # the closures keep them alive

        def call(fn, name, *pre, march=None):
            tail = (n, n, x, y, z) + (() if march is None else (march,)) + (st,)
            return lambda: run(fn, name, *pre, *(a.data_ptr() for a in operands), *tail)
        return (f"K1 Ad* (batch-N m0, writing mw) at {x}^3 b{n}", outs, {
            "previous (27 taps)": call(var, "prof_ad_star_fwd", 0),
            "previous, 8 live taps": call(var, "prof_ad_star_fwd", 1),
            "current, no prefetch": call(var, "prof_ad_star_fwd", 2),
            "current": call(lib, "lagomorph_ad_star_fwd", march=0),
            **{f"current, march {m}": call(lib, "lagomorph_ad_star_fwd", march=m)
               for m in MARCHES if m <= x},
        }, chip_smoke.work("ad_star_fwd", n, x * y * z), None, (0.0, 0.0))

    out = torch.empty((N, 1, X, Y, Z), dtype=torch.float32, device=device)
    fargs = (I1.data_ptr(), phiinv.data_ptr(), out.data_ptr(), N, 1, 1, X, Y, Z, st)
    cases = [
        transpose_case("transpose K5 (C=1, NI=1)", phiinv, 1.0, g1, 1, 1),
        transpose_case("transpose K7 (C=3, NI=N)", v, -0.2, g3, N, 3),
        dd_case("weight gradient K5 (C=1)", I1, phiinv, 1.0, g1, 1, 1, 0),
        dd_case("weight gradient K7 (C=3, compose)", phiinv, v, -0.2, g3, N, 3, 1),
        ("forward K4 (C=1, atlas)", out, {
            "previous (27 taps)": lambda: run(var, "prof_old_fwd", *fargs),
            "current (8 taps)": lambda: run(lib, "lagomorph_warp_unit_fwd", *fargs),
        }, chip_smoke.work("warp_unit_fwd", N, V), None),
        adstar_first_case(SHAPE),
        adstar_first_case((N, 3, 64, 64, 64)),
        compose_case(SHAPE),
        compose_case((N, 3, 64, 64, 64)),
        ad_star_case(SHAPE),
        ad_star_case((N, 3, 64, 64, 64)),
    ]

    ok = True
    for label, out, variants, work, extra, *tols in cases:
        outs = out if isinstance(out, tuple) else (out,)
        tols = tols[0] if tols else ()  # per output, of 1 + max|ref|; none: not checked
        b_ms, b_by = chip_smoke.bound(*work)
        names = list(variants)
        refs = None
        results = {}
        for name in names:  # agreement with the first variant, output by output
            variants[name]()
            torch.cuda.synchronize(device)
            if refs is None:
                refs = [o.clone() for o in outs]
            results[name] = [[chip_smoke.max_err(o, r) for o, r in zip(outs, refs)]]
        for name in names + names[::-1]:  # two samples each, in turns
            results[name].append(chip_smoke.time_ms(variants[name], device, REPS))
        at = "" if " at " in label else " at 128^3 b4"
        print(f"{label}{at}: bound {b_ms:.4f} ms ({b_by}) [{card}]", flush=True)
        for name in names:
            diffs, a, b = results[name]
            print(f"  {name:32s} {a:.4f} / {b:.4f} ms  ({(a + b) / 2 / b_ms:.1f}x bound; "
                  f"max diff from the first {', '.join(f'{d:.3e}' for d in diffs)})", flush=True)
            for tol, d, r in zip(tols, diffs, refs):
                if d > tol * (1.0 + float(r.abs().max())):
                    print(f"  {name}: differs from the first beyond {tol} * (1 + max|ref|)",
                          flush=True)
                    ok = False
        if extra is not None:
            ms = chip_smoke.time_ms(extra, device, REPS)
            print(f"  {'(the precomputation itself)':32s} {ms:.4f} ms", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
