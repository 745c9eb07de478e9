#!/usr/bin/env python3
"""Profile of the unit-regime warp's passes on one CUDA card, by variants.

    python3 profile_warp.py

Nsight Compute does not run on the card's machine, so each cost of the
warp kernels before their redesign is isolated by a variant kernel
(``lagomorph_tpu_torch/csrc/profile/warp_variants.cu``, built here with
nvcc) and timed with CUDA events beside the previous kernel and the
current one (``csrc/warp_unit.cu``), at the operand shapes of the 3D atlas
step at 128^3 b4:

* the warp backward's pass (``lagomorph_warp_dd``: the transpose and the
  weight gradient, as K5 and K7 run it; ``lagomorph_warp_transpose``: the
  transpose alone, as K6 runs it) at the shapes of K5 (C = 1, the batch-1
  atlas summed over the subjects), K6 (C = 3, NI = N) and K7 (C = 3, NI =
  N, s = -0.2, the compose epilogue), at b4 and at b50 (the atlas cell's
  minibatch), beside the two passes it replaced (``csrc/profile/
  warp_variants.cu``: the transpose, then the weight gradient) and with
  each of its load paths forced (TMA, which the launcher takes at these
  shapes, and ``cp.async``, which it takes where TMA cannot);
* the forward K4 (C = 1, the atlas): 27 taps and 8;
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
bound of the work (``chip_smoke.pass_work``, ``chip_smoke.work``) and the
largest difference of each variant's output from the previous kernel's (of
each output: the pass's within 1e-5 * (1 + max|ref|) of the previous
passes', K6's first pass's ``d_mw`` bit-equal and ``d_phiinv`` within 1e-5
* (1 + max|ref|), K2's output and K1's out and ``mw`` bit-equal, or the
script fails).  Needs a CUDA card; imports no jax.
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


# the atlas cell's minibatch, beside SHAPE's b4
BATCH = 50
# the pass's load paths (csrc/warp_unit.cu launch_warp_bwd_path), forced
PATHS = ((1, "TMA"), (0, "cp.async"))
# K6's first pass, K2 and K1 at other march lengths
MARCHES = (8, 16, 32, 64, 128)


def build_variants():
    """The variant kernels as a shared library (nvcc, the kernels' flags)."""
    from lagomorph_tpu_torch.ops.kernels import _build

    src = os.path.join(_build.CSRC, "profile", "warp_variants.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, f"libwarp_variants_{os.getpid()}.so")
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-shared", "-o",
                        so, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for the variants:\n{p.stdout}")
    ptxas(p.stdout, "variants")
    lib = ctypes.CDLL(so)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sig = {
        "prof_old_fwd": [P, P, P] + [I] * 6 + [P],
        "prof_prev_transpose": [P, F, P, P] + [I] * 6 + [P],
        "prof_prev_dd": [P, P, F, P, P] + [I] * 7 + [P],
        "prof_pass": [I, P, P, F, P, P, P] + [I] * 7 + [P],
        "prof_adstar_first": [I] + [P] * 6 + [I] * 5 + [P],
        "prof_compose_fwd": [I, P, P, F, P, P] + [I] * 4 + [P],
        "prof_ad_star_fwd": [I] + [P] * 5 + [I] * 5 + [P],
    }
    for name, argtypes in sig.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


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
    var = build_variants()
    N, _, X, Y, Z = SHAPE
    V = X * Y * Z
    rng = np.random.default_rng(21)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    big = (BATCH,) + SHAPE[1:]  # the b4 operands are their first N subjects
    phi50 = t(rng.uniform(-0.99, 0.99, big))
    v50 = t(rng.uniform(-4.9, 4.9, big))
    g1_50 = t(rng.standard_normal((BATCH, 1, X, Y, Z)))
    g3_50 = t(rng.standard_normal(big))
    phiinv, v, g1, g3 = phi50[:N], v50[:N], g1_50[:N], g3_50[:N]
    I1 = t(rng.standard_normal((1, 1, X, Y, Z)))
    m3 = t(rng.standard_normal(SHAPE))
    st = stream_of(phiinv)
    lib = _build.library()

    def run(fn, name, *args):
        err = getattr(fn, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def pass_case(label, I, disp, s, cot, NI, C, compose):
        """The pass with the weight gradient beside the two previous passes."""
        n = disp.shape[0]
        outs = (torch.empty((NI, C, X, Y, Z), dtype=torch.float32, device=device),
                torch.empty_like(disp))
        ptr = (I.data_ptr(), disp.data_ptr(), s, cot.data_ptr())
        dims = (n, NI, C, X, Y, Z)

        def previous():
            run(var, "prof_prev_transpose", *ptr[1:], outs[0].data_ptr(), *dims, st)
            run(var, "prof_prev_dd", *ptr, outs[1].data_ptr(), *dims, int(compose), st)

        def forced(path):
            return lambda: run(var, "prof_pass", path, *ptr, outs[0].data_ptr(),
                               outs[1].data_ptr(), *dims, int(compose), st)
        return (f"{label} at 128^3 b{n}", outs, {
            "previous (transpose, weight gradient)": previous,
            "current": lambda: run(lib, "lagomorph_warp_dd", *ptr, outs[0].data_ptr(),
                                   outs[1].data_ptr(), *dims, int(compose), st),
            **{f"current, {name}": forced(path) for path, name in PATHS},
        }, chip_smoke.pass_work("pass", n, NI, C, V, compose), None, (1e-5, 1e-5))

    def transpose_case(label, disp, s, cot, NI, C):
        """The transpose alone beside the previous transpose."""
        n = disp.shape[0]
        out = torch.empty((NI, C, X, Y, Z), dtype=torch.float32, device=device)
        args = (disp.data_ptr(), s, cot.data_ptr(), out.data_ptr(), n, NI, C, X, Y, Z, st)

        def forced(path):  # prof_pass: no image, no weight gradient's output, compose 0
            return lambda: run(var, "prof_pass", path, None, *args[:4], None, *args[4:-1], 0,
                               args[-1])
        return (f"{label} at 128^3 b{n}", (out,), {
            "previous": lambda: run(var, "prof_prev_transpose", *args),
            "current": lambda: run(lib, "lagomorph_warp_transpose", *args),
            **{f"current, {name}": forced(path) for path, name in PATHS},
        }, chip_smoke.pass_work("transpose", n, NI, C, V), None, (1e-5,))

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
    cases = [case for b in (N, BATCH) for case in (
        pass_case("pass K5 (C=1, NI=1, weight gradient)", I1, phi50[:b], 1.0, g1_50[:b], 1, 1,
                  False),
        transpose_case("pass K6 (C=3, NI=N, transpose alone)", phi50[:b], 1.0, g3_50[:b], b, 3),
        pass_case("pass K7 (C=3, NI=N, s=-0.2, compose)", phi50[:b], v50[:b], -0.2, g3_50[:b], b,
                  3, True))] + [
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
