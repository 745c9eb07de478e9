#!/usr/bin/env python3
"""K14's memory layouts on one CUDA card, beside variants.

    python3 profile_radix.py

K14 (``lagomorph_tpu_torch/csrc/fft_radix.cu``) writes its spectrum in
bit-reversed order.  On the plane path the z frequencies are permuted at
the transpose through shared memory, at swizzled slots (``plane_slot``,
``csrc/fft_plane.cuh``); on the line path the z rows' spectrum moves
through the line's exchange slots, so the lanes load and store
neighbouring words (``reg_pass``).  ``csrc/profile/radix_variants.cu``
(built here with nvcc, with ``fft_radix.cu`` included) computes K14 with
the plain slots (the plane path) and with element-wise z rows (the line
path).  The script prints ptxas's registers and spills for both, checks
that each variant's spectra are bit-equal to K14's (a layout moves no
arithmetic), and times K14 forward and inverse beside the variant: the
plane path at 128^3 b4 and 64^3 b4, the line path at 256^3 b1 and
(3, 3, 32, 64, 128).  Times are CUDA events around 20 calls in turns
(kernel, variant, variant, kernel), then ``torch.profiler`` device time
per call, beside the byte bound (``chip_smoke.work``).  Needs a CUDA card;
imports no jax.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WIDE = (1, 3, 256, 256, 256)  # 256^3 b1: K14's line path on 256^2 planes


def build():
    """radix_variants.cu as a loaded library, its ptxas lines printed."""
    from lagomorph_tpu_torch.ops.kernels import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.CSRC, "profile", "radix_variants.cu")
    so = os.path.join(_build.BUILD_DIR, f"libradix_variants_{os.getpid()}.so")
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-shared",
                        "-o", so, src], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for radix_variants.cu:\n{p.stdout}{p.stderr}")
    kernel = None
    for line in (p.stdout + p.stderr).splitlines():
        if "entry function" in line:
            kernel = line.split("'")[1] if "'" in line else None
        elif kernel and ("plane_kernel" in kernel or "row_kernel" in kernel
                         or "radix_reg_kernel" in kernel) and ("registers" in line
                                                              or "spill" in line):
            print(f"ptxas {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)
    lib = ctypes.CDLL(so)
    for name in ("lagomorph_fluid_radix_zy", "prof_radix_zy_variant"):
        getattr(lib, name).argtypes = _build.SIGNATURES["lagomorph_fluid_radix_zy"]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        print("profile_radix: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    lib = build()
    stream = torch.cuda.current_stream(device).cuda_stream
    names = {"kernel": "lagomorph_fluid_radix_zy"}
    rng = np.random.default_rng(21)
    for shape, variant in ((cs.FULL, "plain slots"), (cs.FULL64, "plain slots"),
                           (WIDE, "element-wise rows"), (cs.RADIX_ODD, "element-wise rows")):
        names[variant] = "prof_radix_zy_variant"
        N, _, X, Y, Z = shape
        F = (N * 3 + 1) // 2
        x = torch.as_tensor(rng.standard_normal((2 * F, X, Y, Z)), dtype=torch.float32,
                            device=device)

        def k14(name, src, inverse):
            y = torch.empty_like(src)
            err = getattr(lib, names[name])(src[:F].data_ptr(), src[F:].data_ptr(),
                                            y[:F].data_ptr(), y[F:].data_ptr(), F, X, Y, Z,
                                            int(inverse), stream)
            if err:
                raise RuntimeError(f"K14 ({name}) launch failed: error {err}")
            return y

        spec = k14("kernel", x, False)
        cs.check(torch.equal(spec, k14(variant, x, False))
                 and torch.equal(k14("kernel", spec, True), k14(variant, spec, True)),
                 f"{variant} differs from the kernel at {shape}")
        b_ms, b_by = cs.bound(*cs.work("fluid_radix_zy", N, X * Y * Z, F=F, axes=(X, Y, Z)))
        for label, src, inverse in (("forward", x, False), ("inverse", spec, True)):
            fns = {name: (lambda name=name: k14(name, src, inverse))
                   for name in ("kernel", variant)}
            ms = {name: [] for name in fns}
            for name in ("kernel", variant, variant, "kernel"):
                ms[name].append(cs.time_ms(fns[name], device, 20))
            for name, fn in fns.items():
                us = cs.device_us(device, fn)[0]
                print(f"K14 {label} {name}: {ms[name][0]:.4f}/{ms[name][1]:.4f} ms by events, "
                      f"{us:.2f} us device per call, bound {b_ms:.4f} ms ({b_by}) at "
                      f"{X}x{Y}x{Z} b{N} [{card}]", flush=True)
        del x, spec
    print("profile_radix: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
