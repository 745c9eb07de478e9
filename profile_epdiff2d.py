#!/usr/bin/env python3
"""K10-K13, the 2D per-substep kernels, on one CUDA card, beside their
previous kernels and variants.

    python3 profile_epdiff2d.py

Times each kernel by its device time per call (``torch.profiler``,
``chip_smoke.device_us``: at these sizes CUDA event times are set by the
host; each call's total, its flag's fill and conversion included, and the
kernel alone), at one substep of the ``beta = 0.05`` shooting at the 2D
atlas step's shapes, 256^2 b8 and 512^2 b8 (bench.py's momenta; the
operands of ``chip_smoke.timings2d``), batch-N momenta, and K12 with a
batch-1 ``m0`` at 256^2 b8.  The variants of
``csrc/profile/epdiff2d_variants.cu`` are built here with nvcc
(``csrc/epdiff2d.cu`` included).

* K10 (writing ``mw``, as under autograd) and K11: ``previous``, the
  kernels before their redesign (one thread a pixel over the 9 taps, the
  library's per-thread route, ``march`` -1); ``current``, the column strips
  at the chooser's strip width and band height (their grid logged);
  ``current without its prefetch``; ``one thread a pixel, 4 live taps``
  (int indices, no strips: the redesign's first form); ``march PX p RJ r``,
  the strips at every width p and band heights r (``BANDS``).  Then each
  wrapper's host time per call, previous and current in turns (enqueue of
  200 calls).
* K12: ``previous``, the kernel before its redesign (the per-thread route
  of the library's entry point, ``tile`` -1: two launches through a
  ``d_mw`` field); ``current``, the tile kernel at the height it chooses;
  ``current at tile T`` (``TILES``); its ``stage alone`` and its
  ``per-pixel part alone`` (the other part left out, outputs not K12's:
  they time the parts); ``128 registers`` / ``64 registers`` (compiled for
  2 or 4 blocks an SM in place of 3; at its height, at 2 and at 4 rows);
  ``without the weight gradient`` / ``without the divergence`` / ``without
  the gather``: its per-pixel part without one of its three terms, each
  timed by its absence (``terms: all three`` computes K12).
  With a batch-1 ``m0``: ``current`` (the per-thread route, which the
  library takes there) and ``tiles`` (the tile kernel writing its rows'
  ``d_mw``, then the same sum over the subjects).
* K13: ``current`` (one thread a pixel, unchanged by the redesign); and
  K9's phase 1 on K12's tiles, which the library does not take: ``tiles``
  at K12's height and at ``TILES``, its stage and per-pixel part alone,
  and at 128 and 64 registers.

The variants are timed in turns (two samples, the second in reverse
order), each beside the bound of its work (``chip_smoke.work``).  Every
variant that computes the kernel's function is held ``torch.equal`` to the
previous kernel (K10-K12) or the current one (K13), and those bit-equal to
the plain version (K10, K11, with the flag) or within 1e-5 * (1 +
max|ref|) of it (K12, K13), or the script exits 1.  ptxas's registers,
stack and spills of every K10-K13 kernel are logged.  Needs a CUDA card;
imports no jax.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# mask, minb, phiinv, m0, g, mw, dmw, d_phi, d_m0, N, Nm, H, W, tile, stream
PARTS12 = [_I, _I] + [_P] * 7 + [_I] * 5 + [_P]
# mask, minb, phiinv, v, s, g, d_phi, d_v, N, H, W, tile, stream
PARTS13 = [_I, _I, _P, _P, _F] + [_P] * 3 + [_I] * 4 + [_P]
# pix, phiinv, m0, g, mw, d_phi, d_m0, N, H, W, tile, stream
PIXEL12 = [_I] + [_P] * 6 + [_I] * 4 + [_P]
# form, px, rj, phiinv, m0, out, mw, flag, N, Nm, H, W, stream
FWD10 = [_I] * 3 + [_P] * 5 + [_I] * 4 + [_P]
# form, px, rj, phiinv, v, s, out, flag, N, H, W, stream
FWD11 = [_I] * 3 + [_P, _P, _F, _P, _P] + [_I] * 3 + [_P]
# K12's per-pixel terms (pixel12_kernel's bits: 1 the weight gradient, 2
# the divergence, 4 the gather transpose)
TERMS = {"terms: all three": 7, "without the weight gradient": 6,
         "without the divergence": 5, "without the gather": 3}
# the kernels' names in a trace, by key
KERNEL_NAME = {"ad_star2d_fwd": ("ad_star2d",), "compose2d_fwd": ("compose2d",),
               "ad_star2d_bwd": ("ad_star2d", "parts12", "pixel12"),
               "compose2d_bwd": ("compose2d", "parts13")}
# band heights of K10's and K11's march timed at each strip width
BANDS = (1, 2, 4, 8)
# other tile heights of the tile kernels, by H
TILES = {256: (2, 4, 6, 12, 16), 512: (1, 2, 8)}
# the variants of csrc/profile/epdiff2d_variants.cu: (mask, blocks an SM
# its registers are bounded for, tile height (0: K12's own)); mask 3
# computes the kernel's function
PARTS = {"stage alone": (1, 3, 0), "per-pixel part alone": (2, 3, 0),
         "128 registers": (3, 2, 0), "64 registers": (3, 4, 0),
         **{f"{r} registers at tile {t}": (3, b, t) for r, b in ((128, 2), (64, 4))
            for t in (2, 4)}}


def build():
    """epdiff2d_variants.cu as a loaded library, ptxas's lines of its K12
    and K13 kernels printed."""
    from lagomorph_tpu_torch.ops.kernels import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.CSRC, "profile", "epdiff2d_variants.cu")
    so = os.path.join(_build.BUILD_DIR, f"libepdiff2d_variants_{os.getpid()}.so")
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-shared",
                        "-o", so, src], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for epdiff2d_variants.cu:\n{p.stdout}{p.stderr}")
    kernel, spills = None, ""
    for line in (p.stdout + p.stderr).splitlines():
        if "entry function" in line:
            kernel = line.split("'")[1] if "'" in line else None
        elif kernel and "spill stores" in line:
            spills = line.split(":", 1)[-1].strip()
        elif kernel and "registers" in line and any(
                k in kernel for k in ("2d_bwd", "parts1", "2d_fwd", "march", "cheap")):
            regs = line.split("Used", 1)[-1].strip()
            print(f"ptxas {kernel}: {regs}, {spills}", flush=True)
    return load(so)


def load(so):
    lib = ctypes.CDLL(so)
    for name, types in (("prof_epdiff2d_parts12", PARTS12), ("prof_epdiff2d_parts13", PARTS13),
                        ("prof_epdiff2d_pixel12", PIXEL12), ("prof_ad_star2d_fwd", FWD10),
                        ("prof_compose2d_fwd", FWD11)):
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib


def operands(device, shape):
    """The ``beta = 0.05`` shooting's second substep at ``shape``, as
    ``chip_smoke.timings2d`` takes it: phiinv, m, v, mw and a cotangent."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import lagomorph_tpu_torch as lt
    from lagomorph_tpu_torch.ops.kernels import epdiff2d

    m = cs.bench_inputs(device, shape)[1]
    g = torch.as_tensor(np.random.default_rng(8).standard_normal(shape), dtype=torch.float32,
                        device=device)
    v0 = lt.FluidMetric(cs.PARAMS_BETA).sharp(m)
    phi1 = -1.0 / cs.STEPS * v0
    mw = epdiff2d.ad_star2d_plain(phi1, m, want_mw=True)[2]
    return phi1, m, v0, mw, g


def fwd10(lib, args, phi, m0, want_mw, stream):
    """K10's form ``args`` (form, px, rj: ``prof_ad_star2d_fwd``): ``(out,
    flag)``, and ``mw`` third when ``want_mw``."""
    N, _, H, W = phi.shape
    out = torch.empty_like(phi)
    mw = torch.empty_like(phi) if want_mw else None
    flag = torch.ones((), dtype=torch.int32, device=phi.device)
    err = lib.prof_ad_star2d_fwd(*args, phi.data_ptr(), m0.data_ptr(), out.data_ptr(),
                                 None if mw is None else mw.data_ptr(), flag.data_ptr(), N,
                                 m0.shape[0], H, W, stream)
    if err:
        raise RuntimeError(f"K10 form {args}: error {err}")
    return (out, flag.bool(), mw) if want_mw else (out, flag.bool())


def fwd11(lib, args, phi, v, s, stream):
    """K11's form ``args`` (``prof_compose2d_fwd``): ``(out, flag)``."""
    N, _, H, W = phi.shape
    out = torch.empty_like(phi)
    flag = torch.ones((), dtype=torch.int32, device=phi.device)
    err = lib.prof_compose2d_fwd(*args, phi.data_ptr(), v.data_ptr(), s, out.data_ptr(),
                                 flag.data_ptr(), N, H, W, stream)
    if err:
        raise RuntimeError(f"K11 form {args}: error {err}")
    return out, flag.bool()


def parts12(lib, args, phi, m0, g, mw, stream):
    """K12's variant ``args`` (mask, minb, tile): ``(d_phiinv, d_m0)``."""
    N, _, H, W = phi.shape
    d_phi, d_m0 = torch.empty_like(phi), torch.empty_like(m0)
    dmw = torch.empty_like(phi) if m0.shape[0] != N else None
    err = lib.prof_epdiff2d_parts12(*args[:2], phi.data_ptr(), m0.data_ptr(), g.data_ptr(),
                                    mw.data_ptr(), None if dmw is None else dmw.data_ptr(),
                                    d_phi.data_ptr(), d_m0.data_ptr(), N, m0.shape[0], H, W,
                                    args[2], stream)
    if err:
        raise RuntimeError(f"K12 variant {args}: error {err}")
    return d_phi, d_m0


def pixel12(lib, pix, phi, m0, g, mw, stream):
    """K12's per-pixel terms ``pix`` on its tiles: ``(d_phiinv, d_m0)``."""
    N, _, H, W = phi.shape
    d_phi, d_m0 = torch.empty_like(phi), torch.empty_like(m0)
    err = lib.prof_epdiff2d_pixel12(pix, phi.data_ptr(), m0.data_ptr(), g.data_ptr(),
                                    mw.data_ptr(), d_phi.data_ptr(), d_m0.data_ptr(), N, H, W, 0,
                                    stream)
    if err:
        raise RuntimeError(f"K12 terms {pix}: error {err}")
    return d_phi, d_m0


def parts13(lib, args, phi, v, s, g, stream):
    """K13's variant ``args`` (mask, minb, tile): ``(d_phiinv, d_v)``."""
    N, _, H, W = phi.shape
    d_phi, d_v = torch.empty_like(phi), torch.empty_like(v)
    err = lib.prof_epdiff2d_parts13(*args[:2], phi.data_ptr(), v.data_ptr(), s, g.data_ptr(),
                                    d_phi.data_ptr(), d_v.data_ptr(), N, H, W, args[2], stream)
    if err:
        raise RuntimeError(f"K13 variant {args}: error {err}")
    return d_phi, d_v


def host_us(device, fn, n=200):
    """Host microseconds per call of ``fn``: ``n`` calls enqueued back to
    back after a warm-up (the device, faster per call, keeps up)."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (t1 - t0) / n * 1e6


def run(lib, device, card, shapes, reps=10):
    """Time K12's and K13's variants at each shape; returns {(shape, kernel,
    variant): [us, us]}."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from lagomorph_tpu_torch.ops.kernels import _build, epdiff2d

    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else None
    s = -1.0 / cs.STEPS
    out = {}

    def timed(name, key, shape, tag, fns, ref, same):
        """Hold the variants in ``same`` bit-equal to ``same[0]`` and that
        within 1e-5 * (1 + max|ref|) of ``ref`` (a forward: bit-equal to
        it, flags equal); time every variant."""
        N, _, H, W = shape
        base = fns[same[0]]()
        for k in same[1:]:
            cs.check(all(torch.equal(a, b) for a, b in zip(fns[k](), base)),
                     f"{name} ({k}) at {tag}: not bit-equal to {same[0]}")
        errs = []
        if key.endswith("_fwd"):
            cs.check(all(torch.equal(a, b) for a, b in zip(base, ref)),
                     f"{name} at {tag}: not bit-equal to the plain version")
            errs.append("bit-equal, flag equal")
        else:
            for what, a, b in zip(("d_phiinv", "d_m0" if key == "ad_star2d_bwd" else "d_v"),
                                  base, ref):
                err = cs.max_err(a, b)
                lim = 1e-5 * (1.0 + float(b.double().abs().max()))
                cs.check(err <= lim, f"{name} {what} at {tag}: {err:.3e} > {lim:.3e}")
                errs.append(f"{what} {err:.3e} (limit {lim:.3e})")
        print(f"{name} at {tag}: {len(same) - 1} variants bit-equal to {same[0]}; against the "
              f"plain version {', '.join(errs)}", flush=True)
        us = {k: [] for k in fns}
        own = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                total, _, by_name = cs.device_us(device, fns[k], reps)
                us[k].append(total)
                own[k].append(sum(t for n, t in by_name.items()
                                  if any(x in n for x in KERNEL_NAME[key])))
        b_ms, b_by = cs.bound(*cs.work(key, N, H * W))
        for k in fns:
            out[(shape, name, k)] = us[k]
            print(f"{name} {k} at {tag}: device {us[k][0]:.2f}/{us[k][1]:.2f} us per call "
                  f"(the kernel alone {own[k][0]:.2f}/{own[k][1]:.2f}), bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}), {us[k][0] / (b_ms * 1e3):.2f}x [{card}]",
                  flush=True)

    def forwards(shape, tag, phi, m, v):
        """K10 (writing ``mw``, as under autograd) and K11 (s = -1/STEPS)
        in their forms, each bit-equal to the previous kernel and the plain
        version."""
        def entry(key, march):
            """A call of K10's (writing ``mw``) or K11's C entry point on
            outputs made once."""
            N, _, H, W = phi.shape
            out, mw = torch.empty_like(phi), torch.empty_like(phi)
            flag = torch.ones((), dtype=torch.int32, device=device)
            if key == "ad_star2d_fwd":
                args = ("lagomorph_ad_star2d_fwd", phi.data_ptr(), m.data_ptr(), out.data_ptr(),
                        mw.data_ptr(), flag.data_ptr(), N, N, H, W, march, stream)
            else:
                args = ("lagomorph_compose2d_fwd", phi.data_ptr(), v.data_ptr(), s, out.data_ptr(),
                        flag.data_ptr(), N, H, W, march, stream)
            return lambda keep=(out, mw, flag): _build.call(*args)

        N, _, H, W = shape
        cfg = {k: epdiff2d.fwd_launch_config(k, N, H, W) for k in KERNEL_NAME if k.endswith("fwd")}
        for k, c in cfg.items():
            print(f"grid at {tag}: {k} on strips of {c['px']} columns, bands of {c['rj']} rows, "
                  f"{c['blocks']} blocks of {c['threads']} ({c['per_sm']} an SM) [{card}]",
                  flush=True)
        forms = {"previous": None, "current": None, "one thread a pixel, 4 live taps": (0, 1, 1),
                 **{f"march PX {px} RJ {rj}": (1, px, rj) for px in (1, 2, 4)
                    for rj in BANDS}}
        for key, name, launch, prof, plain in (
                ("ad_star2d_fwd", "K10",
                 lambda march: epdiff2d._launch_ad_star(phi, m, want_mw=True, march=march),
                 lambda a: fwd10(lib, a, phi, m, True, stream),
                 lambda: epdiff2d.ad_star2d_plain(phi, m, want_mw=True)),
                ("compose2d_fwd", "K11", lambda march: epdiff2d._launch_compose(phi, v, s, march),
                 lambda a: fwd11(lib, a, phi, v, s, stream),
                 lambda: epdiff2d.compose2d_plain(phi, v, s))):
            c = cfg[key]
            fns = {"previous": lambda launch=launch: launch(epdiff2d.THREAD),
                   "current": lambda launch=launch: launch(0),
                   "current without its prefetch":
                       lambda prof=prof, c=c: prof((2, c["px"], c["rj"])),
                   **{f: lambda prof=prof, a=a: prof(a) for f, a in forms.items() if a}}
            timed(name, key, shape, tag, fns, plain(), list(fns))
            calls = {"previous": fns["previous"], "current": fns["current"],
                     "previous, entry point alone": entry(key, epdiff2d.THREAD),
                     "current, entry point alone": entry(key, 0)}
            host = {k: [] for k in calls}
            for order in (list(calls), list(calls)[::-1]):
                for k in order:
                    host[k].append(host_us(device, calls[k]))
            print(f"{name} at {tag}: host us per call (enqueue; the wrapper, or its C entry point "
                  f"alone on tensors made once): "
                  f"{', '.join(f'{k} {u[0]:.2f}/{u[1]:.2f}' for k, u in host.items())} [{card}]",
                  flush=True)

    for shape in shapes:
        N, _, H, W = shape
        phi, m, v, mw, g = operands(device, shape)
        tag = f"{H}^2 b{N}" if H == W else "x".join(map(str, shape))
        forwards(shape, tag, phi, m, v)
        own = epdiff2d.bwd_launch_config(N, H, W)
        print(f"grid at {tag}: K12 on {own['tile']}-row tiles, {own['blocks']} blocks of "
              f"{own['threads']}, {own['smem']} B of shared memory (K13's tiles: half) [{card}]",
              flush=True)
        tiles = [t for t in TILES[H] if t != own["tile"]]
        for t in tiles:
            c = epdiff2d.bwd_launch_config(N, H, W, t)
            print(f"grid at {tag}: tile {t}: {c['blocks']} blocks, {c['smem']} B", flush=True)
        computes = [k for k, a in PARTS.items() if a[0] == 3]

        fns = {"previous": lambda: epdiff2d._launch_ad_star_bwd(phi, m, g, mw, epdiff2d.THREAD),
               "current": lambda: epdiff2d._launch_ad_star_bwd(phi, m, g, mw),
               **{f"current at tile {t}": lambda t=t: epdiff2d._launch_ad_star_bwd(phi, m, g, mw,
                                                                                   t)
                  for t in tiles},
               **{k: lambda a=a: parts12(lib, a, phi, m, g, mw, stream)
                  for k, a in PARTS.items()},
               **{k: lambda pix=pix: pixel12(lib, pix, phi, m, g, mw, stream)
                  for k, pix in TERMS.items()}}
        timed("K12", "ad_star2d_bwd", shape, tag, fns, epdiff2d.ad_star2d_bwd_plain(phi, m, g, mw),
              ["previous", "current", *(f"current at tile {t}" for t in tiles), *computes,
               "terms: all three"])

        tile_parts = {f"tiles, {k}" if a[0] == 3 else k: a for k, a in PARTS.items()}
        fns = {"current": lambda: epdiff2d._launch_compose_bwd(phi, v, s, g),
               "tiles": lambda: parts13(lib, (3, 3, 0), phi, v, s, g, stream),
               **{f"tiles at tile {t}": lambda t=t: parts13(lib, (3, 3, t), phi, v, s, g, stream)
                  for t in tiles},
               **{k: lambda a=a: parts13(lib, a, phi, v, s, g, stream)
                  for k, a in tile_parts.items()}}
        timed("K13", "compose2d_bwd", shape, tag, fns, epdiff2d.compose2d_bwd_plain(phi, v, s, g),
              ["current", "tiles", *(f"tiles at tile {t}" for t in tiles),
               *(k for k, a in tile_parts.items() if a[0] == 3)])

        if H == 256:
            m1 = m[:1].contiguous()
            mw1 = epdiff2d.ad_star2d_plain(phi, m1, want_mw=True)[2]
            fns = {"current": lambda: epdiff2d._launch_ad_star_bwd(phi, m1, g, mw1),
                   "tiles": lambda: parts12(lib, (3, 3, 0), phi, m1, g, mw1, stream)}
            timed("K12 m0(1,2)", "ad_star2d_bwd", shape, tag, fns,
                  epdiff2d.ad_star2d_bwd_plain(phi, m1, g, mw1), ["current", "tiles"])
        del phi, m, v, mw, g
    return out


def main():
    if not torch.cuda.is_available():
        print("profile_epdiff2d: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    run(build(), device, card, (cs.FULL2D, cs.FULL2D_512))
    print("profile_epdiff2d: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
