#!/usr/bin/env python3
"""K9, the 2D whole-shoot backward, on one CUDA card, beside variants.

    python3 profile_shoot2d.py

Nsight Compute does not run on the card's machine, so the cost of K9
before its redesign is split, and the current kernel's parts are
isolated, by variant kernels (``lagomorph_tpu_torch/csrc/profile/
shoot2d_variants.cu``, built here with nvcc, ``csrc/shoot2d.cu`` included)
timed with CUDA events beside the current kernel, at the 2D atlas step's
shapes, 256^2 b8 and 512^2 b8, T = 4 substeps, batch-N momenta (bench.py's
inputs, the stash from K8):

* ``previous``: K9 before its redesign (four phases and four grid barriers
  a reverse step, K8's radix-2 tile transforms, one thread a pixel in the
  last phase, dm and d_mw through fields);
* ``previous, barriers only``: its launch with the phase bodies emptied;
* ``previous on 128 blocks``: it on a grid of 128 blocks;
* ``current, tile transforms``: the current kernel on its tile path
  (K8's tile transforms; 256^2 only, where the register path applies);
* ``current, phases 3 and 4 apart``: the current kernel with dm and d_mw
  through fields and a fourth barrier, each tile staging them with its
  halo;
* ``current``: the current kernel (``lagomorph_shoot2d_bwd``);
* ``current at tile T``: the current kernel at other tile heights
  (``TILES``, through ``lagomorph_shoot2d_bwd``'s ``tile``);
* on the register path, the current kernel with each part of its phases
  left out in turn (``PARTS``: phase 1's stencil or row transform, phase
  2, phase 3's row transform or stencils; all of them, leaving the
  barriers), whose output is not K9's: the time each part takes.

Each line gives ms per call (two samples of 20 calls, in turns), the bound
(``chip_smoke.work("shoot2d_bwd", ...)``) and each output's largest
difference from ``shoot2d_bwd_plain`` on the same inputs, which must lie
within 1e-4 * max|ref| or the script exits 1; the grid and the tiles of
each phase are logged, and ptxas's registers and spills of each kernel.
Needs a CUDA card; imports no jax.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# barriers, m0, g, Mn, traj_p, traj_v, traj_mw, d_m0, d_phi0, cbuf, dm, dmw,
# gbuf, N, Nm, H, W, T, s, max_blocks, stream
PREV = [_I] + [_P] * 12 + [_I] * 5 + [_F, _I, _P]
# reg, unmerged, m0, g, Mn, traj_p, traj_v, traj_mw, d_m0, d_phi0, cbuf, dm,
# dmw, gbuf, N, Nm, H, W, T, s, out, stream
CURRENT = [_I, _I] + [_P] * 12 + [_I] * 5 + [_F, _P, _P]
VARIANTS = ("previous", "previous, barriers only", "previous on 128 blocks",
            "current, tile transforms", "current, phases 3 and 4 apart", "current")
# other tile heights of the current kernel, by path
TILES = {"register": (4, 6, 12, 14), "tile": (8,)}
# the parts of the current kernel's phases (parts_kernel's mask bits)
PARTS = {"phase 1's stencil": 1, "phase 1's row transform": 2, "phase 2": 4,
         "phase 3's row transform": 8, "phase 3's stencils": 16}


def build():
    """shoot2d_variants.cu as a loaded library, ptxas's lines of its K9
    kernels printed."""
    from lagomorph_tpu_torch.ops.kernels import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.CSRC, "profile", "shoot2d_variants.cu")
    so = os.path.join(_build.BUILD_DIR, f"libshoot2d_variants_{os.getpid()}.so")
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-shared",
                        "-o", so, src], capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed for shoot2d_variants.cu:\n{p.stdout}{p.stderr}")
    kernel = None
    for line in (p.stdout + p.stderr).splitlines():
        if "entry function" in line:
            kernel = line.split("'")[1] if "'" in line else None
        elif kernel and ("bwd" in kernel or "unmerged" in kernel) and (
                "registers" in line or "spill" in line):
            print(f"ptxas {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)
    return load(so)


def load(so):
    lib = ctypes.CDLL(so)
    for name, types in (("prof_shoot2d_bwd_prev", PREV), ("prof_shoot2d_bwd", CURRENT),
                        ("prof_shoot2d_bwd_prev_grid", [_I, _I, _I, _P]),
                        ("prof_shoot2d_bwd_parts", [_I] + [_P] * 10 + [_I, _I, _F, _P])):
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib


def run(lib, device, card, shapes, reps=20):
    """Time the variants at each shape; returns {(shape, variant): ms}."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import lagomorph_tpu_torch as lt
    from lagomorph_tpu_torch.ops.kernels import shoot2d

    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else None
    out = {}
    for shape in shapes:
        N, _, H, W = shape
        metric = lt.FluidMetric(cs.PARAMS)
        Mn = metric.packed_multiplier((H, W), torch.float32, device)
        _, m, _ = cs.bench_inputs(device, shape)
        s, T = -1.0 / cs.STEPS, cs.STEPS - 1
        traj = shoot2d._launch_fwd(s * metric.sharp(m), m, Mn, s, T, True)[2:]
        g = torch.as_tensor(np.random.default_rng(8).standard_normal(shape), dtype=torch.float32,
                            device=device)
        ref = shoot2d.shoot2d_bwd_plain(m, g, *traj, Mn, s)
        cbuf = torch.empty((N, H, W, 2), dtype=torch.float32, device=device)
        dm, dmw = torch.empty_like(g), torch.empty_like(g)
        gbuf = torch.empty((2,) + shape, dtype=torch.float32, device=device)
        ptrs = [x.data_ptr() for x in (m, g, Mn, *traj)]
        tag = f"{H}^2 b{N}" if H == W else "x".join(map(str, shape))

        def call(variant, cfg=None):
            d_phi0, d_m0 = torch.empty_like(g), torch.empty_like(m)
            tail = [d_m0.data_ptr(), d_phi0.data_ptr(), cbuf.data_ptr(), dm.data_ptr(),
                    dmw.data_ptr(), gbuf.data_ptr(), N, N, H, W, T, s]
            if variant.startswith("previous"):
                err = lib.prof_shoot2d_bwd_prev(int("barriers" in variant), *ptrs, *tail,
                                                128 if "128" in variant else 0, stream)
            else:
                reg = 0 if "tile" in variant else -1
                err = lib.prof_shoot2d_bwd(reg, int("apart" in variant), *ptrs, *tail,
                                           None if cfg is None else ctypes.cast(cfg, _P), stream)
            if err:
                raise RuntimeError(f"K9 ({variant}) at {tag}: error {err}")
            return d_phi0, d_m0

        def hold(variant, got):
            errs = []
            for what, a, b in zip(("d_phiinv0", "d_m0"), got, ref):
                err = float((a.double() - b.double()).abs().max())
                lim = 1e-4 * float(b.double().abs().max())
                cs.check(err <= lim, f"K9 ({variant}) {what} at {tag}: {err:.3e} > {lim:.3e}")
                errs.append(f"{what} {err:.3e} (limit {lim:.3e})")
            print(f"K9 {variant} at {tag}: against shoot2d_bwd_plain: {', '.join(errs)}",
                  flush=True)

        prev = (ctypes.c_int * 3)()
        cs.check(lib.prof_shoot2d_bwd_prev_grid(N, H, W, ctypes.cast(prev, _P)) == 0,
                 "previous K9's grid")
        print(f"grid at {tag}: previous {prev[0]} blocks of 256, {prev[1]} lines a tile, "
              f"{prev[2]} tiles in each row and column phase [{card}]", flush=True)
        fns = {}
        on_reg = shoot2d.bwd_launch_config(N, H, W)["path"] == "register"
        for variant in VARIANTS:
            if variant == "current, tile transforms" and not on_reg:
                print(f"K9 {variant} at {tag}: n/a (the current kernel takes the tile path)",
                      flush=True)
                continue
            if not variant.startswith("previous"):
                cfg = (ctypes.c_int * 8)()
                call(variant, cfg)
                print(f"grid at {tag}: {variant}: {'register' if cfg[0] else 'tile'} path, "
                      f"tile {cfg[1]} lines, {cfg[2]} blocks of {cfg[3]}, {cfg[4]} B shared, "
                      f"tiles of phases 1-3 {cfg[5]}, {cfg[6]}, {cfg[7]} [{card}]", flush=True)
            if "barriers" not in variant:
                hold(variant, call(variant))
            fns[variant] = lambda variant=variant: call(variant)
        for tile in TILES["register" if on_reg else "tile"]:
            c = shoot2d.bwd_launch_config(N, H, W, tile)
            print(f"grid at {tag}: current at tile {tile}: {c['blocks']} blocks, {c['smem']} B "
                  f"shared, tiles of phases 1-3 {', '.join(map(str, c['tiles']))} [{card}]",
                  flush=True)
            variant = f"current at tile {tile}"
            fns[variant] = lambda tile=tile: shoot2d._launch_bwd(m, g, *traj, Mn, s, tile)
            hold(variant, fns[variant]())
        b_ms, b_by = cs.bound(*cs.work("shoot2d_bwd", N, H * W, F=T))
        ms = {v: [] for v in fns}
        for order in (list(fns), list(fns)[::-1]):
            for v in order:
                ms[v].append(cs.time_ms(fns[v], device, reps))
        for v in fns:
            out[(shape, v)] = ms[v]
            print(f"K9 {v} at {tag}: {ms[v][0]:.4f}/{ms[v][1]:.4f} ms per call, bound "
                  f"{b_ms:.4f} ms ({b_by}), {T} substeps [{card}]", flush=True)
        if on_reg and H == W == 256:
            masks = {"every part": 31, **{f"without {k}": 31 ^ b for k, b in PARTS.items()},
                     "no part (the barriers)": 0}

            def parts(mask):
                d_phi0, d_m0 = torch.empty_like(g), torch.empty_like(m)
                err = lib.prof_shoot2d_bwd_parts(mask, *ptrs, d_m0.data_ptr(), d_phi0.data_ptr(),
                                                 cbuf.data_ptr(), gbuf.data_ptr(), N, T, s, stream)
                if err:
                    raise RuntimeError(f"K9 parts (mask {mask}) at {tag}: error {err}")

            pm = {k: [] for k in masks}
            for order in (list(masks), list(masks)[::-1]):
                for k in order:
                    pm[k].append(cs.time_ms(lambda k=k: parts(masks[k]), device, reps))
            for k in masks:
                out[(shape, f"parts: {k}")] = pm[k]
                print(f"K9 parts at {tag}, {k}: {pm[k][0]:.4f}/{pm[k][1]:.4f} ms per call "
                      f"(not K9's output) [{card}]", flush=True)
        del traj, g, ref, cbuf, dm, dmw, gbuf
    return out


def main():
    if not torch.cuda.is_available():
        print("profile_shoot2d: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    run(build(), device, card, (cs.FULL2D, cs.FULL2D_512))
    print("profile_shoot2d: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
