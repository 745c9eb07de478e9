#!/usr/bin/env python3
"""K8 and K9, the 2D whole-shoot forward and backward, on one CUDA card,
beside variants.

    python3 profile_shoot2d.py

Nsight Compute does not run on the card's machine, so the cost of each
kernel before its redesign is split, and the current kernels' parts are
isolated, by variant kernels (``lagomorph_tpu_torch/csrc/profile/
shoot2d_variants.cu``, built here with nvcc, ``csrc/shoot2d.cu`` included)
timed with CUDA events beside the current kernels, at the 2D atlas step's
shapes, 256^2 b8 and 512^2 b8, T = 4 substeps, batch-N momenta (bench.py's
inputs; K9 on the stash from K8).  For each of K8 and K9:

* ``previous``: the kernel before its redesign (K8: three phases and
  three grid barriers a substep, 16-line tiles, radix-2 tile transforms,
  long indices; K9: four phases and four grid barriers a reverse step,
  K8's radix-2 tile transforms, one thread a pixel in the last phase, dm
  and d_mw through fields);
* ``previous, barriers only``: its launch with the phase bodies emptied;
* ``previous on N blocks``: it on a grid of 256 (K8) or 128 (K9) blocks;
* ``current, tile transforms``: the current kernel on its tile path
  (radix-2 tile transforms; 256^2 only, where the register path applies);
* ``current, phases 3 and 4 apart`` (K9): the current kernel with its
  merged phase split by a grid barrier, dm and d_mw through fields, each
  tile staging them with its halo;
* ``current, phases C and A merged`` (K8): the current kernel with phase C
  merged into the next substep's A (a halo row on each side of the tile
  inverse-transformed and composed, phiinv_{t+1} staged in shared memory
  for Ad*, two scratch planes in turn: two grid barriers a substep, not
  three);
* ``current, 9 taps``: K8 with its stencils' warps summing all 9 taps
  (zero weights included) in place of the 4 live ones;
* ``current``: the current kernel (``lagomorph_shoot2d_fwd`` / ``_bwd``);
* ``current at tile T``: the current kernel at other tile heights
  (``TILES_FWD``, ``TILES``, through the entry points' ``tile``);
* on the register path, the current kernel with each part of its phases
  left out in turn (``PARTS``; all of them, leaving the barriers), whose
  output is not the kernel's: the time each part takes.

Each line gives ms per call (two samples of 20 calls, in turns), the bound
(``chip_smoke.work``) and each output's largest difference from
``shoot2d_fwd_plain`` / ``shoot2d_bwd_plain`` on the same inputs, which
must lie within 1e-4 * max|ref| or the script exits 1; the grid and the
tiles of each phase are logged, and ptxas's registers and spills of each
kernel.  Needs a CUDA card; imports no jax.
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
# barriers, phi0, m0, Mn, out, flag, traj_p, traj_v, traj_mw, pp, cbuf, N, Nm,
# H, W, T, s, max_blocks, stream
PREV_FWD = [_I] + [_P] * 10 + [_I] * 5 + [_F, _I, _P]
# reg, variant (0 the library's, 1 merged, 2 on 9 taps), tile, phi0, m0, Mn,
# out, flag, traj_p, traj_v, traj_mw, pp, cbuf, N, Nm, H, W, T, s, cfg,
# stream
CURRENT_FWD = [_I] * 3 + [_P] * 10 + [_I] * 5 + [_F, _P, _P]
# mask, phi0, m0, Mn, out, flag, traj_p, traj_v, traj_mw, cbuf, N, T, s, stream
PARTS_FWD = [_I] + [_P] * 9 + [_I, _I, _F, _P]
VARIANTS_FWD = ("previous", "previous, barriers only", "previous on 256 blocks",
                "current, tile transforms", "current, phases C and A merged", "current, 9 taps",
                "current")
TILES_FWD = {"register": (4, 6, 12, 16), "tile": (4, 16)}
PARTS_FWD_MASK = {"phase A's Ad*": 1, "phase A's forward row transform": 2,
                  "phase B": 4, "phase C's inverse row transform": 8, "phase C's compose": 16}
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
    kernel, spills = None, ""
    for line in (p.stdout + p.stderr).splitlines():
        if "entry function" in line:
            kernel = line.split("'")[1] if "'" in line else None
        elif kernel and "spill stores" in line:
            spills = line.split(":", 1)[-1].strip()
        elif kernel and "registers" in line and any(
                k in kernel for k in ("shoot2d", "prev", "merged", "parts")):
            regs = line.split("Used", 1)[-1].split(",")[0].strip()
            print(f"ptxas {kernel}: {regs}, {spills}", flush=True)
    return load(so)


def load(so):
    lib = ctypes.CDLL(so)
    for name, types in (("prof_shoot2d_bwd_prev", PREV), ("prof_shoot2d_bwd", CURRENT),
                        ("prof_shoot2d_prev_grid", [_I, _I, _I, _I, _P]),
                        ("prof_shoot2d_bwd_parts", [_I] + [_P] * 10 + [_I, _I, _F, _P]),
                        ("prof_shoot2d_fwd_prev", PREV_FWD), ("prof_shoot2d_fwd", CURRENT_FWD),
                        ("prof_shoot2d_fwd_parts", PARTS_FWD)):
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    return lib


def run(lib, device, card, shapes, reps=20):
    """Time K8's and K9's variants at each shape; returns {(shape, variant):
    ms}, K8's variants named "K8 ..."."""
    return {**run_fwd(lib, device, card, shapes, reps), **run_bwd(lib, device, card, shapes, reps)}


def run_fwd(lib, device, card, shapes, reps=20):
    """Time K8's variants at each shape; returns {(shape, "K8 " + variant):
    ms}."""
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
        phi0 = s * metric.sharp(m)
        ref = shoot2d.shoot2d_fwd_plain(phi0, m, Mn, s, T)
        cbuf = torch.empty((2, N, H, W, 2), dtype=torch.float32, device=device)  # 2: merged
        ptrs = [x.data_ptr() for x in (phi0, m, Mn)]
        tag = f"{H}^2 b{N}" if H == W else "x".join(map(str, shape))

        # the outputs, allocated once: a call times the kernel alone (the
        # flag is reset only for the calls that are checked)
        res = torch.empty_like(phi0)
        flag = torch.ones((), dtype=torch.int32, device=device)
        traj = [torch.empty((T,) + tuple(shape), dtype=torch.float32, device=device)
                for _ in range(3)]

        def call(variant, cfg=None, tile=0, fresh=False):
            if fresh:
                flag.fill_(1)
            tail = [res.data_ptr(), flag.data_ptr(), *(x.data_ptr() for x in traj), None,
                    cbuf.data_ptr(), N, N, H, W, T, s]
            if variant.startswith("previous"):
                err = lib.prof_shoot2d_fwd_prev(int("barriers" in variant), *ptrs, *tail,
                                                256 if "256 blocks" in variant else 0, stream)
            else:
                reg = 0 if "tile transforms" in variant else -1
                form = 1 if "merged" in variant else 2 if "9 taps" in variant else 0
                err = lib.prof_shoot2d_fwd(reg, form, tile, *ptrs, *tail,
                                           None if cfg is None else ctypes.cast(cfg, _P), stream)
            if err:
                raise RuntimeError(f"K8 ({variant}) at {tag}: error {err}")
            return (res, flag.bool(), *traj)

        def hold(variant, got):
            errs = []
            for what, a, b in zip(("phiinv_T", "traj_phiinv", "traj_v", "traj_mw"),
                                  got[:1] + got[2:], ref[:1] + ref[2:]):
                err = float((a.double() - b.double()).abs().max())
                lim = 1e-4 * float(b.double().abs().max())
                cs.check(err <= lim, f"K8 ({variant}) {what} at {tag}: {err:.3e} > {lim:.3e}")
                errs.append(f"{what} {err:.3e} (limit {lim:.3e})")
            cs.check(bool(got[1]) == bool(ref[1]), f"K8 ({variant}) at {tag}: flag differs")
            print(f"K8 {variant} at {tag}: against shoot2d_fwd_plain: {', '.join(errs)}",
                  flush=True)

        prev = (ctypes.c_int * 3)()
        cs.check(lib.prof_shoot2d_prev_grid(1, N, H, W, ctypes.cast(prev, _P)) == 0,
                 "previous K8's grid")
        print(f"grid at {tag}: previous K8 {prev[0]} blocks of 256, {prev[1]} lines a tile, "
              f"{prev[2]} tiles in each row and column phase [{card}]", flush=True)
        fns = {}
        on_reg = shoot2d.fwd_launch_config(N, H, W)["path"] == "register"
        for variant in VARIANTS_FWD:
            if variant == "current, tile transforms" and not on_reg:
                print(f"K8 {variant} at {tag}: n/a (the current kernel takes the tile path)",
                      flush=True)
                continue
            if variant in ("current", "current, tile transforms"):
                cfg = (ctypes.c_int * 8)()
                call(variant, cfg)
                print(f"grid at {tag}: K8 {variant}: {'register' if cfg[0] else 'tile'} path, "
                      f"tile {cfg[1]} lines, {cfg[2]} blocks of {cfg[3]}, {cfg[4]} B shared, "
                      f"tiles of phases A-C {cfg[5]}, {cfg[6]}, {cfg[7]} [{card}]", flush=True)
            if "barriers" not in variant:
                hold(variant, call(variant, fresh=True))
            fns[variant] = lambda variant=variant: call(variant)
        own = shoot2d.fwd_launch_config(N, H, W)["tile"]
        for tile in TILES_FWD["register" if on_reg else "tile"]:
            if tile == own:
                continue
            c = shoot2d.fwd_launch_config(N, H, W, tile)
            print(f"grid at {tag}: K8 current at tile {tile}: {c['blocks']} blocks, {c['smem']} B "
                  f"shared, tiles of phases A-C {', '.join(map(str, c['tiles']))} [{card}]",
                  flush=True)
            variant = f"current at tile {tile}"
            fns[variant] = lambda tile=tile: call("current", tile=tile)
            hold(variant, call("current", tile=tile, fresh=True))
        b_ms, b_by = cs.bound(*cs.work("shoot2d_fwd", N, H * W, F=T))
        ms = {v: [] for v in fns}
        for order in (list(fns), list(fns)[::-1]):
            for v in order:
                ms[v].append(cs.time_ms(fns[v], device, reps))
        for v in fns:
            out[(shape, f"K8 {v}")] = ms[v]
            print(f"K8 {v} at {tag}: {ms[v][0]:.4f}/{ms[v][1]:.4f} ms per call, bound "
                  f"{b_ms:.4f} ms ({b_by}), {T} substeps [{card}]", flush=True)
        if on_reg and H == W == 256:
            masks = {"every part": 31,
                     **{f"without {k}": 31 ^ b for k, b in PARTS_FWD_MASK.items()},
                     "no part (the barriers)": 0}

            def parts(mask):
                err = lib.prof_shoot2d_fwd_parts(mask, *ptrs, res.data_ptr(), flag.data_ptr(),
                                                 *(x.data_ptr() for x in traj), cbuf.data_ptr(),
                                                 N, T, s, stream)
                if err:
                    raise RuntimeError(f"K8 parts (mask {mask}) at {tag}: error {err}")

            pm = {k: [] for k in masks}
            for order in (list(masks), list(masks)[::-1]):
                for k in order:
                    pm[k].append(cs.time_ms(lambda k=k: parts(masks[k]), device, reps))
            for k in masks:
                out[(shape, f"K8 parts: {k}")] = pm[k]
                print(f"K8 parts at {tag}, {k}: {pm[k][0]:.4f}/{pm[k][1]:.4f} ms per call "
                      f"(not K8's output) [{card}]", flush=True)
        del ref, cbuf, phi0, res, traj
    return out


def run_bwd(lib, device, card, shapes, reps=20):
    """Time K9's variants at each shape; returns {(shape, variant): ms}."""
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
        cs.check(lib.prof_shoot2d_prev_grid(0, N, H, W, ctypes.cast(prev, _P)) == 0,
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
