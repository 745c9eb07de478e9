#!/usr/bin/env python3
"""Epochs of the port's atlas builder on synthetic 3D subjects, with the
wall time of each epoch.

    python3 profile_atlas.py [res] [n] [batch] [epochs] [--mode stream|device|both]
                             [--image-dtype bfloat16] [--offset VOXELS]
                             [--lr-pose LR] [--steps T] [--device cuda|cpu]

Builds an atlas of ``n`` (default 16) blobs at ``res``^3 (default 64) in
minibatches of ``batch`` (8) over ``epochs`` (3) epochs, as the JAX
package's ``scripts/atlas_e2e_tpu.py`` does: the same subjects (centred
Gaussian blobs of width ``res / 6`` times 1 + 0.1 N(0, 1), offset by up to
``--offset`` voxels (2) per axis, from ``numpy.random.default_rng(0)``),
``FluidMetric([0.05, 0, 0.05])``, ``reg_weight=1e-2``,
``learning_rate_pose=1e-3`` (``--lr-pose``), ``learning_rate_image=50``
and 5 integration steps (``--steps``), float32.  The JAX package's
north-star run took ``--offset 8 --lr-pose 500 --steps 10 --image-dtype
bfloat16`` (BASELINE.md, "North-star"), whose momenta grow until the
shooting leaves the unit regime.  ``--mode``: the momenta streamed from the host each
iteration (``stream``), staged once on the device (``device``,
``keep_data_on_device``), or both in turn (default), each on a builder of
its own from the same subjects.

Prints one JSON object a line for each epoch: the mode, the epoch, its
wall time in seconds (host clock around ``builder.epoch()``, which ends in
a host read of every iteration's loss), its loss and regulariser, the
iterations whose shooting left the unit regime and re-ran the exact
general integration (``fallbacks``), and the card's name and power limit.
The first epoch of each builder includes the kernels' warm-up, not their
build (built before).  Imports no jax.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def card_line(device):
    if device.type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0].strip()


def subjects(res, n, offset, device, dim=3):
    """``(n, 1, *[res] * dim)`` float32 blobs, drawn as the JAX package's
    end-to-end script draws them (in 3D), evaluated on ``device``."""
    rng = np.random.default_rng(0)
    axis = torch.arange(res, dtype=torch.float64, device=device)
    grid = torch.meshgrid(*[axis] * dim, indexing="ij")
    c = (res - 1) / 2
    out = np.empty((n, 1) + (res,) * dim, dtype=np.float32)
    for i in range(n):
        off = rng.uniform(-offset, offset, dim)
        w = res / 6 * (1 + 0.1 * rng.standard_normal())
        r2 = sum((grid[d] - c - off[d]) ** 2 for d in range(dim))
        out[i, 0] = torch.exp(-r2 / (2 * w ** 2)).float().cpu().numpy()
    return out


# the JAX package's end-to-end configuration (scripts/atlas_e2e_tpu.py)
E2E_PARAMS = (0.05, 0.0, 0.05)
E2E = dict(lddmm_integration_steps=5, reg_weight=1e-2, learning_rate_pose=1e-3,
           learning_rate_image=50.0)


def e2e_builder(lt, imgs, device, epochs, batch, params=E2E_PARAMS, **kw):
    """An ``LDDMMAtlasBuilder`` of ``imgs`` at the end-to-end configuration,
    ``FluidMetric(params)``, without progress bars; ``kw``: its other
    arguments, over the configuration's."""
    return lt.LDDMMAtlasBuilder(imgs, num_epochs=epochs, batch_size=batch,
                                metric=lt.FluidMetric(params), device=device,
                                progress_bar=False, **{**E2E, **kw})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("res", nargs="?", type=int, default=64)
    ap.add_argument("n", nargs="?", type=int, default=16)
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("epochs", nargs="?", type=int, default=3)
    ap.add_argument("--mode", choices=["stream", "device", "both"], default="both")
    ap.add_argument("--image-dtype", default=None, choices=["bfloat16"])
    ap.add_argument("--offset", type=float, default=2.0)
    ap.add_argument("--lr-pose", type=float, default=E2E["learning_rate_pose"])
    ap.add_argument("--steps", type=int, default=E2E["lddmm_integration_steps"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import lagomorph_tpu_torch as lt
    from lagomorph_tpu_torch import lddmm

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("profile_atlas: no CUDA device", file=sys.stderr)
            return 1
        from lagomorph_tpu_torch.ops.kernels import _build
        _build.library()
    card = card_line(device)
    t0 = time.perf_counter()
    imgs = list(subjects(args.res, args.n, args.offset, device))
    print(json.dumps({"setup_s": time.perf_counter() - t0, "res": args.res, "n": args.n,
                      "batch": args.batch, "card": card}), flush=True)

    fallbacks = [0]
    general = lddmm._expmap_general

    def counted(*a, **kw):  # the hoisted shooting's flag tripped
        fallbacks[0] += 1
        return general(*a, **kw)
    lddmm._expmap_general = counted

    modes = ["stream", "device"] if args.mode == "both" else [args.mode]
    for mode in modes:
        b = e2e_builder(lt, imgs, device, args.epochs, args.batch,
                        keep_data_on_device=mode == "device", image_dtype=args.image_dtype,
                        learning_rate_pose=args.lr_pose, lddmm_integration_steps=args.steps)
        b.initialize()
        for b._epoch in range(args.epochs):
            fallbacks[0] = 0
            te = time.perf_counter()
            loss, reg = b.epoch()
            wall = time.perf_counter() - te
            b.epoch_losses.append(loss)
            b.epoch_reg_terms.append(reg)
            print(json.dumps({"mode": mode, "epoch": b._epoch, "wall_s": wall, "loss": loss,
                              "reg": reg, "iterations": b._n_iters, "fallbacks": fallbacks[0],
                              "image_dtype": args.image_dtype or "float32",
                              "offset": args.offset, "lr_pose": args.lr_pose,
                              "steps": args.steps, "card": card}),
                  flush=True)
        b.close_loaders()
        if not b.epoch_losses[-1] <= b.epoch_losses[0] * (1 + 1e-6):
            print(f"profile_atlas: the {mode} run's loss rose: {b.epoch_losses}",
                  file=sys.stderr)
            return 1
        del b
    return 0


if __name__ == "__main__":
    sys.exit(main())
