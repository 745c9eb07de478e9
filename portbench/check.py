"""The comparison that decides ``correct``.

Set-up drives the builder through its first epoch (the warm-up), through
the same ``builder.epoch()`` and ``iteration`` the window drives, and keeps
what the program produced: every iteration's loss, the momenta of the first
``FOLLOWED`` minibatches after their update, the atlas's gradient
accumulator after the first and the ``FOLLOWED``-th iteration, and the
atlas after the epoch's update.  Once the window has closed and the
program's state is freed, the float64 reference (:mod:`.reference.atlas`)
follows the same epoch from the same inputs, and four numbers are compared:

* ``loss``: the largest relative gap between the program's iteration loss
  and the reference's, over the epoch's iterations (in a data-parallel run
  the loss summed over the processes);
* ``grad``: the first gradient as the update got it, ``(m0 - m1) / lr_m``
  for each subject of the first minibatch and the atlas accumulator after
  the first iteration; by the worst leaf, ``| |prog| - |ref| |`` over the
  larger of the leaf's reference norm and the median leaf's;
* ``change``: the same gap of the momenta's change after the followed
  iterations (each subject of the first ``FOLLOWED`` minibatches) and of
  the accumulator after them; leaves whose reference change is under a
  thousandth of the median leaf's are left out;
* ``atlas``: the relative L2 distance between the program's atlas change
  at the epoch's end and the reference's.

Each process compares its own subjects; the numbers of a data-parallel run
are the largest over the processes.
"""
from __future__ import annotations

import math

import torch

from .reference import atlas as ref

FOLLOWED = 3
NUMBERS = ("loss", "grad", "change", "atlas")


def _allsum(*tensors):
    import torch.distributed as dist

    for t in tensors:
        dist.all_reduce(t)


def _gap(pn, rn, drop_small=False):
    """The worst leaf's gap of norms (``pn`` the program's leaf norms, ``rn``
    the reference's, the atlas's last), and for the record the reference's
    median leaf norm, its last leaf's norm and the leaves left out."""
    med = sorted(rn)[len(rn) // 2]
    worst, dropped = 0.0, 0
    for p, r in zip(pn, rn):
        if drop_small and r < 1e-3 * med:
            dropped += 1
            continue
        worst = max(worst, abs(p - r) / max(r, med))
    return worst, {"median": med, "atlas": rn[-1], "dropped": dropped}


def _norms(x):
    """The norm of each subject of ``x``, ``(B, ...)``."""
    return [float(v) for v in x.flatten(1).norm(dim=1)]


def readings(cfg, inputs, snaps, rank, world):
    """The four numbers of this process (before the maximum over
    processes), and the reference's norms for the record.  The reference
    runs ``inputs.BLOCK`` subjects at a time: the loss is a sum over
    subjects, so each block's momenta gradient is its own and the atlas
    gradient is the sum over blocks."""
    dev = inputs.device
    f64 = torch.float64
    steps, reg = int(cfg["lddmm_integration_steps"]), float(cfg["reg_weight"])
    lr_m, lr_I = float(cfg["learning_rate_m"]), float(cfg["learning_rate_I"])
    batches = inputs.minibatches()
    rows = inputs.global_rows()  # the builder's count of each iteration
    voxels = math.prod(cfg["shape"])
    metric = inputs.metric
    I0 = inputs.atlas().to(f64)
    sums = torch.zeros(len(rows), 2, dtype=f64, device=dev)
    g_all = torch.zeros_like(I0)
    g_first = g_followed = None
    grad_n = ([], [])  # (program, reference) leaf norms: the first gradient
    change_n = ([], [])  # the followed iterations' change
    for j, idx in enumerate(batches):
        numel = rows[j] * voxels
        gI = torch.zeros_like(I0)
        at = 0
        for blk in inputs.blocks(idx):
            img = inputs.images(blk).to(f64)
            m0 = inputs.momenta(blk).to(f64)
            if j < FOLLOWED:
                I = I0.detach().requires_grad_(True)
                mm = m0.detach().requires_grad_(True)
                with torch.enable_grad():
                    sq, vm = ref.sums(metric, I, mm, img, steps)
                    gm, g = torch.autograd.grad((sq + reg * vm) / numel, (mm, I))
                sq, vm = sq.detach(), vm.detach()
                dm = snaps["m_after"][j][at:at + len(blk)].to(f64) - m0.cpu()
                change_n[0].extend(_norms(dm))
                change_n[1].extend(_norms(lr_m * gm.cpu()))
                if j == 0:
                    grad_n[0].extend(_norms(dm / lr_m))
                    grad_n[1].extend(_norms(gm.cpu()))
            else:
                sq, vm, g = ref.atlas_grad_sq(metric, I0, m0, img, steps)
                g = g / numel
            sums[j, 0] += sq
            sums[j, 1] += vm
            gI += g
            at += len(blk)
            del img, m0, g
        g_all += gI
        if j == 0:
            g_first = gI.clone()
        if j == FOLLOWED - 1:
            g_followed = g_all.clone()
    if world > 1:
        _allsum(sums, g_all, g_first, g_followed)
    # the minibatch's mean over its count, weighted by the builder's count
    # / n so that an epoch's losses sum to the mean
    loss_ref = ((sums[:, 0] + reg * sums[:, 1]) / (voxels * inputs.n)).cpu()
    loss_prog = torch.tensor(snaps["losses"], dtype=f64)
    loss = float(((loss_prog - loss_ref).abs() / loss_ref.abs()).max())
    acc = {k: v.to(f64) for k, v in snaps["accum"].items()}
    grad, grad_norms = _gap(grad_n[0] + [float(acc[1].norm())],
                            grad_n[1] + [float(g_first.norm())])
    change, change_norms = _gap(change_n[0] + [float(acc[FOLLOWED].norm())],
                                change_n[1] + [float(g_followed.norm())], drop_small=True)
    dI_ref = (-lr_I * g_all / len(rows)).cpu()
    dI_prog = snaps["I1"].to(f64) - I0.cpu()
    atlas = float((dI_prog - dI_ref).norm() / dI_ref.norm())
    return {"loss": loss, "grad": grad, "change": change, "atlas": atlas,
            "ref_norms": {"grad": grad_norms, "change": change_norms,
                          "atlas_change": float(dI_ref.norm())}}


def verdict(numbers, limits):
    """``(correct, lines)``: every number finite and within its limit, and
    one ``name value limit`` line each."""
    ok, lines = True, []
    for k in NUMBERS:
        v, lim = numbers[k], limits[k]
        good = math.isfinite(v) and v <= lim
        ok = ok and good
        lines.append(f"{k} {v!r} limit {lim!r}{'' if good else ' FAILED'}")
    return ok, lines
