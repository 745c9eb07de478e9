"""Spatially sharded EPDiff shooting and atlas loss, with a one-voxel halo.

Port of ``lagomorph_tpu/parallel/sharded_epdiff.py``.  The fields lie on
the mesh as X slabs (``(B, C, X/n, Y, Z)``, one per entry) from start to
end:

* every stencil and warp runs slab-local on the slab with a one-voxel X
  halo, exchanged once per substep (:func:`_halo_x`: the neighbours' edge
  rows, ``.to(device)`` and ``torch.cat``);
* the global CLAMP boundary is kept exactly: the halo of the first and the
  last slab is its own edge row, which is what clamping reads, and interior
  halos are the true neighbour rows; so each slab-local op computes the
  dense op's rows, and its outputs on the halo rows (whose own taps would
  need a second halo row) are dropped;
* on a slab, the substep runs the port's unit-regime kernels: ``Ad*`` is
  K1 (:func:`..ops.kernels.epdiff_unit.ad_star`, backward K6) on the haloed
  ``phiinv`` and ``m0``, the composition K2 (``compose``, backward K7) on
  the haloed ``phiinv`` with the edge-padded velocity; on the CPU and in
  float64 their plain versions, as everywhere in the port.  Like the JAX
  package's sharded path, it ignores the kernels' unit-regime flags (the
  warps take zero weights outside the regime) and has no fallback;
* the fluid solve is the pencil solve of :mod:`.sharded_fft`;
* the initial momentum's halo is invariant and built once.

The sharded shooting equals the dense shooting up to the roundoff of the
pencil FFT.  Under autograd each halo exchange and transpose is a copy and
a concatenation, which autograd differentiates.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import kernels
from ..ops.kernels import epdiff_unit
from ..ops.sampling import sample_displaced
from .mesh import as_shards, join_like
from .sharded_fft import _check_shape, _sharded_apply

__all__ = ["sharded_expmap", "sharded_atlas_loss"]


def _halo_x(slabs):
    """Each X slab ``(B, C, Xl, Y, Z)`` with a one-voxel left and right X
    halo: interior halos are the neighbours' edge rows (moved to the slab's
    device), and the first and last slab repeat their own edge row, which
    is what the CLAMP boundary reads there."""
    n = len(slabs)
    out = []
    for k, x in enumerate(slabs):
        left = slabs[k - 1][:, :, -1:].to(x.device) if k > 0 else x[:, :, :1]
        right = slabs[k + 1][:, :, :1].to(x.device) if k < n - 1 else x[:, :, -1:]
        out.append(torch.cat([left, x, right], dim=2))
    return out


def _pad_rows_x(x):
    """Edge-pad one dummy X row per side: its values feed only slab-edge
    outputs that are dropped, and edge mode keeps them in the unit
    regime."""
    return torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)


def _ad_star_local(p_hal, m0_hal):
    """Slab-local ``Ad^*`` (K1 on the haloed slabs); returns the centre rows
    (the dense rows: the warp taps and the x central difference read the
    halo, everything else is local)."""
    return epdiff_unit.ad_star(p_hal, m0_hal)[0][:, :, 1:-1]


def _compose_local(p_hal, v, s):
    """Slab-local ``compose_disp_vel(p, v, dt=s) = s*v + p(x + s*v)`` (K2 on
    the haloed ``phiinv`` and the edge-padded ``v``; ``|s*v| < 1`` so the
    taps reach at most the halo); returns the centre rows."""
    return epdiff_unit.compose(p_hal, _pad_rows_x(v), s)[0][:, :, 1:-1]


def _params_of(metric_or_params):
    params = getattr(metric_or_params, "params", metric_or_params)
    return tuple(float(p) for p in params)


def _shoot(params, slabs, dt, num_steps, checkpoints, cache):
    """``(v0, phiinv)`` of the sharded shooting from the momentum slabs: the
    initial velocity's slabs and those of the inverse deformation after
    ``num_steps`` substeps."""
    def sharp(xs):
        return _sharded_apply(xs, params, True, cache)

    v0 = sharp(slabs)
    phiinv = [(-dt) * v for v in v0]
    if num_steps <= 1:
        return v0, phiinv
    m0_hal = _halo_x(slabs)  # invariant: built once

    def substep(*p):
        p_hal = _halo_x(list(p))  # shared by Ad* and compose
        m = [_ad_star_local(ph, mh) for ph, mh in zip(p_hal, m0_hal)]
        v = sharp(m)
        return tuple(_compose_local(ph, vv, -dt) for ph, vv in zip(p_hal, v))

    for _ in range(num_steps - 1):
        if checkpoints:
            phiinv = list(checkpoint(substep, *phiinv, use_reentrant=False,
                                     context_fn=kernels.same_versions))
        else:
            phiinv = list(substep(*phiinv))
    return v0, phiinv


def sharded_expmap(metric, m0, mesh, T=1.0, num_steps=10, axis_name="data",
                   checkpoints=False):
    """X-sharded geodesic shooting ``expmap`` with a one-voxel halo (see the
    module docstring).  ``metric``: a FluidMetric or its ``(alpha, beta,
    gamma)`` params; the fluid solve runs as the pencil solve.

    ``m0``: ``(B, 3, X, Y, Z)`` with ``X`` and ``Y`` divisible by the mesh
    axis size, a :class:`.mesh.Sharded` of X slabs or one tensor.  Returns
    ``phiinv`` the same way (a tensor is joined on ``m0``'s device).  It
    matches the dense ``expmap(..., transport_mode="unit",
    compose_mode="unit")`` integration up to the pencil FFT's roundoff (in
    the unit-displacement regime, i.e. any stable integration).
    ``checkpoints``: each substep is rematerialised in the backward."""
    params = _params_of(metric)
    n = mesh.shape[axis_name]
    if len(m0.shape) != 5 or m0.shape[1] != 3:
        raise ValueError("sharded_expmap expects (B, 3, X, Y, Z) momenta")
    _check_shape(tuple(m0.shape), n)
    _, phiinv = _shoot(params, as_shards(m0, mesh, 2), T / num_steps, num_steps, checkpoints,
                       {})
    return join_like(phiinv, m0, 2)


def sharded_atlas_loss(metric, I, m, img, mesh, reg_weight=1e2, num_steps=5, axis_name="data",
                       checkpoints=False, mask=None):
    """Spatially sharded LDDMM atlas loss: shooting, atlas warp, MSE and
    regularity, X-sharded end to end (``I``/``img``: ``(., 1, X, Y, Z)``
    image fields sharded like the momenta, each a :class:`.mesh.Sharded` of
    X slabs or one tensor).  The loss of the JAX package's ``_lddmm_loss``
    for momenta and images on the same grid; returns ``(loss, reg_term)``,
    0-dim tensors on the first slab's device.  ``mask``: optional ``(B,)``
    0/1 subject weights (a tensor; each slab reads a copy).

    The atlas warp is the JAX package's ``sample_linear`` (CLAMP) on each
    slab widened by ``min(num_steps, X/n)`` halo rows (:func:`_halo_x`
    applied that many times, as the JAX package does it), at the slab's
    voxels displaced by ``phiinv``; it is computed by
    :func:`..ops.sampling.sample_displaced`, which keeps the displacement
    apart from the voxel's index, so that float32 keeps its precision."""
    params = _params_of(metric)
    n = mesh.shape[axis_name]
    _check_shape(tuple(m.shape), n)
    B, _, X, Y, Z = m.shape
    Xl = X // n
    halo_img = min(int(num_steps), Xl)
    ms = as_shards(m, mesh, 2)
    v0, phiinv = _shoot(params, ms, 1.0 / num_steps, num_steps, checkpoints, {})

    I_wide = as_shards(I, mesh, 2)
    for _ in range(halo_img):
        I_wide = _halo_x(I_wide)
    imgs = as_shards(img, mesh, 2)
    first = ms[0].device
    sq = vm = None
    for Iw, p, im, v, mm in zip(I_wide, phiinv, imgs, v0, ms):
        # on the widened slab, the slab's voxels lie halo_img rows in
        Idef = sample_displaced(Iw, p, offset=(halo_img, 0, 0))
        s = torch.sum((Idef - im) ** 2, dim=tuple(range(1, im.dim())))  # per subject
        w = torch.sum(v * mm, dim=tuple(range(1, mm.dim())))
        if mask is not None:
            mk = mask.to(p.device)
            s, w = s * mk, w * mk
        s, w = torch.sum(s).to(first), torch.sum(w).to(first)
        sq = s if sq is None else sq + s
        vm = w if vm is None else vm + w
    count = float(B) if mask is None else torch.sum(mask.to(first))
    numel = count * float(X * Y * Z)
    reg = reg_weight * vm / numel
    return sq / numel + reg, reg
