"""LDDMM geodesic shooting, the atlas loss and the atlas step.

Port of ``lagomorph_tpu/lddmm.py``: ``EPDiff_step``, ``expmap`` with the
peeled first step, the hoisted fast path with its validity flag and exact
fallback (on the per-substep kernels; 2D with ``beta == 0`` and no
momentum mask in one launch of the whole-shoot kernel),
``shooting_regime_ok``, ``_lddmm_loss`` and ``make_lddmm_atlas_step`` (the
loss, its gradients by autograd through the kernels' backwards, and the
update of the momenta).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import adjrep, deform
from .metric import FluidMetric
from .ops.interp import in_unit as _in_unit
from .ops import kernels
from .ops.kernels import epdiff2d, epdiff_unit, shoot2d

__all__ = ["EPDiff_step", "expmap", "make_lddmm_atlas_step", "shooting_regime_ok"]


def EPDiff_step(metric, m0, dt, phiinv, mommask=None, transport_mode=None,
                compose_mode=None):
    """One step of EPDiff in integrated form: transport the initial momentum
    with ``Ad^*``, sharp it to a velocity, and compose it into the inverse
    deformation.  ``transport_mode`` / ``compose_mode`` force the warp tier
    of the two warps (None: picked from the displacement)."""
    m = adjrep.Ad_star(phiinv, m0, mode=transport_mode)
    if mommask is not None:
        m = m * mommask
    v = metric.sharp(m)
    return deform.compose_disp_vel(phiinv, v, dt=-dt, mode=compose_mode)


def expmap(metric, m0, T=1.0, num_steps=10, phiinv=None, mommask=None,
           checkpoints=False, transport_mode=None, compose_mode=None, v0=None):
    """Geodesic shooting: the inverse deformation ``phi^{-1}`` (as a
    displacement) at time ``T`` from the initial momentum ``m0``.  The JAX
    package's signature; ``checkpoints=True`` (rematerialised shooting) is
    not ported and raises ``NotImplementedError``.

    ``v0``: optional precomputed ``metric.sharp(m0 * mommask)``, shared with
    a caller that also needs the initial velocity.  Starting from the
    identity, the first step is peeled (``Ad*(0, m0) = m0`` and the first
    composition is ``-dt * v0`` exactly).  With no tier forced, the rest
    takes the hoisted fast path (:func:`_expmap_hoisted`) on the flagged
    integrator that :func:`_fast_integrator` picks; otherwise the per-step
    loop."""
    if checkpoints:
        raise NotImplementedError(
            "checkpoints=True (gradient checkpointing of the shooting, "
            "rematerialised in the backward) is not ported"
        )
    dt = T / num_steps
    length = num_steps
    if phiinv is None:
        if v0 is None:
            m = m0 if mommask is None else m0 * mommask
            v0 = metric.sharp(m)
        phiinv = (-dt) * v0
        length = num_steps - 1
        if length <= 0:
            return phiinv
        if transport_mode is None and compose_mode is None:
            fast = _fast_integrator(metric, m0, dt, mommask)
            if fast is not None:
                return _expmap_hoisted(metric, m0, dt, length, phiinv, mommask, fast)
    for _ in range(length):
        phiinv = EPDiff_step(metric, m0, dt, phiinv, mommask=mommask,
                             transport_mode=transport_mode,
                             compose_mode=compose_mode)
    return phiinv


def _fast_integrator(metric, m0, dt, mommask):
    """The flagged fast integrator for these momenta, by dimension:
    :func:`_expmap_fast_flagged` (the per-substep kernels: K1, K2 for 3D
    three-channel fields, K10, K11 for 2D two-channel ones), except that 2D
    fields take :func:`_shoot2d_flagged` (the whole shooting in one launch
    of K8) under the JAX package's conditions (``lagomorph_tpu/lddmm.py:
    276-294``, ``lagomorph_tpu/ops/pallas/shoot2d.py:104-111``): no
    ``mommask``, a ``FluidMetric`` with ``beta == 0``, a Python number
    ``dt``.  None: the per-step loop.  The TPU-only conditions of the JAX
    gates (``H % 8``, ``W % 128``, ``H, W <= 512``, ``T <= 32`` and the VMEM
    budgets, ``shoot2d.py:64-86, 112-115``, ``epdiff2d.py:52-72``) do not
    apply to the card's kernels and are dropped."""
    dim = m0.dim() - 2
    if dim not in (2, 3) or m0.shape[1] != dim:
        return None
    if (dim == 2 and mommask is None and isinstance(metric, FluidMetric)
            and metric.params[1] == 0.0 and isinstance(dt, (int, float))):
        return _shoot2d_flagged
    return _expmap_fast_flagged


def _shoot2d_flagged(metric, m0, dt, length, phiinv0, mommask):
    """The 2D hoisted fast path for ``beta == 0``: all ``length`` substeps
    in one launch of K8 (its backward one launch of K9).  ``mommask`` is
    always None here (see :func:`_fast_integrator`).  Returns ``(phiinv,
    ok)``."""
    Mn = metric.packed_multiplier(m0.shape[2:], m0.dtype, m0.device)
    return shoot2d.shoot2d(phiinv0, m0, Mn, -dt, length)


def _expmap_fast_flagged(metric, m0, dt, length, phiinv0, mommask):
    """The hoisted fast loop: ``length`` substeps on the unit-regime
    kernels for the fields' dimension (3D: K1 Ad*, K2 compose; 2D: K10,
    K11; ``lagomorph_tpu/lddmm.py:_hoisted_fused_pair``), accumulating
    their flags on the device.  Returns ``(phiinv, ok)``; ``phiinv`` is
    exact iff ``ok``."""
    if m0.dim() == 5:
        ad_star, compose = epdiff_unit.ad_star, epdiff_unit.compose
    else:
        ad_star, compose = epdiff2d.ad_star2d, epdiff2d.compose2d
    phiinv = phiinv0
    ok = torch.ones((), dtype=torch.bool, device=phiinv0.device)
    for _ in range(length):
        m, f_transport = ad_star(phiinv, m0)
        if mommask is not None:
            m = m * mommask
        v = metric.sharp(m)
        phiinv, f_compose = compose(phiinv, v, -dt)
        ok = ok & f_transport & f_compose
    return phiinv, ok


def _expmap_general(metric, m0, dt, length, phiinv0, mommask, mode="auto"):
    """Exact integration in every regime: each substep picks its warp tiers
    from its own displacements (``mode="auto"``), or takes the forced tier
    ``mode``.  Every substep is rematerialised, as the JAX package's
    ``jax.checkpoint(step)`` (``lagomorph_tpu/lddmm.py:257-259``): autograd
    keeps each substep's input, not its intermediates, and the backward
    runs the substep again, on the same warp tiers (its inputs being the
    same) and the same versions, kernels or plain."""
    phiinv = phiinv0
    for _ in range(length):
        phiinv = checkpoint(EPDiff_step, metric, m0, dt, phiinv, mommask, mode, mode,
                            use_reentrant=False, context_fn=kernels.same_versions)
    return phiinv


def _expmap_hoisted(metric, m0, dt, length, phiinv0, mommask, fast_fn):
    """Integrate on the unit-regime kernels with a validity flag
    (``fast_fn``, from :func:`_fast_integrator`), and re-run the exact
    general integration when any substep left the unit regime.

    The JAX package's ``lax.cond(ok, fast, general)`` becomes one host read
    of the flag per call.  That sync is why the shooting loop cannot yet be
    captured in a CUDA graph."""
    fast, ok = fast_fn(metric, m0, dt, length, phiinv0, mommask)
    if bool(ok):
        return fast
    del fast  # frees its autograd graph before the re-run builds its own
    return _expmap_general(metric, m0, dt, length, phiinv0, mommask)


def shooting_regime_ok(metric, m0, T=1.0, num_steps=10, mommask=None) -> torch.Tensor:
    """0-dim bool tensor: True iff every substep of ``expmap(metric, m0,
    ...)`` stays in the unit regime (every warp displacement in ``[-1,
    1)``), i.e. the hoisted fast path keeps its result.  Runs one
    general-tier shooting; a spot check, not for the hot loop."""
    dt = T / num_steps
    m = m0 if mommask is None else m0 * mommask
    phiinv = (-dt) * metric.sharp(m)
    ok = _in_unit(phiinv)
    for _ in range(num_steps - 1):
        ok = ok & _in_unit(phiinv)
        m = adjrep.Ad_star(phiinv, m0, mode="general")
        if mommask is not None:
            m = m * mommask
        v = metric.sharp(m)
        ok = ok & _in_unit(-dt * v)
        phiinv = deform.compose_disp_vel(phiinv, v, dt=-dt, mode="general")
    return ok


def _lddmm_loss(I, m, img, metric, reg_weight, integration_steps, checkpoints=False,
                image_shape=None, mask=None):
    """Loss of one minibatch: ``MSE(I o phi^{-1}(m), img) / |Omega| + reg``,
    returned as ``(loss, reg_term)``.  The JAX package's signature.

    ``mask``: optional ``(B,)`` 0/1 weights for padded subjects.  Not
    ported: ``checkpoints=True`` (rematerialised shooting) and momenta on
    another grid than the image (``image_shape``, the regrid branch); both
    raise ``NotImplementedError``."""
    if checkpoints:
        raise NotImplementedError(
            "checkpoints=True (gradient checkpointing of the shooting, "
            "rematerialised in the backward) is not ported"
        )
    # one fluid solve serves the regularizer and the peeled first step
    v = metric.sharp(m)
    h = expmap(metric, m, num_steps=integration_steps, v0=v)
    if image_shape is not None and tuple(h.shape[2:]) != tuple(image_shape):
        raise NotImplementedError(
            "momenta on a coarser grid than the image (regrid) are not ported"
        )
    Idef = deform.interp_auto(I, h)
    sq = torch.sum((Idef - img) ** 2, dim=tuple(range(1, img.dim())))
    vm = torch.sum(v * m, dim=tuple(range(1, m.dim())))
    if mask is None:
        count = img.shape[0]
    else:
        sq = sq * mask
        vm = vm * mask
        count = torch.sum(mask)
    numel = count * float(np.prod(img.shape[1:]))
    reg_term = reg_weight * torch.sum(vm) / numel
    loss = torch.sum(sq) / numel + reg_term
    return loss, reg_term


def make_lddmm_atlas_step(metric, reg_weight=1e2, learning_rate_pose=2e2, lddmm_steps=1,
                          integration_steps=5, momentum_preconditioning=False,
                          checkpoints=False, image_shape=None, spatial_mesh=None,
                          spatial_axis="data"):
    """The per-minibatch atlas update of the JAX package's
    ``make_lddmm_atlas_step``.

    Returns ``step(I, m, img, mask=None) -> (m_new, I_grad, loss, reg_term)``:
    ``lddmm_steps`` gradient steps on the momenta, ``m <- m - lr * p`` with
    ``p`` the gradient of :func:`_lddmm_loss` in ``m`` (``metric.flat`` of it
    with ``momentum_preconditioning``); ``I_grad``, the gradient in the
    atlas image of the last step's loss (shaped like ``I``, summed over the
    batch), is for the caller to accumulate.  Every output is a detached
    tensor on the inputs' device; the step reads nothing on the host beyond
    the shooting's flag and the atlas warp's tier.

    Not ported: ``spatial_mesh`` (spatially sharded shooting), which
    raises here, and, at the first call, ``checkpoints=True`` and an
    ``image_shape`` other than the momenta's grid (see :func:`_lddmm_loss`)."""
    if spatial_mesh is not None:
        raise NotImplementedError(
            f"spatial_mesh (shooting sharded over the {spatial_axis!r} axis of a "
            "device mesh) is not ported"
        )

    def step(I, m, img, mask=None):
        loss = reg = I_grad = None
        for it in range(lddmm_steps):
            last = it == lddmm_steps - 1
            with torch.enable_grad():
                m_ = m.detach().requires_grad_(True)
                I_ = I.detach().requires_grad_(last)
                loss, reg = _lddmm_loss(I_, m_, img, metric, reg_weight, integration_steps,
                                        checkpoints, image_shape=image_shape, mask=mask)
                if last:
                    gm, I_grad = torch.autograd.grad(loss, (m_, I_))
                else:
                    (gm,) = torch.autograd.grad(loss, (m_,))
            with torch.no_grad():
                p = metric.flat(gm) if momentum_preconditioning else gm
                m = m - learning_rate_pose * p
        return m, I_grad, loss.detach(), reg.detach()

    return step
