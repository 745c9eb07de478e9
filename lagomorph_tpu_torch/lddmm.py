"""LDDMM geodesic shooting, the atlas loss, the atlas step and the atlas
builder.

Port of ``lagomorph_tpu/lddmm.py``: ``EPDiff_step``, ``EPDiff_steps``,
``expmap_advect``, ``expmap`` with the peeled first step, the hoisted
fast path with its validity flag and exact fallback (on the per-substep
kernels; 2D with ``beta == 0`` and no momentum mask in one launch of the
whole-shoot kernel), optionally rematerialising each substep in the backward
(``checkpoints``), ``shooting_regime_ok``, ``_lddmm_loss`` (with momenta on
a coarser grid than the image), ``make_lddmm_atlas_step`` (the loss, its
gradients by autograd through the kernels' backwards, and the update of
the momenta; on X slabs of a mesh with ``spatial_mesh``), the epoch loop of
:class:`LDDMMAtlasBuilder` on one device, on a device mesh, over several
processes or spatially sharded, :func:`lddmm_atlas` and the ``lddmm atlas``
command.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import adjrep, deform
from .metric import FluidMetric, Metric
from .ops.affine import regrid
from .ops.interp import get_warp_mode
from .ops.interp import in_unit as _in_unit
from .ops import kernels
from .ops.kernels import epdiff2d, epdiff_unit, shoot2d
from .parallel.distributed import local_shard as _host
from .parallel.mesh import Sharded, shardwise
from .profiling import add as _count, span
from .utils import Tool, process_count, process_index, progress, torch_device

__all__ = [
    "EPDiff_step",
    "EPDiff_steps",
    "LDDMMAtlasBuilder",
    "expmap",
    "expmap_advect",
    "lddmm_atlas",
    "make_lddmm_atlas_step",
    "shooting_regime_ok",
]


def _remat(fn, *args):
    """``fn(*args)`` with its intermediates dropped after the forward and
    recomputed in the backward (``torch.utils.checkpoint``), on the same
    versions, kernels or plain, as the forward ran (:func:`kernels.
    same_versions`); the JAX package's ``jax.checkpoint``."""
    return checkpoint(fn, *args, use_reentrant=False, context_fn=kernels.same_versions)


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
    package's signature.  ``checkpoints``: autograd keeps each substep's
    inputs, not its intermediates, and the backward runs the substep again
    (memory in the number of substeps drops to one field a substep); the
    whole-shoot kernel K8 ignores it, as the JAX package's does.

    ``v0``: optional precomputed ``metric.sharp(m0 * mommask)``, shared with
    a caller that also needs the initial velocity.  Starting from the
    identity, the first step is peeled (``Ad*(0, m0) = m0`` and the first
    composition is ``-dt * v0`` exactly).  With no tier forced (neither
    ``transport_mode`` nor ``compose_mode``, and the global warp mode
    "auto" or "unit"), the rest takes the hoisted fast path
    (:func:`_expmap_hoisted`) on the flagged integrator that
    :func:`_fast_integrator` picks; otherwise the per-step loop."""
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
                return _expmap_hoisted(metric, m0, dt, length, phiinv, mommask, fast,
                                       checkpoints)
    for _ in range(length):
        args = (metric, m0, dt, phiinv, mommask, transport_mode, compose_mode)
        phiinv = _remat(EPDiff_step, *args) if checkpoints else EPDiff_step(*args)
    return phiinv


def _fast_integrator(metric, m0, dt, mommask):
    """The flagged fast integrator for these momenta, by dimension:
    :func:`_expmap_fast_flagged` (the per-substep kernels: K1, K2 for 3D
    three-channel fields, K10, K11 for 2D two-channel ones), except that 2D
    fields take :func:`_shoot2d_flagged` (the whole shooting in one launch
    of K8) under the JAX package's conditions (``lagomorph_tpu/lddmm.py:
    276-294``, ``lagomorph_tpu/ops/pallas/shoot2d.py:104-111``): no
    ``mommask``, a ``FluidMetric`` with ``beta == 0``, a Python number
    ``dt``.  None: the per-step loop, also under a global warp mode of
    "bounded" or "general" (``lagomorph_tpu/lddmm.py:_hoisted_fused_pair``),
    read at each call.  The TPU-only conditions of the JAX
    gates (``H % 8``, ``W % 128``, ``H, W <= 512``, ``T <= 32`` and the VMEM
    budgets, ``shoot2d.py:64-86, 112-115``, ``epdiff2d.py:52-72``) do not
    apply to the card's kernels and are dropped."""
    dim = m0.dim() - 2
    if dim not in (2, 3) or m0.shape[1] != dim or get_warp_mode() not in ("auto", "unit"):
        return None
    if (dim == 2 and mommask is None and isinstance(metric, FluidMetric)
            and metric.params[1] == 0.0 and isinstance(dt, (int, float))):
        return _shoot2d_flagged
    return _expmap_fast_flagged


def _shoot2d_flagged(metric, m0, dt, length, phiinv0, mommask, checkpoints=False):
    """The 2D hoisted fast path for ``beta == 0``: all ``length`` substeps
    in one launch of K8 (its backward one launch of K9).  ``mommask`` is
    always None here (see :func:`_fast_integrator`); ``checkpoints`` is
    ignored (K9 reads the trajectory that K8 stashes).  Returns
    ``(phiinv, ok)``."""
    Mn = metric.packed_multiplier(m0.shape[2:], m0.dtype, m0.device)
    return shoot2d.shoot2d(phiinv0, m0, Mn, -dt, length)


def _expmap_fast_flagged(metric, m0, dt, length, phiinv0, mommask, checkpoints=False):
    """The hoisted fast loop: ``length`` substeps on the unit-regime
    kernels for the fields' dimension (3D: K1 Ad*, K2 compose; 2D: K10,
    K11; ``lagomorph_tpu/lddmm.py:_hoisted_fused_pair``), accumulating
    their flags on the device, each substep rematerialised with
    ``checkpoints`` (the flag a non-differentiable output), each issued
    inside the span ``lt.substep``.  Returns ``(phiinv, ok)``; ``phiinv`` is
    exact iff ``ok``."""
    if m0.dim() == 5:
        ad_star, compose = epdiff_unit.ad_star, epdiff_unit.compose
    else:
        ad_star, compose = epdiff2d.ad_star2d, epdiff2d.compose2d

    def substep(phiinv, ok):
        m, f_transport = ad_star(phiinv, m0)
        if mommask is not None:
            m = m * mommask
        v = metric.sharp(m)
        phiinv, f_compose = compose(phiinv, v, -dt)
        return phiinv, ok & f_transport & f_compose

    phiinv = phiinv0
    ok = torch.ones((), dtype=torch.bool, device=phiinv0.device)
    for _ in range(length):
        with span("lt.substep"):
            phiinv, ok = _remat(substep, phiinv, ok) if checkpoints else substep(phiinv, ok)
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
        phiinv = _remat(EPDiff_step, metric, m0, dt, phiinv, mommask, mode, mode)
    return phiinv


def _expmap_hoisted(metric, m0, dt, length, phiinv0, mommask, fast_fn, checkpoints=False):
    """Integrate on the unit-regime kernels with a validity flag
    (``fast_fn``, from :func:`_fast_integrator`, rematerialising its
    substeps with ``checkpoints``), and re-run the exact general
    integration (always rematerialised) when any substep left the unit
    regime.

    The JAX package's ``lax.cond(ok, fast, general)`` becomes one host read
    of the flag per call (span ``lt.read.flag``).  That sync is why the
    shooting loop cannot yet be captured in a CUDA graph.  The whole call is
    the span ``lt.shoot``; the re-run, ``lt.shoot.general``, counts the
    fallbacks."""
    with span("lt.shoot"):
        fast, ok = fast_fn(metric, m0, dt, length, phiinv0, mommask, checkpoints)
        with span("lt.read.flag"):
            ok = bool(ok)
        if ok:
            return fast
        del fast  # frees its autograd graph before the re-run builds its own
        with span("lt.shoot.general"):
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


def EPDiff_steps(metric, m0, dt, N, phiinv):
    """``N`` steps of :func:`EPDiff_step` from ``phiinv``, each
    rematerialised in the backward (the JAX package's gradient-checkpointed
    block)."""
    for _ in range(N):
        phiinv = _remat(EPDiff_step, metric, m0, dt, phiinv)
    return phiinv


def expmap_advect(metric, m, T=1.0, num_steps=10, phiinv=None):
    """EPDiff by explicit Euler advection of the momentum (the
    non-integrated form, ``d/dt m = -ad_v^* m``): the inverse deformation
    at time ``T``.  Each step advects the momentum with the plain
    ``adjrep.ad_star``, sharpens it (K3 on 3D fields) and composes the
    velocity into ``phiinv`` (``compose_disp_vel(., ., dt=-dt)``: K2 on 3D
    fields in the unit regime).  The JAX package sharpens each momentum
    twice; the port keeps the first velocity for the next step's
    advection, the same tensor."""
    if phiinv is None:
        phiinv = torch.zeros_like(m)
    dt = T / num_steps
    v = metric.sharp(m)
    phiinv = deform.compose_disp_vel(phiinv, v, dt=-dt)
    for _ in range(num_steps - 1):
        m = m - dt * adjrep.ad_star(v, m)
        v = metric.sharp(m)
        phiinv = deform.compose_disp_vel(phiinv, v, dt=-dt)
    return phiinv


def _lddmm_sums(I, m, img, metric, integration_steps, checkpoints=False, image_shape=None,
                mask=None):
    """The sums of :func:`_lddmm_loss` before it normalises them: ``(sum of
    the squared image error, sum of <v, m>, ratio)``, masked when ``mask``
    is given; ``ratio`` scales the regulariser of momenta on another grid
    than the image (None on the same grid)."""
    # one fluid solve serves the regularizer and the peeled first step
    v = metric.sharp(m)
    h = expmap(metric, m, num_steps=integration_steps, checkpoints=checkpoints, v0=v)
    regrid_momenta = image_shape is not None and tuple(h.shape[2:]) != tuple(image_shape)
    if regrid_momenta:
        h = regrid(h, shape=tuple(image_shape))
    with span("lt.warp"):
        Idef = deform.interp_auto(I, h)
    sq = torch.sum((Idef - img) ** 2, dim=tuple(range(1, img.dim())))
    vm = torch.sum(v * m, dim=tuple(range(1, m.dim())))
    if mask is not None:
        sq = sq * mask
        vm = vm * mask
    # the coarser grid averages over fewer voxels
    ratio = I.numel() / v[0, 0].numel() if regrid_momenta else None
    return torch.sum(sq), torch.sum(vm), ratio


def _normalise(sq, vm, ratio, count, img, reg_weight):
    """``(loss, reg_term)`` of the sums of :func:`_lddmm_sums` over ``count``
    subjects of ``img``'s shape."""
    numel = count * float(np.prod(img.shape[1:]))
    reg_term = reg_weight * vm / numel
    if ratio is not None:
        reg_term = reg_term * ratio
    return sq / numel + reg_term, reg_term


def _lddmm_loss(I, m, img, metric, reg_weight, integration_steps, checkpoints=False,
                image_shape=None, mask=None):
    """Loss of one minibatch: ``MSE(I o phi^{-1}(m), img) / |Omega| + reg``,
    returned as ``(loss, reg_term)``.  The JAX package's signature.

    ``mask``: optional ``(B,)`` 0/1 weights for padded subjects.
    ``checkpoints``: rematerialise the shooting's substeps (:func:`expmap`).
    ``image_shape``: the image grid, when the momenta live on another one;
    the deformation is then regridded onto it *without* rescaling its
    displacements (which stay in momentum-grid voxels: the behaviour of the
    reference that the JAX package keeps for parity), and the regulariser
    is scaled by the ratio of the grids' sizes."""
    sq, vm, ratio = _lddmm_sums(I, m, img, metric, integration_steps, checkpoints,
                                image_shape, mask)
    count = img.shape[0] if mask is None else torch.sum(mask)
    return _normalise(sq, vm, ratio, count, img, reg_weight)


def _descend(metric, m, gm, learning_rate_pose, momentum_preconditioning):
    """``m - lr * p``, ``p`` the gradient ``gm`` (``metric.flat`` of it with
    ``momentum_preconditioning``)."""
    with torch.no_grad():
        p = metric.flat(gm) if momentum_preconditioning else gm
        return m - learning_rate_pose * p


def make_lddmm_atlas_step(metric, reg_weight=1e2, learning_rate_pose=2e2, lddmm_steps=1,
                          integration_steps=5, momentum_preconditioning=False,
                          checkpoints=False, image_shape=None, spatial_mesh=None,
                          spatial_axis="data"):
    """The per-minibatch atlas update of the JAX package's
    ``make_lddmm_atlas_step``.

    Returns ``step(I, m, img, mask=None, count=None) -> (m_new, I_grad,
    loss, reg_term)``: ``lddmm_steps`` gradient steps on the momenta, ``m <-
    m - lr * p`` with ``p`` the gradient of :func:`_lddmm_loss` in ``m``
    (``metric.flat`` of it with ``momentum_preconditioning``); ``I_grad``,
    the gradient in the atlas image of the last step's loss (shaped like
    ``I``, summed over the batch), is for the caller to accumulate.  Every
    output is a detached tensor on the inputs' device; the step reads
    nothing on the host beyond the shooting's flag and the atlas warp's
    tier.  ``checkpoints`` and ``image_shape`` as in :func:`_lddmm_loss`.

    Data parallelism, as the JAX step jitted with the batch sharded: ``m``,
    ``img`` and ``mask`` may be split along the batch over a mesh
    (:class:`.parallel.mesh.Sharded`, ``m_new`` returned so), ``I`` then
    copied to each entry and each shard's sums added on ``I``'s device.
    ``count``: the subjects the loss averages over (``sum(mask)``, or the
    batch, by default); a process of a multi-process run passes the count
    of the global batch, so that each momentum gets its gradient of the
    global loss, and the loss, the regulariser and ``I_grad`` are then
    summed over the processes (``all_reduce``), as the psum of the JAX
    package's global step does.

    ``spatial_mesh``: the whole loss (shooting, warp, MSE) runs X-sharded
    over ``spatial_axis`` of that mesh (:func:`.parallel.sharded_atlas_loss`,
    through K1, K2, K6 and K7 on each haloed slab), for volumes too large
    for one device.  ``I``, ``m`` and ``img`` are then X-sharded
    (:class:`.parallel.mesh.Sharded`, returned as such) or whole tensors
    (split here, joined on their devices); preconditioning runs the pencil
    solve.  Requires momenta and images on the same grid (no regrid path)."""
    if spatial_mesh is not None:
        return _spatial_step(metric, spatial_mesh, spatial_axis, reg_weight, learning_rate_pose,
                             lddmm_steps, integration_steps, momentum_preconditioning,
                             checkpoints)

    from .parallel.distributed import allsum_

    def step(I, m, img, mask=None, count=None):
        with span("lt.step"):
            ms, imgs = (list(x) if isinstance(x, Sharded) else [x] for x in (m, img))
            masks = [None] * len(ms) if mask is None else (
                list(mask) if isinstance(mask, Sharded) else [mask])
            if count is None:
                count = (img.shape[0] if mask is None
                         else sum(torch.sum(k).to(I.device) for k in masks))
            loss = reg = I_grad = None
            for it in range(lddmm_steps):
                last = it == lddmm_steps - 1
                with torch.enable_grad():
                    m_ = [x.detach().requires_grad_(True) for x in ms]
                    I_ = I.detach().requires_grad_(last)
                    sq = vm = ratio = None
                    with span("lt.loss"):
                        for mk, ik, kk in zip(m_, imgs, masks):
                            s, v, ratio = _lddmm_sums(I_.to(mk.device), mk, ik, metric,
                                                      integration_steps, checkpoints,
                                                      image_shape, kk)
                            sq = s.to(I.device) if sq is None else sq + s.to(I.device)
                            vm = v.to(I.device) if vm is None else vm + v.to(I.device)
                        loss, reg = _normalise(sq, vm, ratio, count, imgs[0], reg_weight)
                    with span("lt.backward"):
                        grads = torch.autograd.grad(loss, m_ + [I_] if last else m_)
                with span("lt.descend"):
                    ms = [_descend(metric, x, g, learning_rate_pose, momentum_preconditioning)
                          for x, g in zip(ms, grads)]
                if last:
                    I_grad = grads[-1]
            loss, reg = loss.detach(), reg.detach()
            if process_count() > 1:
                sums = torch.stack([loss, reg])
                allsum_(sums, I_grad)
                loss, reg = sums[0], sums[1]
            return (m.like(ms) if isinstance(m, Sharded) else ms[0]), I_grad, loss, reg

    return step


def _spatial_step(metric, mesh, axis_name, reg_weight, learning_rate_pose, lddmm_steps,
                  integration_steps, momentum_preconditioning, checkpoints):
    """:func:`make_lddmm_atlas_step`'s step on X slabs over ``mesh``."""
    from .parallel import ShardedFluidMetric, sharded_atlas_loss
    from .parallel.mesh import as_shards, join_like

    flat = ShardedFluidMetric(getattr(metric, "params", metric), mesh, axis_name)

    def step(I, m, img, mask=None):
        with span("lt.step"):
            Is, ms, imgs = (as_shards(x, mesh, 2) for x in (I, m, img))
            loss = reg = gI = None
            for it in range(lddmm_steps):
                last = it == lddmm_steps - 1
                with torch.enable_grad():
                    m_ = Sharded([x.detach().requires_grad_(True) for x in ms], 2, mesh)
                    I_ = Sharded([x.detach().requires_grad_(last) for x in Is], 2, mesh)
                    with span("lt.loss"):
                        loss, reg = sharded_atlas_loss(
                            metric, I_, m_, Sharded(imgs, 2, mesh), mesh, reg_weight=reg_weight,
                            num_steps=integration_steps, axis_name=axis_name,
                            checkpoints=checkpoints, mask=mask)
                    with span("lt.backward"):
                        grads = torch.autograd.grad(loss, [*m_, *I_] if last else list(m_))
                gm = list(grads[:len(ms)])
                with span("lt.descend"), torch.no_grad():
                    p = flat.flat(Sharded(gm, 2, mesh)) if momentum_preconditioning else gm
                    ms = [x.detach() - learning_rate_pose * g for x, g in zip(ms, p)]
                if last:
                    gI = list(grads[len(ms):])
            return join_like(ms, m, 2), join_like(gI, I, 2), loss.detach(), reg.detach()

    return step


# ---------------------------------------------------------------------------
# Atlas building
# ---------------------------------------------------------------------------


def _write_back(dst, m, n):
    """Copy the first ``n`` rows of the updated momenta ``m`` (a tensor, or
    a mesh's :class:`Sharded`) into the minibatch's host array ``dst`` in
    place.  A new host array each minibatch is allocated and faulted in
    page by page during the copy: on an H100's host, 0.56-0.89 s for a
    128^3 b50 minibatch's 1.2 GB, against 0.16-0.23 s in place."""
    if isinstance(m, torch.Tensor):
        torch.from_numpy(dst).copy_(m[:n])
    else:
        dst[...] = _host(m)[:n]


def _torch_dtype(dtype):
    """The torch dtype of a numpy dtype, a dtype name or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype if isinstance(dtype, str) else np.dtype(dtype).name)


def lddmm_atlas(dataset, I0=None, num_epochs=500, batch_size=10, lddmm_steps=1,
                lddmm_integration_steps=5, image_update_freq=0, reg_weight=1e2,
                learning_rate_pose=2e2, learning_rate_image=1e4, metric=None,
                momentum_shape=None, image_shape=None, momentum_preconditioning=False,
                checkpoint_format=None, gradient_checkpointing=False, loader_workers=0,
                loader_mode="thread", dataloader_cache=None, keep_data_on_device=False,
                image_dtype=None, ms=None, mesh=None, spatial_shard=False, progress_bar=True,
                dtype=np.float32, device=None):
    """Functional atlas building (see :class:`LDDMMAtlasBuilder`).  Returns
    ``(I, ms, epoch_losses, epoch_reg_terms, iter_losses, iter_reg_terms)``."""
    builder = LDDMMAtlasBuilder(
        dataset, I0=I0, ms=ms, num_epochs=num_epochs, batch_size=batch_size,
        lddmm_steps=lddmm_steps, lddmm_integration_steps=lddmm_integration_steps,
        image_update_freq=image_update_freq, reg_weight=reg_weight,
        learning_rate_pose=learning_rate_pose, learning_rate_image=learning_rate_image,
        metric=metric, momentum_shape=momentum_shape, image_shape=image_shape,
        momentum_preconditioning=momentum_preconditioning,
        checkpoint_format=checkpoint_format, gradient_checkpointing=gradient_checkpointing,
        loader_workers=loader_workers, loader_mode=loader_mode,
        dataloader_cache=dataloader_cache, keep_data_on_device=keep_data_on_device,
        image_dtype=image_dtype, device=device, mesh=mesh, spatial_shard=spatial_shard,
        progress_bar=progress_bar, dtype=dtype,
    )
    builder.run()
    return (builder.I, builder.ms, builder.epoch_losses, builder.epoch_reg_terms,
            builder.iter_losses, builder.iter_reg_terms)


class LDDMMAtlasBuilder:
    """Stateful LDDMM atlas builder: the JAX package's constructor and
    methods.

    Each epoch runs the atlas step (:func:`make_lddmm_atlas_step`) on every
    minibatch of ``dataset`` in order, accumulates the atlas gradient and
    updates the atlas every ``image_update_freq`` iterations (0: once an
    epoch).  The momenta live on the host as one numpy array a minibatch
    and stream through the device with its images (``keep_data_on_device``:
    both are staged once and stay there).  ``device``: a torch device, the
    first CUDA card when None (no fallback to the CPU; pass ``"cpu"`` for
    the plain versions there).  ``dtype``: of the atlas, the momenta and
    the computation; ``image_dtype``: of the images on the device
    (``"bfloat16"`` halves their memory and transfers, and the loss
    computes in ``dtype``).  ``loader_workers`` threads stage the next
    minibatch while the current step computes; with ``loader_mode=
    "process"`` as many worker processes read its images from the host
    (:class:`.data.ProcessPrefetcher`).  ``dataloader_cache``: a directory
    for the minibatches' read-ahead cache (:class:`.native.NativeBatchCache`,
    or :class:`.data.CachedDataLoader` where no ``g++`` is found).

    Parallel runs, as the JAX package's (:mod:`.parallel`):

    * ``mesh`` (a :class:`.parallel.mesh.Mesh`; ``device`` is then its
      first entry): each minibatch is padded to a multiple of the mesh size
      (the padded subjects masked out) and split over the mesh, the atlas
      copied to each entry and its gradient summed on the first;
    * several processes (a ``torch.distributed`` process group, one device
      each; ``world_size`` and ``rank`` are read from the group, as the JAX
      package reads ``jax.process_count()``): each process owns the
      interleaved subjects ``rank, rank + world, ...`` and runs the same
      number of iterations (a process whose shard ran out feeds all-masked
      dummy minibatches); each iteration's loss is normalised by the
      subjects of the global batch, and the loss and the atlas gradient
      are summed over the processes, so that every process holds the same
      atlas.  Checkpoints and outputs are per rank (``{rank}``);
    * ``spatial_shard`` (with a ``mesh``, one process, momenta on the image
      grid, X and Y divisible by the mesh size): images, momenta and the
      atlas lie on the mesh as X slabs (:class:`.parallel.mesh.Sharded`;
      ``I`` is one) and the step is the halo-exchange shooting
      (:func:`make_lddmm_atlas_step` with ``spatial_mesh``).

    The arguments become members, frozen after :meth:`initialize`.
    """

    def __init__(self, dataset, I0=None, ms=None, num_epochs=500, batch_size=10,
                 lddmm_steps=1, lddmm_integration_steps=5, image_update_freq=0,
                 reg_weight=1e2, learning_rate_pose=2e2, learning_rate_image=1e4,
                 metric=None, momentum_shape=None, image_shape=None,
                 momentum_preconditioning=False, checkpoint_format=None,
                 gradient_checkpointing=False, loader_workers=0, loader_mode="thread",
                 dataloader_cache=None, keep_data_on_device=False, image_dtype=None,
                 device=None, world_size=1, rank=0, mesh=None, spatial_shard=False,
                 progress_bar=True, dtype=np.float32):
        args = dict(locals())
        self._initialized = False
        self._initvars = []
        for k, v in args.items():
            if k != "self":
                setattr(self, k, v)
                self._initvars.append(k)

    def __setattr__(self, k, v):
        if (k not in ("_initvars", "_initialized") and getattr(self, "_initialized", False)
                and k in getattr(self, "_initvars", ())):
            raise Exception(
                f"Member {k} was set in constructor and cannot be overwritten after "
                "initialization"
            )
        self.__dict__[k] = v

    # -- initialization ----------------------------------------------------
    def initialize(self):
        if not self._initialized:
            self._init_batches()
            self._init_atlas_image()
            self._init_metric()
            self._init_losses()
            self._init_momenta()
            self._init_step()
            self._iteration = 0
            self._epoch = 0
            self._initialized = True

    def _init_batches(self):
        from .data import CachedDataLoader, batch_iterator, dataset_length
        from .parallel import process_shard_indices, shard_sizes

        if self.loader_mode not in ("thread", "process"):
            raise ValueError(f"loader_mode must be 'thread' or 'process', not {self.loader_mode!r}")
        self._device = (torch_device(self.device) if self.mesh is None
                        else self.mesh.devices[0])
        # several processes: each owns an interleaved shard of the subjects;
        # batch_size is per process
        self._world = process_count()
        self._rank = process_index()
        n_total = dataset_length(self.dataset)
        self._num_examples = n_total  # the global count (loss normalisation)
        indices = self._global_real = None
        if self._world > 1:
            indices = process_shard_indices(n_total, self._world, self._rank)
            # iteration counts agree across processes: a process whose shard
            # ran out feeds all-masked dummy minibatches
            per_proc = shard_sizes(n_total, self._world)
            bs = self.batch_size
            self._n_iters = max(-(-s // bs) for s in per_proc)
            # the real subjects of each iteration's global batch (the same on
            # every process, with no communication)
            self._global_real = [sum(max(0, min(bs, s - i * bs)) for s in per_proc)
                                 for i in range(self._n_iters)]
        it = batch_iterator(self.dataset, self.batch_size, dtype=self.dtype, indices=indices)
        if self.dataloader_cache is not None:
            # the read-ahead cache, or where no g++ is found to build it, the
            # cache of .npy files; a failed build or read raises
            from .native import NativeBatchCache, native_available

            cache = NativeBatchCache if native_available() else CachedDataLoader
            self._batches = cache(it, cache_dir=self.dataloader_cache,
                                  progress_bar=self.progress_bar)
        else:
            self._batches = list(it)
        if self._world == 1:
            self._n_iters = len(self._batches)

    def _init_atlas_image(self):
        from .data import batch_average

        if self.I0 is None and self._world > 1:
            # the global mean over every process's shard
            from .parallel import allsum_hosts

            lsum = None
            count = 0
            for b in self._batches:
                b = np.asarray(b)
                part = b.astype(np.float64).sum(axis=0)
                lsum = part if lsum is None else lsum + part
                count += b.shape[0]
            tot = allsum_hosts(np.concatenate([lsum.ravel(), [np.float64(count)]]))
            I0 = (tot[:-1] / tot[-1]).reshape(lsum.shape)
        elif self.I0 is None:
            I0 = batch_average(self._batches, progress_bar=self.progress_bar)
        else:
            I0 = _host(self.I0)
        I0 = np.asarray(I0, dtype=self.dtype).squeeze()  # shaped (1, 1, *spatial) below
        self.I = torch.from_numpy(np.ascontiguousarray(I0[None, None])).to(self._device)
        if self.image_shape is not None and tuple(self.I.shape[2:]) != tuple(self.image_shape):
            self.I = regrid(self.I, shape=tuple(self.image_shape))
        self._image_grad_accum = torch.zeros_like(self.I)
        self._image_iters = 0

    def _init_metric(self):
        if self.metric is None:
            self.metric = FluidMetric([0.1, 0.0, 0.01])

    def _init_losses(self):
        for k in ("epoch_losses", "epoch_reg_terms", "iter_losses", "iter_reg_terms"):
            if k not in self.__dict__:
                setattr(self, k, [])

    def _init_momenta(self):
        dim = self.I.dim() - 2
        if self.momentum_shape is None:
            self.momentum_shape = tuple(self.I.shape[2:])
        self.momentum_shape = tuple(self.momentum_shape)
        if self.ms is None:
            self.ms = [np.zeros((img.shape[0], dim) + self.momentum_shape, dtype=self.dtype)
                       for img in self._batches]
        else:  # a streamed builder writes its updates back into its own copies
            own = np.asarray if self.keep_data_on_device else np.array
            self.ms = [own(_host(m), dtype=self.dtype) for m in self.ms]

    def _init_step(self):
        from .parallel import data_sharding, spatial_sharding

        kw = dict(
            reg_weight=self.reg_weight,
            learning_rate_pose=self.learning_rate_pose,
            lddmm_steps=self.lddmm_steps,
            integration_steps=self.lddmm_integration_steps,
            momentum_preconditioning=self.momentum_preconditioning,
            checkpoints=self.gradient_checkpointing,
        )
        self._sharding = None  # how minibatches lie on the mesh
        self._pad_multiple = 1
        # minibatches padded and masked: split over a mesh, or every process
        # staging the same number of rows
        self._data_parallel = not self.spatial_shard and (self.mesh is not None
                                                          or self._world > 1)
        if self.spatial_shard:
            # volumes too large for one device: the X axis of images, momenta
            # and the atlas split over the mesh; the batch stays whole
            if self.mesh is None:
                raise ValueError("spatial_shard=True requires a mesh (pass mesh=get_mesh())")
            if self._world > 1:
                raise ValueError(
                    "spatial_shard is single-process (one controller over the mesh); use "
                    "multi-process DP without spatial_shard"
                )
            sp = tuple(self.I.shape[2:])
            if tuple(self.momentum_shape) != sp:
                raise ValueError(
                    "spatial_shard requires momenta and images on the same grid "
                    f"(got {tuple(self.momentum_shape)} vs {sp})"
                )
            n = self.mesh.size
            if len(sp) != 3 or sp[0] % n or sp[1] % n:
                raise ValueError(
                    f"spatial_shard needs 3D X/Y divisible by the mesh size {n} (got {sp})"
                )
            self._step = make_lddmm_atlas_step(self.metric, spatial_mesh=self.mesh, **kw)
            self._sharding = spatial_sharding(self.mesh, 5)
            self.I = self._sharding.put(self.I)
            self._image_grad_accum = shardwise(torch.zeros_like, self.I)
        else:
            self._step = make_lddmm_atlas_step(self.metric, image_shape=tuple(self.I.shape[2:]),
                                               **kw)
            if self.mesh is not None:
                self._sharding = data_sharding(self.mesh)
                self._pad_multiple = self.mesh.size
        # several processes: every process stages the same number of rows
        self._local_rows = (-(-self.batch_size // self._pad_multiple) * self._pad_multiple
                            if self._world > 1 else None)

    # -- persistence (HDF5, the JAX package's schema) -----------------------
    def _momenta_host(self):
        """Each minibatch's momenta as a host array of its real (unpadded)
        subjects, this process's."""
        out = []
        cache = getattr(self, "_dev_cache", {})
        for i, m in enumerate(self.ms):
            m = _host(m)
            if self.keep_data_on_device and i in cache:
                m = m[:cache[i][3]]
            out.append(m)
        return out

    def save_momenta(self, handle):
        ms_host = self._momenta_host()
        n = sum(m.shape[0] for m in ms_host)
        hms = handle.create_dataset("momenta", shape=(n, *ms_host[0].shape[1:]),
                                    dtype=np.float32)
        i = 0
        batch_sizes = []
        for m in ms_host:
            hms[i:i + m.shape[0], ...] = m.astype(np.float32)
            i += m.shape[0]
            batch_sizes.append(m.shape[0])
        hms.attrs["batch_sizes"] = batch_sizes

    def save(self, filename):
        import h5py

        with h5py.File(filename, "w") as f:
            f.create_dataset("atlas", data=_host(self.I))
            self.save_momenta(f)
            f.create_dataset("epoch_losses", data=np.asarray(self.epoch_losses))
            f.create_dataset("epoch_reg_terms", data=np.asarray(self.epoch_reg_terms))
            f.create_dataset("iter_losses", data=np.asarray(self.iter_losses))
            f.create_dataset("iter_reg_terms", data=np.asarray(self.iter_reg_terms))

    def load_momenta(self, handle):
        self.ms = []
        i = 0
        for s in handle["momenta"].attrs["batch_sizes"]:
            self.ms.append(np.asarray(handle["momenta"][i:i + s, ...]))
            i += s

    def load(self, filename, load_image=True, load_momenta=True, load_losses=True):
        import h5py

        with h5py.File(filename, "r") as f:
            if load_image:
                self.I0 = np.asarray(f["atlas"])
            if load_momenta:
                self.load_momenta(f)
            if load_losses:
                self.epoch_losses = list(f["epoch_losses"])
                self.epoch_reg_terms = list(f["epoch_reg_terms"])
                self.iter_losses = list(f["iter_losses"])
                self.iter_reg_terms = list(f["iter_reg_terms"])

    # -- training loop ------------------------------------------------------
    def update_base_image(self, force=False):
        if (self._image_iters < self.image_update_freq and not force) or self._image_iters == 0:
            return
        with span("lt.update_atlas"):
            # the mean gradient of the iterations since the last update
            n = float(self._image_iters)
            self.I = shardwise(lambda I, g: I - self.learning_rate_image * (g / n), self.I,
                               self._image_grad_accum)
            self._image_grad_accum = shardwise(torch.zeros_like, self.I)
            self._image_iters = 0

    def _put(self, x, dtype=None):
        """``x`` (an array or a tensor) on the builder's device, or laid out
        on its mesh (split along the batch or along X), cast on the host to
        ``dtype`` when given."""
        from .parallel import put_global

        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        if dtype is not None:
            t = t.to(dtype)
        _count("lt.stage.bytes", t.numel() * t.element_size())
        return put_global(t, self._device if self._sharding is None else self._sharding)

    def _pad_rows(self, x):
        """Pad a host minibatch: to a multiple of the mesh size (one process,
        the last subject repeated), or to the fixed row count of every
        process (several, zeros)."""
        from .parallel import pad_batch_to_multiple

        if self._local_rows is None:
            return pad_batch_to_multiple(x, self._pad_multiple)[0]
        n, rows = x.shape[0], self._local_rows
        if n == rows:
            return x
        return np.concatenate([x, np.zeros((rows - n,) + x.shape[1:], dtype=x.dtype)], axis=0)

    def _host_batch(self, batch_index):
        """``(img, m)`` of one minibatch on the host: empty when this
        process's shard has fewer minibatches than the global iteration
        count (the dummy batch then holds only padding)."""
        if batch_index < len(self._batches):
            pf = getattr(self, "_img_prefetch", None)
            img = pf.get(batch_index) if pf is not None else self._batches[batch_index]
            return img, self.ms[batch_index]
        if len(self._batches):
            item = tuple(np.asarray(self._batches[0]).shape[1:])
        else:
            item = tuple(self.I.shape[1:])
        dim = len(self.momentum_shape)
        return (np.zeros((0,) + item, dtype=self.dtype),
                np.zeros((0, dim) + tuple(self.momentum_shape), dtype=self.dtype))

    def _staged(self, batch_index):
        """``(img, m, mask, n)`` of one minibatch on the device (or its mesh),
        ``n`` its real subjects and ``mask`` their 0/1 weights over the
        padded rows (None where nothing is padded: one process, no mesh).
        The images come through the process prefetcher when there is one;
        the momenta stream from the host.  With ``keep_data_on_device`` both
        are staged at the first use and stay, ``ms[batch_index]`` holding
        the device tensor."""
        image_dtype = None if self.image_dtype is None else _torch_dtype(self.image_dtype)
        if self.keep_data_on_device:
            if not hasattr(self, "_dev_cache"):
                self._dev_cache = {}
            if batch_index not in self._dev_cache:
                self._dev_cache[batch_index] = list(self._stage(batch_index, image_dtype))
                if batch_index < len(self.ms):
                    self.ms[batch_index] = self._dev_cache[batch_index][1]
            return tuple(self._dev_cache[batch_index])
        return self._stage(batch_index, image_dtype)

    def _stage(self, batch_index, image_dtype):
        with span("lt.stage"):
            img, m = self._host_batch(batch_index)
            n = img.shape[0]
            if not self._data_parallel:
                return self._put(img, image_dtype), self._put(m), None, n
            img, m = self._pad_rows(np.asarray(img)), self._pad_rows(np.asarray(m))
            mask = np.zeros(img.shape[0], dtype=self.dtype)
            mask[:n] = 1.0
            return self._put(img, image_dtype), self._put(m), self._put(mask), n

    def _stage_async(self, batch_index):
        """Stage a minibatch on a thread of the loader pool (a Future), so
        that its host read and copy to the device overlap the current step;
        with ``loader_mode="process"`` its images are first submitted to the
        worker processes of a :class:`.data.ProcessPrefetcher` (forked at the
        first submit), which own the read.  None when ``loader_workers`` is
        0 or the data stays on the device."""
        if not self.loader_workers or self.keep_data_on_device:
            return None
        if self.loader_mode == "process" and getattr(self, "_img_prefetch", None) is None:
            from .data import ProcessPrefetcher

            self._img_prefetch = ProcessPrefetcher(self._batches,
                                                   workers=int(self.loader_workers))
        if getattr(self, "_img_prefetch", None) is not None and batch_index < len(self._batches):
            # before the staging threads start: the first submit forks
            self._img_prefetch.submit(batch_index)
        if getattr(self, "_stage_pool", None) is None:
            from concurrent.futures import ThreadPoolExecutor

            self._stage_pool = ThreadPoolExecutor(max_workers=int(self.loader_workers))
        return self._stage_pool.submit(self._staged, batch_index)

    def iteration(self, batch_index, staged=None):
        with span("lt.iteration"):
            img, m, mask, n = staged if staged is not None else self._staged(batch_index)
            if self._global_real is None:
                n_global = n
                m, gI, loss, reg = self._step(self.I, m, img, mask)
            else:  # the real subjects of the global batch (over every process)
                n_global = self._global_real[batch_index]
                m, gI, loss, reg = self._step(self.I, m, img, mask, count=n_global)
            real = batch_index < len(self.ms)
            if self.keep_data_on_device:
                self._dev_cache[batch_index][1] = m
                if real:
                    self.ms[batch_index] = m
            elif real:
                _write_back(self.ms[batch_index], m, n)
            self._image_grad_accum = shardwise(torch.add, self._image_grad_accum, gI)
            self._image_iters += 1
            if self.image_update_freq > 0:
                self.update_base_image()
            # the step's loss is the global minibatch's mean; weighted so that
            # an epoch sums to the dataset's mean
            norm = n_global / self._num_examples
            with span("lt.read.loss"):
                loss = float(loss)
            with span("lt.read.reg"):
                reg = float(reg)
            return loss * norm, reg * norm

    def epoch(self):
        epoch_loss = 0.0
        epoch_reg_term = 0.0
        n_batches = self._n_iters
        it = range(n_batches)
        if self.progress_bar:
            it = progress(it, desc="iter")
        prefetched = None
        for self._iteration, bi in enumerate(it):
            staged = prefetched.result() if prefetched is not None else None
            # queue the next minibatch's staging before this step
            prefetched = self._stage_async(bi + 1) if bi + 1 < n_batches else None
            iter_loss, iter_reg = self.iteration(bi, staged=staged)
            self.iter_losses.append(iter_loss)
            self.iter_reg_terms.append(iter_reg)
            epoch_loss += iter_loss
            epoch_reg_term += iter_reg
        self.update_base_image(force=True)
        if self.checkpoint_format is not None:
            # per rank (the momenta are the rank's); with no {rank}
            # placeholder only rank 0 writes
            per_rank = "{rank}" in self.checkpoint_format
            if self._world == 1 or per_rank or self._rank == 0:
                if self._world > 1 and not per_rank:
                    import warnings

                    warnings.warn(
                        "multi-process run with no {rank} placeholder in checkpoint_format: "
                        "the saved file contains ONLY rank 0's momenta shard (a fraction of "
                        "the dataset's subjects). Add '{rank}' to save every process's shard.",
                        stacklevel=2,
                    )
                self.save(self.checkpoint_format.format(epoch=self._epoch, rank=self._rank))
        return epoch_loss, epoch_reg_term

    def run(self):
        self.initialize()
        epbar = range(self.num_epochs)
        if self.progress_bar:
            epbar = progress(epbar)
        try:
            for self._epoch in epbar:
                epoch_loss, epoch_reg_term = self.epoch()
                self.epoch_losses.append(epoch_loss)
                self.epoch_reg_terms.append(epoch_reg_term)
                if hasattr(epbar, "set_postfix"):
                    epbar.set_postfix(epoch_loss=epoch_loss, epoch_reg=epoch_reg_term)
        finally:
            self.close_loaders()

    def close_loaders(self):
        """Shut the staging threads and the prefetcher's worker processes
        down (idempotent; they start again on demand)."""
        pool = getattr(self, "_stage_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
            self._stage_pool = None
        pf = getattr(self, "_img_prefetch", None)
        if pf is not None:
            pf.close()
            self._img_prefetch = None


class _Tool(Tool):
    """Diffeomorphic registration methods using LDDMM"""

    module_name = "lagomorph_tpu_torch lddmm"
    subcommands = ["atlas"]

    def atlas(self):
        """
        Build LDDMM atlas from HDF5 image dataset.

        Writes an HDF5 file with datasets: atlas, momenta, epoch_losses,
        epoch_reg_terms, iter_losses, iter_reg_terms; provenance attrs are
        stamped on 'atlas'.
        """
        import sys

        parser = self.new_parser("atlas")
        dg = parser.add_argument_group("data parameters")
        dg.add_argument("input", type=str, help="Path to input image HDF5 file")
        dg.add_argument("--force_dim", default=None, type=int,
                        help="Force dimension of images instead of determining based on "
                        "dataset shape")
        dg.add_argument("--h5key", "-k", default="images",
                        help="Name of dataset in input HDF5 file")
        dg.add_argument("output", type=str, help="Path to output HDF5 file")
        dg.add_argument("--checkpoint", default=None, type=str,
                        help="Format for HDF5 checkpoints, with {epoch} placeholder")
        dg.add_argument("--loader_workers", default=0, type=int,
                        help="Host threads staging the next minibatch (host read and "
                        "copy to the device) while the current step computes; 0 stages "
                        "synchronously")
        dg.add_argument("--loader_mode", default="thread", choices=["thread", "process"],
                        help="How loader_workers prefetch: 'thread' stages in threads; "
                        "'process' adds forked worker processes that read the images "
                        "and hand them over through shared memory")
        dg.add_argument("--dataloader_cache", default=None, type=str,
                        help="Directory in which to cache minibatches for faster "
                        "dataloading after the first pass (raw files with background "
                        "read-ahead, built with g++; .npy files where g++ is missing)")
        ag = parser.add_argument_group("algorithm parameters")
        ag.add_argument("--initial_atlas", default=None, type=str,
                        help="Path to h5 file with which to initialize image and momenta")
        ag.add_argument("--num_epochs", default=1000, type=int, help="Number of epochs")
        ag.add_argument("--batch_size", default=50, type=int, help="Batch size")
        ag.add_argument("--precondition_momentum", action="store_true",
                        help="Precondition momentum gradients with the metric operator")
        ag.add_argument("--image_update_freq", default=0, type=int,
                        help="Update base image every N iterations. 0 for once per epoch")
        ag.add_argument("--lddmm_steps", default=1, type=int,
                        help="LDDMM steps per iteration")
        ag.add_argument("--lddmm_integration_steps", default=5, type=int,
                        help="Euler integration steps for geodesic shooting")
        ag.add_argument("--deformation_downscale", default=1, type=int,
                        help="Downscale factor for the momenta/deformation grid")
        ag.add_argument("--image_upscale", default=1, type=int,
                        help="Upscale factor for the atlas image grid")
        ag.add_argument("--gradient_checkpointing", action="store_true",
                        help="Rematerialize the shooting loop in the backward pass")
        ag.add_argument("--keep_data_on_device", action="store_true",
                        help="Stage all batches and momenta in device memory once "
                        "(fastest when the dataset fits on the device)")
        ag.add_argument("--image_dtype", default=None, type=str,
                        choices=["bfloat16", "float32"],
                        help="Storage dtype for staged images (bfloat16 halves "
                        "on-device image memory and transfer bytes; compute stays f32)")
        ag.add_argument("--spatial_shard", action="store_true",
                        help="Shard the X axis of images/momenta/atlas over the device mesh "
                        "(halo-exchange shooting through the kernels on each slab and the "
                        "pencil fluid solve), for volumes too large for one device; the "
                        "batch stays whole")
        ag.add_argument("--reg_weight", default=1e-1, type=float,
                        help="Deformation regularization")
        ag.add_argument("--learning_rate_m", default=1e-3, type=float,
                        help="Momenta learning rate")
        ag.add_argument("--learning_rate_I", default=1e5, type=float,
                        help="Atlas learning rate")
        mg = parser.add_argument_group("metric parameters")
        Metric.add_args(mg)
        self._compute_args(parser)
        args = parser.parse_args(sys.argv[2:])
        self._initialize_compute(args)

        from .data import H5Dataset

        dataset = H5Dataset(args.input, key=args.h5key, force_dim=args.force_dim)
        im0 = dataset[0]
        momentum_shape = None
        image_shape = None
        if args.deformation_downscale != 1:
            momentum_shape = [s // args.deformation_downscale for s in im0.shape[1:]]
        if args.image_upscale != 1:
            image_shape = [s * args.image_upscale for s in im0.shape[1:]]
        del im0

        builder = LDDMMAtlasBuilder(
            dataset,
            num_epochs=args.num_epochs,
            batch_size=args.batch_size,
            lddmm_steps=args.lddmm_steps,
            lddmm_integration_steps=args.lddmm_integration_steps,
            image_update_freq=args.image_update_freq,
            momentum_shape=momentum_shape,
            image_shape=image_shape,
            reg_weight=args.reg_weight,
            momentum_preconditioning=args.precondition_momentum,
            checkpoint_format=args.checkpoint,
            gradient_checkpointing=args.gradient_checkpointing,
            keep_data_on_device=args.keep_data_on_device,
            image_dtype=args.image_dtype,
            loader_workers=args.loader_workers,
            loader_mode=args.loader_mode,
            dataloader_cache=args.dataloader_cache,
            metric=Metric.from_args(args),
            learning_rate_pose=args.learning_rate_m,
            learning_rate_image=args.learning_rate_I,
            device=self.device,
            mesh=self.mesh,
            spatial_shard=args.spatial_shard,
            progress_bar=self.rank == 0,
        )
        if args.initial_atlas is not None:
            builder.load(args.initial_atlas.format(rank=self.rank))
        builder.run()
        # per-rank outputs (the momenta are the rank's); with no {rank}
        # placeholder only rank 0 writes
        if self.world_size > 1 and "{rank}" not in args.output:
            if self.rank != 0:
                return
            import warnings

            warnings.warn(
                "multi-process run with no {rank} placeholder in --output: the saved file "
                "contains ONLY rank 0's momenta shard. Add '{rank}' to the output path to "
                "save every process's shard.",
                stacklevel=2,
            )
        args.output = args.output.format(rank=self.rank)
        builder.save(args.output)

        import h5py

        with h5py.File(args.output, "a") as f:
            self._stamp_dataset(f["atlas"], args)
