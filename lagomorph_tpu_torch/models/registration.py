"""Pairwise image registration: affine, rigid, and LDDMM geodesic shooting.

Port of ``lagomorph_tpu/models/registration.py``.  Each JAX optimiser is a
``lax.scan`` of ``jax.value_and_grad`` and an SGD update; here it is a
Python loop of :func:`torch.autograd.grad` and the same update, on the
inputs' device.  ``losses`` holds the loss before each update, stacked on
the device: no iteration reads the host beyond what the shooting reads
(the hoisted path's flag, once an LDDMM iteration).
"""
from __future__ import annotations

import torch

from ..affine import rotation_exp_map
from ..deform import interp
from ..lddmm import expmap
from ..ops.affine import affine_interp

__all__ = ["affine_register", "rigid_register", "lddmm_register"]


def _mse(a, b):
    """Mean squared difference over every element of ``b`` (N·C·spatial)."""
    return torch.sum((a - b) ** 2) / b.numel()


def _descend(loss_fn, params, rates, num_iters, precondition=None):
    """``num_iters`` steps ``p <- p - rate * g`` of every tensor of
    ``params`` at once, ``g`` the gradient of ``loss_fn(*params)`` in it
    (``precondition(g)`` when given).  Returns the final parameters
    (detached) and the losses before each step, stacked."""
    params = [p.detach() for p in params]
    losses = []
    for _ in range(num_iters):
        with torch.enable_grad():
            leaves = [p.requires_grad_(True) for p in params]
            loss = loss_fn(*leaves)
            grads = torch.autograd.grad(loss, leaves)
        losses.append(loss.detach())
        with torch.no_grad():
            if precondition is not None:
                grads = [precondition(g) for g in grads]
            params = [p - rate * g for p, rate, g in zip(leaves, rates, grads)]
    if not losses:
        return params, params[0].new_zeros(0)
    return params, torch.stack(losses)


def affine_register(source, target, num_iters=200, learning_rate_A=1e-4, learning_rate_T=1e-2,
                    A0=None, T0=None):
    """Register ``source`` (``(1 or N, C, *spatial)``) to ``target``
    (``(N, C, *spatial)``) with a batched affine transform.  Returns ``(A,
    T, losses)``; the matrix applied is ``A + I``."""
    N = target.shape[0]
    dim = target.dim() - 2
    if A0 is None:
        A0 = target.new_zeros((N, dim, dim))
    if T0 is None:
        T0 = target.new_zeros((N, dim))
    eye = torch.eye(dim, dtype=source.dtype, device=source.device)

    def loss_fn(A, T):
        return _mse(affine_interp(source, A + eye, T), target)

    (A, T), losses = _descend(loss_fn, (A0, T0), (learning_rate_A, learning_rate_T), num_iters)
    return A, T, losses


def rigid_register(source, target, num_iters=200, learning_rate_v=1e-3, learning_rate_T=1e-2,
                   v0=None, T0=None):
    """Rigid registration by descent on rotation tangent vectors through
    ``rotation_exp_map``: ``v`` is a batch of angles ``(N,)`` in 2D, of
    axis-angle vectors ``(N, 3)`` in 3D.  Returns ``(v, T, losses)``."""
    N = target.shape[0]
    dim = target.dim() - 2
    if dim not in (2, 3):
        raise NotImplementedError("rigid_register supports 2D and 3D")
    if v0 is None:
        v0 = target.new_zeros((N,) if dim == 2 else (N, 3))
    if T0 is None:
        T0 = target.new_zeros((N, dim))

    def loss_fn(v, T):
        return _mse(affine_interp(source, rotation_exp_map(v), T), target)

    (v, T), losses = _descend(loss_fn, (v0, T0), (learning_rate_v, learning_rate_T), num_iters)
    return v, T, losses


def lddmm_register(source, target, metric, num_iters=100, learning_rate=1e-2, reg_weight=1e-1,
                   integration_steps=5, m0=None, momentum_preconditioning=False,
                   checkpoints=False, transport_mode=None, compose_mode=None):
    """Pairwise LDDMM registration by geodesic shooting from ``source`` to
    ``target`` (BASELINE.json config 3).  ``checkpoints``,
    ``transport_mode`` and ``compose_mode`` go to :func:`expmap`;
    ``momentum_preconditioning`` descends on ``metric.flat`` of the
    gradient.  The warp is :func:`interp`, the general gather, as in the
    JAX model.  Returns ``(m, phiinv, losses)``: the momenta, the final
    inverse deformation and the loss before each update."""
    N = target.shape[0]
    dim = target.dim() - 2
    if m0 is None:
        m0 = target.new_zeros((N, dim) + tuple(target.shape[2:]))

    def loss_fn(m):
        v = metric.sharp(m)  # shared with the peeled first integration step
        h = expmap(metric, m, num_steps=integration_steps, checkpoints=checkpoints,
                   transport_mode=transport_mode, compose_mode=compose_mode, v0=v)
        reg = reg_weight * torch.sum(v * m) / target.numel()
        return _mse(interp(source, h), target) + reg

    (m,), losses = _descend(loss_fn, (m0,), (learning_rate,), num_iters,
                            metric.flat if momentum_preconditioning else None)
    with torch.no_grad():
        phiinv = expmap(metric, m, num_steps=integration_steps, transport_mode=transport_mode,
                        compose_mode=compose_mode)
    return m, phiinv, losses
