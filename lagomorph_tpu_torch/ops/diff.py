"""Finite-difference Jacobian times a vector field, and its adjoint.

Port of ``lagomorph_tpu/ops/diff.py``: the pointwise contraction of the
clamped central-difference Jacobian of one field with another field
(:func:`jacobian_times_vectorfield`), and the exact adjoint of that map in
the differentiated field (:func:`jacobian_times_vectorfield_adjoint`).
"""
from __future__ import annotations

import torch

from .boundary import diff_central, diff_central_adjoint


def _check_spatial(v):
    for n in v.shape[2:]:
        if n < 2:
            raise ValueError(
                "Jacobian times vectorfield not implemented for 'thin' dimensions"
            )


def jacobian_times_vectorfield(v: torch.Tensor, w: torch.Tensor,
                               displacement: bool = True,
                               transpose: bool = False) -> torch.Tensor:
    """``(Dv) w`` pointwise, or ``(Dv)^T w`` if ``transpose``.

    ``v``: ``(N, C, *spatial)`` field to differentiate (``C == dim`` for the
    ``displacement`` or ``transpose`` modes); ``w``: ``(N, dim, *spatial)``.
    With ``displacement`` the identity is added to the Jacobian diagonal
    (``v`` is the displacement of a deformation)."""
    _check_spatial(v)
    dim = w.shape[1]
    nc = v.shape[1]
    if w.shape[2:] != v.shape[2:]:
        raise ValueError("v and w must share spatial shape")
    if (displacement or transpose) and nc != dim:
        raise ValueError("displacement/transpose modes require v to be a vector field")

    # J[c][a] = D_a v_c (+ delta_ca if displacement)
    outs = []
    for i in range(dim if transpose else nc):
        acc = None
        for j in range(dim):
            c, a = (j, i) if transpose else (i, j)
            g = diff_central(v[:, c], axis=1 + a)
            term = ((g + 1.0) if displacement and a == c else g) * w[:, c if transpose else a]
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.stack(outs, dim=1)


def jacobian_times_vectorfield_adjoint(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Adjoint of ``v -> (Dv) w`` in the ``v`` slot, applied to ``z``:
    ``out_c = sum_a D_a^T (w_a * z_c)``, with ``D_a^T`` the exact transpose
    of the clamped central difference (one-sided at the edges)."""
    _check_spatial(z)
    dim = w.shape[1]
    outs = []
    for c in range(z.shape[1]):
        acc = None
        for a in range(dim):
            term = diff_central_adjoint(w[:, a] * z[:, c], axis=1 + a)
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.stack(outs, dim=1)
