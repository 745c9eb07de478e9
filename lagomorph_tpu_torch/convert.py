"""Carry state from the JAX package into the port.

The JAX package's state is numpy-convertible: ``np.asarray`` of its arrays,
or the datasets that ``LDDMMAtlasBuilder.save`` writes (``"atlas"`` and
``"momenta"``) and that ``affine atlas`` writes (``"atlas"``, ``"A"`` and
``"T"``), or a flax ``MomentumNet``'s parameter tree.  These helpers turn
it into the port's metric, tensors on an explicit device and dtype, and
``state_dict``.  Nothing here imports jax.
"""
from __future__ import annotations

import numpy as np
import torch

from .metric import FluidMetric

__all__ = ["to_tensor", "atlas_state", "atlas_state_from_saved", "affine_state_from_saved",
           "momentum_net_state"]


def to_tensor(a, device, dtype=torch.float32) -> torch.Tensor:
    """A copy of a numpy-convertible array as a tensor on ``device``."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def atlas_state(params, atlas, momenta, device, dtype=torch.float32):
    """``(metric, I, m)``: the fluid metric for a JAX ``FluidMetric.params``
    tuple ``(alpha, beta, gamma)``, the atlas image ``(1, C, *spatial)`` and
    the momenta ``(N, dim, *spatial)`` from the JAX package's state."""
    return (FluidMetric(params), to_tensor(atlas, device, dtype),
            to_tensor(momenta, device, dtype))


def atlas_state_from_saved(saved, params, device, dtype=torch.float32, subjects=None):
    """:func:`atlas_state` from the datasets of a saved atlas builder.

    ``saved``: a mapping with the ``"atlas"`` and ``"momenta"`` datasets
    that ``LDDMMAtlasBuilder.save`` writes (an open ``h5py.File``, or a dict
    of arrays); ``subjects``: optional slice or index array of the momenta
    to load (all by default)."""
    momenta = saved["momenta"]
    momenta = momenta[...] if subjects is None else momenta[subjects]
    return atlas_state(params, saved["atlas"][...], momenta, device, dtype)


def affine_state_from_saved(saved, device, dtype=torch.float32):
    """``(I, A, T)``: the atlas image ``(1, 1, *spatial)`` and the
    per-subject transforms ``(N, dim, dim)`` (offsets from the identity)
    and ``(N, dim)`` from the datasets that ``affine atlas`` writes
    (``"atlas"``, ``"A"`` and ``"T"``; an open ``h5py.File``, or a dict of
    arrays), as tensors on ``device``."""
    return tuple(to_tensor(saved[k][...], device, dtype) for k in ("atlas", "A", "T"))


def momentum_net_state(params):
    """The ``state_dict`` of the port's ``models.MomentumNet`` holding the
    parameters of a flax ``MomentumNet``: ``params`` is its parameter tree
    (``{"params": {"Conv_i": {"kernel", "bias"}}}`` or the inner dict), of
    numpy-convertible arrays.  Each kernel ``(k..., in, out)`` becomes a
    weight ``(out, in, k...)``; both libraries' convolutions are
    cross-correlations, so nothing is flipped.  The tensors keep the
    arrays' dtype, on the host."""
    tree = params.get("params", params)
    names = sorted(tree, key=lambda k: int(k.rsplit("_", 1)[1]))
    state = {}
    for i, name in enumerate(names):
        kernel = np.asarray(tree[name]["kernel"])
        order = (kernel.ndim - 1, kernel.ndim - 2) + tuple(range(kernel.ndim - 2))
        state[f"convs.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.transpose(order)))
        state[f"convs.{i}.bias"] = torch.from_numpy(np.array(tree[name]["bias"]))
    return state
