"""Carry state from the JAX package into the port.

The JAX package's state is numpy-convertible: ``np.asarray`` of its arrays,
or the datasets that ``LDDMMAtlasBuilder.save`` writes (``"atlas"`` and
``"momenta"``) and that ``affine atlas`` writes (``"atlas"``, ``"A"`` and
``"T"``).  These helpers turn it into the port's metric and tensors on
an explicit device and dtype.  Nothing here imports jax.
"""
from __future__ import annotations

import numpy as np
import torch

from .metric import FluidMetric

__all__ = ["to_tensor", "atlas_state", "atlas_state_from_saved", "affine_state_from_saved"]


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
