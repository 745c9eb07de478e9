"""Model families built on the port's ops and shooting.

Port of ``lagomorph_tpu/models``:

* :mod:`registration`: pairwise affine, rigid and LDDMM registration by
  gradient descent (``lagomorph_tpu/models/registration.py``);
* :mod:`deep_atlas`: ``MomentumNet`` and ``DeepLDDMMAtlas``, a CNN that
  predicts the momenta, trained with the atlas image through the
  differentiable shooting (``lagomorph_tpu/models/deep_atlas.py``).
"""
from .registration import affine_register, rigid_register, lddmm_register
from .deep_atlas import MomentumNet, DeepLDDMMAtlas

__all__ = [
    "affine_register",
    "rigid_register",
    "lddmm_register",
    "MomentumNet",
    "DeepLDDMMAtlas",
]
