"""lagomorph_tpu_torch: the PyTorch and CUDA port of lagomorph_tpu.

The LDDMM atlas step in 3D and 2D: geodesic shooting of momenta to an
inverse deformation, the atlas warp, the atlas loss, its gradients and the
update of the momenta (``make_lddmm_atlas_step``), forward and backward on
hand-written Hopper kernels (``ops/kernels``, sources in ``csrc/``) for CUDA
tensors and on their plain PyTorch versions for CPU tensors: in 3D the
per-substep kernels of ``ops/kernels/epdiff_unit``, in 2D the whole-shoot
kernels of ``ops/kernels/shoot2d`` or, for a momentum mask or a fluid
metric with ``beta != 0``, the per-substep kernels of
``ops/kernels/epdiff2d``.  Tensors are NC(D)HW, as in the JAX package.
This package imports torch and numpy, never jax.
"""
from .ops import (
    diff_central,
    diff_central_adjoint,
    fluid_operator,
    identity_grid,
    interp,
    interp_auto,
    jacobian_times_vectorfield,
    jacobian_times_vectorfield_adjoint,
    sample_displacement_bounded,
    sample_displacement_unit,
    sample_linear,
    shift_clamp,
)
from .deform import identity, compose, compose_disp_vel
from .metric import FluidMetric
from .adjrep import Ad_star
from .lddmm import expmap, EPDiff_step, make_lddmm_atlas_step, shooting_regime_ok

from . import adjrep, convert, deform, lddmm, metric, ops

__version__ = "0.1.0"
