"""lagomorph_tpu_torch: the PyTorch and CUDA port of lagomorph_tpu.

The LDDMM atlas builder (``LDDMMAtlasBuilder``, ``lddmm_atlas`` and
``python -m lagomorph_tpu_torch lddmm atlas``) on one device, on a device
mesh, over several processes or spatially sharded (``parallel``), over its atlas
step in 3D and 2D: geodesic shooting of momenta to an
inverse deformation, the atlas warp, the atlas loss, its gradients and the
update of the momenta (``make_lddmm_atlas_step``), forward and backward on
hand-written Hopper kernels (``ops/kernels``, sources in ``csrc/``) for CUDA
tensors and on their plain PyTorch versions for CPU tensors: in 3D the
per-substep kernels of ``ops/kernels/epdiff_unit``, in 2D the whole-shoot
kernels of ``ops/kernels/shoot2d`` or, for a momentum mask or a fluid
metric with ``beta != 0``, the per-substep kernels of
``ops/kernels/epdiff2d``.  The fluid solves of the 3D step run on K3
(``ops/kernels/fft_unit``) by default; the JAX package's selectors put them
on the radix-2 kernels K14/K15 (``set_fluid_fft_kernel("radix")``,
``ops/kernels/fft_radix``), the whole-volume kernel K16
(``set_fluid_mxu_whole``, ``ops/kernels/fft_whole``) or the plain
``torch.fft`` / DFT routes (``set_fluid_fft_kernel(False)``,
``set_fluid_packing``, ``set_fluid_dft``).  Tensors are NC(D)HW, as in the
JAX package.

The affine stack (``affine_interp``, the small-matrix and rigid helpers,
``affine_atlas``, ``StandardizedDataset`` and ``python -m
lagomorph_tpu_torch affine atlas`` / ``affine standardize``) runs as plain
PyTorch on the general gather, as the JAX package's runs on XLA's.  The
rest of the core API (``splat``, ``interp_hessian_diagonal_image``, the
adjoint actions of ``adjrep``, ``compose_vel_disp``, ``expmap_advect`` and
the global warp mode ``set_warp_mode``) and the models of ``models``
(``affine_register``, ``rigid_register``, ``lddmm_register``,
``MomentumNet``, ``DeepLDDMMAtlas``) run over the same ops and kernels.
The data tools (``data``: the datasets, the minibatch caches, the process
prefetcher behind the builders' ``loader_mode="process"``, the HDF5 and
Zarr files and ``python -m lagomorph_tpu_torch data``), the read-ahead
cache of ``native`` behind ``dataloader_cache``, ``profiling``, ``vis``
and :func:`set_debug_mode` complete the JAX package's API.  This package
imports torch and numpy, never jax; ``h5py``, ``zarr``, ``numexpr``,
``sklearn``, ``matplotlib`` and ``tqdm`` only where they are used.
"""
from .ops import (
    affine_interp,
    diff_central,
    diff_central_adjoint,
    fluid_operator,
    identity_grid,
    interp,
    interp_auto,
    interp_hessian_diagonal_image,
    regrid,
    jacobian_times_vectorfield,
    jacobian_times_vectorfield_adjoint,
    sample_displacement_bounded,
    sample_displacement_unit,
    sample_linear,
    set_fluid_dft,
    set_fluid_fft_kernel,
    set_fluid_mxu_whole,
    set_fluid_packing,
    set_warp_mode,
    shift_clamp,
    splat,
)
from .affine import (
    StandardizedDataset,
    affine_atlas,
    affine_inverse,
    det_2x2,
    invert_2x2,
    invert_3x3,
    rigid_inverse,
    rotation_exp_map,
)
from .deform import identity, compose, compose_disp_vel, compose_vel_disp
from .metric import FluidMetric, Metric
from .adjrep import ad, Ad, ad_star, Ad_star, ad_dagger, Ad_dagger, sym, sym_dagger
from .lddmm import (
    expmap,
    expmap_advect,
    EPDiff_step,
    EPDiff_steps,
    LDDMMAtlasBuilder,
    lddmm_atlas,
    make_lddmm_atlas_step,
    shooting_regime_ok,
)

from . import (adjrep, affine, convert, data, deform, lddmm, metric, models, native, ops,
               parallel, profiling, utils, vis)

__version__ = "0.1.0"


def set_debug_mode(mode=True):
    """Turn numerical debugging on (or off, ``mode=False``): every kernel
    launch synchronises the device and raises its CUDA error under the
    kernel's name, and every kernel wrapper, on the card or through its
    plain version on the CPU, raises ``FloatingPointError`` naming the
    kernel when an output holds a non-finite value.  The JAX package's
    counterpart turns on ``jax_debug_nans``.  The mode is global to the
    process and never switches a kernel to its plain version."""
    from .ops import kernels

    kernels.set_debug_mode(mode)
