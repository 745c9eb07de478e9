"""Grid operators of the port: sampling, finite differences, the fluid
operator, interpolation, affine warps, regridding, and the hand-written
kernels under ``kernels``."""
from .affine import affine_interp, regrid
from .boundary import diff_central, diff_central_adjoint, shift_clamp
from .diff import jacobian_times_vectorfield, jacobian_times_vectorfield_adjoint
from .fluid import (
    fluid_operator,
    set_fluid_dft,
    set_fluid_fft_kernel,
    set_fluid_mxu_whole,
    set_fluid_packing,
)
from .interp import interp, interp_auto
from .sampling import (
    identity_grid,
    sample_displacement_bounded,
    sample_displacement_unit,
    sample_linear,
)

__all__ = [
    "affine_interp",
    "diff_central",
    "diff_central_adjoint",
    "fluid_operator",
    "identity_grid",
    "interp",
    "interp_auto",
    "regrid",
    "jacobian_times_vectorfield",
    "jacobian_times_vectorfield_adjoint",
    "sample_displacement_bounded",
    "sample_displacement_unit",
    "sample_linear",
    "set_fluid_dft",
    "set_fluid_fft_kernel",
    "set_fluid_mxu_whole",
    "set_fluid_packing",
    "shift_clamp",
]
