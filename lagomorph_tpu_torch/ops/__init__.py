"""Grid operators of the port: sampling and splatting, finite differences,
the fluid operator, interpolation and the global warp mode, affine warps,
regridding, and the hand-written kernels under ``kernels``."""
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
from .interp import (
    get_warp_mode,
    interp,
    interp_auto,
    interp_hessian_diagonal_image,
    set_warp_mode,
    splat,
)
from .sampling import (
    identity_grid,
    sample_displacement_bounded,
    sample_displacement_unit,
    sample_linear,
    splat_linear,
)

__all__ = [
    "affine_interp",
    "diff_central",
    "diff_central_adjoint",
    "fluid_operator",
    "get_warp_mode",
    "identity_grid",
    "interp",
    "interp_auto",
    "interp_hessian_diagonal_image",
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
    "set_warp_mode",
    "shift_clamp",
    "splat",
    "splat_linear",
]
