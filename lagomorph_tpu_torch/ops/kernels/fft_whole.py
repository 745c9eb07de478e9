"""K16: the whole-volume fluid solve for ``beta == 0`` on packed pairs of
real fields in one launch (``csrc/fft_whole.cu``).

``y1 + i*y2 = ifftn(Mn * fftn(x1 + i*x2))`` over the three spatial axes on
the ``(2F, X, Y, Z)`` layout of K3 (:mod:`.fft_unit`), with the
natural-order multiplier ``Mn``.  Replaces ``lagomorph_tpu/ops/pallas/
fft_unit.py`` ``_whole_dft_kernel`` (``fluid_flat_mxu_whole``).  One
cooperative persistent launch per solve runs K3's passes as its phases,
with grid-wide barriers between them (their bodies are shared with K3,
``csrc/fft_plane.cuh``).  Three paths, chosen by shape in the kernel
(:func:`launch_config` says which):

* ``Y == Z`` in 64, 128 and ``X`` a power of two up to 256 (64^3, 128^3):
  three phases, whole (y, z) planes in registers z then y forward, then
  x-lines forward, times ``Mn`` and back, then the planes back;
* other power-of-two axes up to 256: five register line phases;
* any other shape: five tile phases through an ``(F, X, Y, Z)`` complex
  scratch, the only path that needs one (:func:`.fft_unit.needs_scratch`).

The register paths need no scratch, run K3's arithmetic in K3's order (so
they are bit-identical to K3) and move the field through memory three
times each way (five on the line path).  The bound at 64^3 b4 is 0.0078 ms
by bytes (the pairs and ``Mn`` read once, the result written once: 26 MB
at 3.35 TB/s); there the pairs, the result and ``Mn`` stay in the 50 MB L2
between phases.  Any axis lengths.  Its plain version is K3's,
:func:`.fft_unit.fluid_flat_plain` (the ``torch.fft`` packed solve), and,
the operator being self-adjoint, its backward is K16 on the cotangent.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, check_cuda_f32, checked, grad_needed, register, stream_of, use_kernel
from .fft_unit import fluid_flat_plain, needs_scratch

KERNEL = register(
    "fluid_whole",
    source="lagomorph_tpu_torch/csrc/fft_whole.cu",
    replaces="lagomorph_tpu/ops/pallas/fft_unit.py:602",
)


def _launch(x, Mn):
    F2, X, Y, Z = x.shape
    F = F2 // 2
    y = torch.empty_like(x)
    scratch = (torch.empty((F, X, Y, Z, 2), dtype=x.dtype, device=x.device)
               if needs_scratch(X, Y, Z) else None)
    _build.call(
        "lagomorph_fluid_whole",
        x[:F].data_ptr(), x[F:].data_ptr(), Mn.data_ptr(), y[:F].data_ptr(),
        y[F:].data_ptr(), None if scratch is None else scratch.data_ptr(), F, X, Y, Z,
        stream_of(x),
    )
    KERNEL.launches += 1
    return checked(KERNEL, y)


PATHS = ("plane", "line", "tile")


def launch_config(X: int, Y: int, Z: int) -> dict:
    """The launch K16 makes at spatial shape ``(X, Y, Z)`` on the current
    card: its path (``"plane"``, ``"line"`` or ``"tile"``), the cooperative
    grid's blocks, the threads of a block and its dynamic shared memory in
    bytes.  Builds the kernels on first use; launches nothing."""
    out = (ctypes.c_int * 4)()
    _build.call("lagomorph_fluid_whole_grid", X, Y, Z, ctypes.cast(out, ctypes.c_void_p))
    return {"path": PATHS[out[0]], "blocks": out[1], "threads": out[2], "smem": out[3]}


class _FluidWhole(torch.autograd.Function):
    """K16 under autograd; self-adjoint, so its backward is K16 on the
    cotangent (no gradient for the multiplier)."""

    @staticmethod
    def forward(ctx, x, Mn):
        ctx.save_for_backward(Mn)
        return _launch(x, Mn)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (Mn,) = ctx.saved_tensors
        return _launch(g.contiguous(), Mn), None


def fluid_whole(x: torch.Tensor, Mn: torch.Tensor) -> torch.Tensor:
    """K16: the packed-pair fluid solve in one launch.  ``x``: ``(2F, X, Y,
    Z)``, read as ``x[:F] + i*x[F:]``; ``Mn``: ``(X, Y, Z)``, real and even
    in k.  Returns ``y`` of the same layout.  The kernel on CUDA (float32,
    contiguous; differentiable through K16 itself), the plain version on
    the CPU."""
    if not use_kernel(x):
        return checked(KERNEL, fluid_flat_plain(x, Mn))
    check_cuda_f32("fluid_whole", x, Mn)
    if x.dim() != 4 or x.shape[0] % 2 or tuple(Mn.shape) != tuple(x.shape[1:]):
        raise ValueError(
            f"fluid_whole: x {tuple(x.shape)}, Mn {tuple(Mn.shape)}: want "
            "(2F, X, Y, Z) pairs and an (X, Y, Z) multiplier"
        )
    if grad_needed(x):
        return _FluidWhole.apply(x, Mn)
    return _launch(x, Mn)
