"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each kernel module (``warp_unit``, ``epdiff_unit``, ``fft_unit``,
``shoot2d``, ``epdiff2d``) holds, for every kernel, a wrapper that launches
the CUDA kernel for tensors on a CUDA device and the plain PyTorch function
of the same signature that it is held against.  Dispatch is by device only:

* a CPU tensor goes to the plain version;
* a CUDA tensor launches the kernel, or the wrapper raises (wrong dtype,
  shape, layout).  Nothing falls back to the plain version or to the CPU.

The one exception is explicit: inside ``with plain_versions():`` every
wrapper runs its plain version on any device.  That is how a caller puts the
kernels and their plain versions side by side on the card; nothing in the
package enters it on its own.

Under autograd, a kernel launch goes through a ``torch.autograd.Function``
of its module whose backward launches the backward kernel (K3's backward is
K3 itself, the solve being self-adjoint).  Flag outputs are marked
non-differentiable.  Autograd hands a backward zeros for an output that
was not used (it materialises them), and may hand it an expanded or
strided view (the cotangent of a ``sum`` has stride 0), so every backward
makes its cotangent contiguous before the launch.  A plain version is
ordinary torch code, which autograd differentiates.

Every kernel is a :class:`Kernel` record in :data:`KERNELS` whose
``launches`` counts the launches of that kernel (not the plain-version calls),
so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch

__all__ = [
    "Kernel",
    "KERNELS",
    "grad_needed",
    "launch_counts",
    "plain_versions",
    "reset_launches",
    "use_kernel",
]


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, which TPU kernel it
    replaces, and how often it was launched."""

    name: str
    source: str  # path of the CUDA source in the repository
    replaces: str  # file:line of the Pallas kernel it replaces
    launches: int = 0


KERNELS: dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str) -> Kernel:
    k = Kernel(name, source, replaces)
    KERNELS[name] = k
    return k


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


_PLAIN = contextvars.ContextVar("lagomorph_plain_versions", default=False)


@contextlib.contextmanager
def plain_versions():
    """Run every kernel wrapper's plain PyTorch version, on any device, for
    the duration of the block (for comparisons against the kernels)."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def use_kernel(t: torch.Tensor) -> bool:
    """True when a wrapper given ``t`` must launch its kernel: ``t`` lies on
    a CUDA device and :func:`plain_versions` is not active.  A CPU tensor
    takes the plain version; any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return not _PLAIN.get()


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current CUDA stream on ``t``'s device, for
    a kernel launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on the same
    CUDA device (what the kernels take)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")


def grad_needed(*tensors: torch.Tensor) -> bool:
    """True when autograd records an operation on ``tensors``: grad mode is
    on and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
