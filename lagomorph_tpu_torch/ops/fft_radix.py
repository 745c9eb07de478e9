"""Radix-2 FFT stages in bit-reversed frequency order.

Port of ``lagomorph_tpu/ops/fft_radix.py``.  The fluid operator is a
convolution, ``v = ifftn(M . fftn(c))``, so its spectrum never has to be in
natural order: a decimation-in-frequency (DIF) forward transform leaves the
frequencies in bit-reversed order, a decimation-in-time (DIT) inverse takes
them in that order back to natural order, and the pipeline

    DIF forward  ->  multiply by the bit-reversed M  ->  DIT inverse

needs no permutation anywhere.  The stages, for half-length ``s`` along an
axis of length ``n`` (``e = j mod s``, ``W = exp(sign * i * pi * e / s)``,
``sign = -1`` forward, ``+1`` inverse), on each pair of a top element ``a``
at ``j`` and its partner ``b`` at ``j + s``::

    DIF (s = n/2 .. 1):  a, b <- a + b, W * (a - b)
    DIT (s = 1 .. n/2):  a, b <- a + W * b, a - W * b

These are the plain versions of the radix-2 kernels K14 and K15
(:mod:`.kernels.fft_radix`), which keep the same bit-reversed spectra
between their launches but compute each axis's DFT as K3 does (a
four-step split held in registers; radix-2 stages in shared memory only
for an axis longer than 256), so they agree with these stages to
rounding.  Power-of-two lengths only; float32 or float64 (computed as
complex).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "bitrev_perm",
    "fft_dif",
    "fft_dit",
    "fftn_br",
    "fluid_apply_radix_ref",
    "ifftn_br",
    "is_pow2",
]


def is_pow2(n: int) -> bool:
    return n >= 2 and (n & (n - 1)) == 0


def bitrev_perm(n: int) -> np.ndarray:
    """Bit-reversal permutation of range(n) (n a power of two): the
    frequency order the DIF stages produce."""
    assert is_pow2(n)
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _twiddle(s, sign, c, dim):
    """``exp(sign * i * pi * e / s)`` for ``e < s``, built in float64, cast
    to ``c``'s complex type and shaped to broadcast along ``dim + 2`` of the
    stage view of ``c``."""
    e = torch.arange(s, dtype=torch.float64, device=c.device)
    w = torch.polar(torch.ones_like(e), (sign * math.pi / s) * e).to(c.dtype)
    return w.reshape((s,) + (1,) * (c.dim() - dim - 1))


def _stages(c, dim, sign, dit):
    """All radix-2 stages of the complex tensor ``c`` along ``dim``: DIF
    (natural in, bit-reversed out) or, with ``dit``, DIT (bit-reversed in,
    natural out); no scaling."""
    n = c.shape[dim]
    assert is_pow2(n), n
    shape = c.shape
    s = 1 if dit else n // 2
    while 1 <= s <= n // 2:
        v = c.reshape(shape[:dim] + (n // (2 * s), 2, s) + shape[dim + 1:])
        a, b = v.select(dim + 1, 0), v.select(dim + 1, 1)
        w = _twiddle(s, sign, c, dim)
        if dit:
            wb = w * b
            pair = (a + wb, a - wb)
        else:
            pair = (a + b, w * (a - b))
        c = torch.stack(pair, dim + 1).reshape(shape)
        s = s * 2 if dit else s // 2
    return c


def _complex(re, im):
    return torch.complex(re, im)


def fft_dif(re, im, dim, inverse=False):
    """Radix-2 DIF transform along ``dim``: natural-order input,
    bit-reversed-order output.  ``inverse`` flips the twiddle sign and
    scales by 1/n."""
    n = re.shape[dim]
    c = _stages(_complex(re, im), dim % re.dim(), 1.0 if inverse else -1.0, False)
    if inverse:
        c = c / n
    return c.real, c.imag


def fft_dit(re, im, dim, inverse=True):
    """Radix-2 DIT transform along ``dim``: bit-reversed-order input,
    natural-order output.  By default the inverse transform (sign +1, 1/n
    scale); ``inverse=False`` gives the forward transform."""
    n = re.shape[dim]
    c = _stages(_complex(re, im), dim % re.dim(), 1.0 if inverse else -1.0, True)
    if inverse:
        c = c / n
    return c.real, c.imag


def fftn_br(re, im, dims):
    """Forward FFT along ``dims``; every transformed axis comes out in
    bit-reversed frequency order."""
    c = _complex(re, im)
    for d in dims:
        c = _stages(c, d % c.dim(), -1.0, False)
    return c.real, c.imag


def ifftn_br(re, im, dims):
    """Inverse FFT along ``dims`` from bit-reversed frequency order back to
    natural spatial order, with the 1/N scale."""
    c = _complex(re, im)
    for d in dims:
        c = _stages(c, d % c.dim(), 1.0, True) / c.shape[d]
    return c.real, c.imag


def fluid_apply_radix_ref(mv, params, inverse):
    """The fluid operator on ``(B, d, *spatial)`` through the radix
    pipeline, packing real fields in complex pairs as the packed routes of
    :func:`.fluid.fluid_operator` do (across the ``B * d`` slabs when
    ``beta == 0``, across batch halves otherwise), with bit-reversed
    spectra throughout.  The multiplier is built in float64 and cast to
    ``mv``'s dtype."""
    from .fluid import fluid_multiplier_entries

    B, d = mv.shape[:2]
    spatial = tuple(mv.shape[2:])
    assert all(is_pow2(n) for n in spatial)
    M = fluid_multiplier_entries(spatial, params, inverse, mv.dtype, mv.device,
                                 full_spectrum=True, bitrev=True)
    if float(params[1]) == 0.0 and B * d >= 2:
        n = B * d
        x = mv.reshape((n,) + spatial)
        if n % 2:
            x = torch.cat([x, x.new_zeros((1,) + spatial)])
        half = x.shape[0] // 2
        dims = tuple(range(1, 1 + len(spatial)))
        re, im = fftn_br(x[:half], x[half:], dims)
        re, im = ifftn_br(re * M[(0, 0)], im * M[(0, 0)], dims)
        return torch.cat([re, im])[:n].reshape(mv.shape)
    x = mv if B % 2 == 0 else torch.cat([mv, mv.new_zeros((1,) + mv.shape[1:])])
    half = x.shape[0] // 2
    dims = tuple(range(2, 2 + len(spatial)))
    re, im = fftn_br(x[:half], x[half:], dims)

    def mget(a, b):
        return M[(a, b)] if a >= b else M[(b, a)]

    re, im = (torch.stack([sum(mget(a, b) * part[:, b] for b in range(d)) for a in range(d)], 1)
              for part in (re, im))
    re, im = ifftn_br(re, im, dims)
    return torch.cat([re, im])[:B]
