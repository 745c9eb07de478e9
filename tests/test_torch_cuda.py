"""The port's hand-written kernels against their plain PyTorch versions,
on a CUDA card (skipped without one).

This file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports jax.)  Tolerances, float32
kernel against float32 plain version on the same inputs: 1e-5 * (1 +
max|ref|) for the stencils (they round each operation like the plain
version and come out bit-equal; the bound leaves room for a libm
difference), 1e-4 * max|ref| for the fluid solve (shared-memory transforms
against cuFFT, with low frequencies amplified by 1/gamma^2 = 1e4).
"""
import numpy as np
import pytest
import torch

import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch.ops import kernels
from lagomorph_tpu_torch.ops.kernels import epdiff_unit, fft_unit, warp_unit


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


def _compare(got, ref, rel, offset=1.0):
    err = float((got.double() - ref.double()).abs().max())
    assert err <= rel * (offset + float(ref.double().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 32, 24, 40), (3, 3, 17, 9, 12)])
@pytest.mark.parametrize("m_batch", ["one", "N"])
def test_kernels_match_plain_on_cuda(cuda, shape, m_batch):
    """Every kernel against its plain version on the card (the first shape
    mixes power-of-two and other axis lengths, so K3 runs both of its line
    transforms; K1 takes batch-1 momenta read with stride 0, and batch-N
    momenta as expmap passes them), with the launch counters moving only
    for the kernel calls, the flags true in the unit regime, backward
    raising, and float64 refused."""
    rng = np.random.default_rng(3)

    def c(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)

    p = c(rng.uniform(-0.99, 0.99, shape))
    m0 = c(rng.standard_normal(((1 if m_batch == "one" else shape[0]),) + shape[1:]))
    v = c(rng.uniform(-4.9, 4.9, shape))
    I = c(rng.standard_normal((1, 1) + shape[2:]))
    x = c(rng.standard_normal((2 * ((shape[0] * 3 + 1) // 2),) + shape[2:]))
    Mn = lt.FluidMetric((0.1, 0.0, 0.01)).multiplier(shape, torch.float32, cuda, True)
    kernels.reset_launches()
    cases = [
        (warp_unit.sample_displacement_unit, (I, p), 1e-5, 1.0),
        (lambda a, b: epdiff_unit.ad_star(a, b)[0], (p, m0), 1e-5, 1.0),
        (lambda a, b: epdiff_unit.compose(a, b, -0.2)[0], (p, v), 1e-5, 1.0),
        (fft_unit.fluid_flat, (x, Mn), 1e-4, 0.0),
    ]
    for fn, args, rel, offset in cases:
        got = fn(*args)
        with kernels.plain_versions():
            ref = fn(*args)
        _compare(got, ref, rel, offset)
    assert all(n == 1 for n in kernels.launch_counts().values())
    assert bool(epdiff_unit.ad_star(p, m0)[1]) and bool(epdiff_unit.compose(p, v, -0.2)[1])
    with pytest.raises(NotImplementedError):
        warp_unit.sample_displacement_unit(I.clone().requires_grad_(True), p).sum().backward()
    with pytest.raises(TypeError):
        warp_unit.sample_displacement_unit(I.double(), p.double())


@pytest.mark.cuda
def test_sharp_through_k3_matches_plain_on_cuda(cuda):
    """FluidMetric.sharp on the card (K3, with the zero slab of an odd slab
    count) against the same call through the plain versions."""
    rng = np.random.default_rng(4)
    m = torch.as_tensor(rng.standard_normal((3, 3, 20, 16, 24)), dtype=torch.float32,
                        device=cuda)
    metric = lt.FluidMetric((0.1, 0.0, 0.01))
    got = metric.sharp(m)
    with kernels.plain_versions():
        ref = metric.sharp(m)
    _compare(got, ref, 1e-4, 0.0)
