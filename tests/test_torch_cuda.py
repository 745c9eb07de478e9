"""The port's hand-written kernels, forward and backward, against their
plain PyTorch versions on a CUDA card (skipped without one).

This file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports jax.)  Tolerances, float32
kernel against float32 plain version on the same inputs: 1e-5 * (1 +
max|ref|) for the stencils (the forwards round each operation like the
plain version and come out bit-equal; the backwards sum in another order
than autograd), 1e-4 * max|ref| for the fluid solve (shared-memory
transforms against cuFFT, with low frequencies amplified by 1/gamma^2 =
1e4).
"""
import numpy as np
import pytest
import torch

import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch.ops import kernels
from lagomorph_tpu_torch.ops.kernels import epdiff2d, epdiff_unit, fft_unit, shoot2d, warp_unit


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
    """Every forward kernel against its plain version on the card (the
    first shape mixes power-of-two and other axis lengths, so K3 runs both
    of its line transforms; K1 takes batch-1 momenta read with stride 0, and
    batch-N momenta as expmap passes them), with the launch counters moving
    only for the kernel calls, the flags true in the unit regime, autograd
    through K4 giving the plain version's gradients, and float64
    refused."""
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
    counts = kernels.launch_counts()
    assert all(counts[k] == 1 for k in ("warp_unit_fwd", "ad_star_fwd", "compose_fwd",
                                        "fluid_flat"))
    assert all(counts[k] == 0 for k in ("warp_unit_bwd", "ad_star_bwd", "compose_bwd"))
    assert bool(epdiff_unit.ad_star(p, m0)[1]) and bool(epdiff_unit.compose(p, v, -0.2)[1])
    grads = []
    for plain in (False, True):
        Ig, pg = I.clone().requires_grad_(True), p.clone().requires_grad_(True)
        with kernels.plain_versions() if plain else torch.enable_grad():
            warp_unit.sample_displacement_unit(Ig, pg).sum().backward()
        grads.append((Ig.grad, pg.grad))
    for got, ref in zip(*grads):
        _compare(got, ref, 1e-5)
    assert kernels.launch_counts()["warp_unit_bwd"] == 1
    with pytest.raises(TypeError):
        warp_unit.sample_displacement_unit(I.double(), p.double())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 32, 24, 40), (3, 3, 17, 9, 12)])
@pytest.mark.parametrize("batch", ["one", "N"])
def test_backward_kernels_match_plain_on_cuda(cuda, shape, batch):
    """K5, K6, K7 and K3's backward (K3 itself) against the plain versions'
    gradients on the card: K5 with a batch-1 one-channel image (the atlas)
    or a batch-N three-channel one, K6 with batch-1 or batch-N momenta
    (dI and d_m0 summed over the batch in the kernel for batch 1), K7 at
    s = -0.2, K3 through the packed fluid solve.  Each backward kernel
    launches once per backward."""
    rng = np.random.default_rng(5)

    def c(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)

    N, _, X, Y, Z = shape
    nb = 1 if batch == "one" else N
    p = c(rng.uniform(-0.99, 0.99, shape))
    cases = {
        "warp_unit_bwd": (warp_unit.sample_displacement_unit,
                          (c(rng.standard_normal((nb, 1 if batch == "one" else 3, X, Y, Z))), p)),
        "ad_star_bwd": (lambda a, b: epdiff_unit.ad_star(a, b)[0],
                        (p, c(rng.standard_normal((nb, 3, X, Y, Z))))),
        "compose_bwd": (lambda a, b: epdiff_unit.compose(a, b, -0.2)[0],
                        (p, c(rng.uniform(-4.9, 4.9, shape)))),
        "fluid_flat": (lt.FluidMetric((0.1, 0.0, 0.01)).sharp, (c(rng.standard_normal(shape)),)),
    }
    for name, (fn, args) in cases.items():
        leaves, refs = ([a.clone().requires_grad_(True) for a in args] for _ in range(2))
        out = fn(*leaves)
        with kernels.plain_versions():
            ref_out = fn(*refs)
        cot = c(rng.standard_normal(tuple(out.shape)))
        kernels.reset_launches()
        got = torch.autograd.grad(out, leaves, cot)
        assert kernels.launch_counts()[name] == 1, name
        for g, r in zip(got, torch.autograd.grad(ref_out, refs, cot)):
            if name == "fluid_flat":
                _compare(g, r, 1e-4, 0.0)
            else:
                _compare(g, r, 1e-5)


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


def shoot2d_inputs(rng, shape, m_batch, device, max_v0=0.5):
    """``(phiinv0, m0, Mn)`` as ``expmap`` hands them to K8: momenta scaled
    so that the initial velocity peaks at ``max_v0`` voxels, and the peeled
    first step ``phiinv0 = -0.2 * v0``."""
    N, _, H, W = shape
    Mn = lt.FluidMetric((0.1, 0.0, 0.01)).packed_multiplier((H, W), torch.float32, device)
    m0 = torch.as_tensor(rng.standard_normal(((1 if m_batch == "one" else N), 2, H, W)),
                         dtype=torch.float32, device=device)
    v0 = shoot2d.fluid2d_plain(m0, Mn)
    m0 = m0 * (max_v0 / float(v0.abs().max()))
    phiinv0 = (-0.2 * shoot2d.fluid2d_plain(m0, Mn)).expand(N, -1, -1, -1).contiguous()
    return phiinv0, m0.contiguous(), Mn


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 32, 64), (3, 2, 17, 12)])
@pytest.mark.parametrize("m_batch", ["one", "N"])
def test_shoot2d_kernels_match_plain_on_cuda(cuda, shape, m_batch):
    """K8 (phiinv_T, the flag and, under autograd, the stashed trajectories)
    and K9 (both gradients, d_m0 summed over the subjects for batch-1
    momenta) against their plain versions on the card, at a power-of-two
    and an odd shape (both line transforms), 4 substeps at s = -0.2, within
    1e-4 * max|ref| (float32 transforms against cuFFT, as K3); a tripped
    flag (a displacement of 1.5) comes out false both ways.  One launch of
    each per call."""
    rng = np.random.default_rng(6)
    phiinv0, m0, Mn = shoot2d_inputs(rng, shape, m_batch, cuda)
    kernels.reset_launches()
    out, ok, tp, tv, tm = shoot2d._launch_fwd(phiinv0, m0, Mn, -0.2, 4, True)
    r_out, r_ok, r_tp, r_tv, r_tm = shoot2d.shoot2d_fwd_plain(phiinv0, m0, Mn, -0.2, 4)
    for got, ref in ((out, r_out), (tp, r_tp), (tv, r_tv), (tm, r_tm)):
        _compare(got, ref, 1e-4, 0.0)
    assert bool(ok) and bool(r_ok)
    out2, ok2 = shoot2d.shoot2d(phiinv0, m0, Mn, -0.2, 4)  # no stash: ping-pong planes
    assert torch.equal(out2, out) and bool(ok2)
    g = torch.as_tensor(rng.standard_normal(tuple(out.shape)), dtype=torch.float32, device=cuda)
    d_phi, d_m0 = shoot2d._launch_bwd(m0, g, tp, tv, tm, Mn, -0.2)
    r_phi, r_m0 = shoot2d.shoot2d_bwd_plain(m0, g, r_tp, r_tv, r_tm, Mn, -0.2)
    _compare(d_phi, r_phi, 1e-4, 0.0)
    _compare(d_m0, r_m0, 1e-4, 0.0)
    assert kernels.launch_counts()["shoot2d_fwd"] == 2 and kernels.launch_counts()["shoot2d_bwd"] == 1
    leaves = [phiinv0.clone().requires_grad_(True), m0.clone().requires_grad_(True)]
    got = torch.autograd.grad(shoot2d.shoot2d(*leaves, Mn, -0.2, 4)[0], leaves, g)
    assert kernels.launch_counts()["shoot2d_bwd"] == 2
    for a, b in zip(got, (d_phi, d_m0)):
        assert torch.equal(a, b)
    bad = phiinv0.clone()
    bad.view(-1)[bad.numel() // 3] = 1.5
    assert not bool(shoot2d.shoot2d(bad, m0, Mn, -0.2, 4)[1])
    assert not bool(shoot2d.shoot2d_fwd_plain(bad, m0, Mn, -0.2, 4, stash=False)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 32, 64), (3, 2, 17, 12)])
@pytest.mark.parametrize("m_batch", ["one", "N"])
def test_epdiff2d_kernels_match_plain_on_cuda(cuda, shape, m_batch):
    """K10 (with ``mw`` and the flag) and K11 at s = -0.2 against their
    plain versions on the card (bit-equal in practice, held within 1e-5 *
    (1 + max|ref|)), K12 (d_m0 summed over the subjects for batch-1
    momenta) and K13 against the plain backwards, directly and through the
    wrappers under autograd (one launch of each backward per call); flags
    false out of the unit regime, at a power-of-two and an odd shape."""
    rng = np.random.default_rng(7)

    def c(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)

    N = shape[0]
    p = c(rng.uniform(-0.99, 0.99, shape))
    m0 = c(rng.standard_normal(((1 if m_batch == "one" else N),) + shape[1:]))
    v = c(rng.uniform(-4.9, 4.9, shape))
    g = c(rng.standard_normal(shape))
    kernels.reset_launches()
    out, flag, mw = epdiff2d._launch_ad_star(p, m0, want_mw=True)
    r_out, r_flag, r_mw = epdiff2d.ad_star2d_plain(p, m0, want_mw=True)
    _compare(out, r_out, 1e-5)
    _compare(mw, r_mw, 1e-5)
    assert bool(flag) and bool(r_flag)
    for got, ref in zip(epdiff2d._launch_ad_star_bwd(p, m0, g, mw),
                        epdiff2d.ad_star2d_bwd_plain(p, m0, g, r_mw)):
        _compare(got, ref, 1e-5)
    out, flag = epdiff2d.compose2d(p, v, -0.2)
    r_out, r_flag = epdiff2d.compose2d_plain(p, v, -0.2)
    _compare(out, r_out, 1e-5)
    assert bool(flag) and bool(r_flag)
    for got, ref in zip(epdiff2d._launch_compose_bwd(p, v, -0.2, g),
                        epdiff2d.compose2d_bwd_plain(p, v, -0.2, g)):
        _compare(got, ref, 1e-5)
    cases = ((lambda a, b: epdiff2d.ad_star2d(a, b)[0], (p, m0), "ad_star2d_bwd"),
             (lambda a, b: epdiff2d.compose2d(a, b, -0.2)[0], (p, v), "compose2d_bwd"))
    for fn, args, name in cases:
        leaves, refs = ([a.clone().requires_grad_(True) for a in args] for _ in range(2))
        before = kernels.launch_counts()[name]
        got = torch.autograd.grad(fn(*leaves), leaves, g)
        assert kernels.launch_counts()[name] == before + 1, name
        with kernels.plain_versions():
            ref = torch.autograd.grad(fn(*refs), refs, g)
        for a, b in zip(got, ref):
            _compare(a, b, 1e-5)
    bad = p.clone()
    bad.view(-1)[bad.numel() // 3] = 1.0  # the unit regime's upper bound is open
    assert not bool(epdiff2d.ad_star2d(bad, m0)[1])
    bad_v = v.clone()
    bad_v.view(-1)[bad_v.numel() // 2] = -5.1  # s*v = 1.02
    assert not bool(epdiff2d.compose2d(p, bad_v, -0.2)[1])
    with pytest.raises(TypeError):
        epdiff2d.ad_star2d(p.double(), m0.double())
