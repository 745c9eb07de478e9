"""The port's hand-written kernels, forward and backward, against their
plain PyTorch versions on a CUDA card (skipped without one).

This file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports jax.)  Tolerances, float32
kernel against float32 plain version on the same inputs: 1e-5 * (1 +
max|ref|) for the stencils (the forwards round each operation like the
plain version and come out bit-equal; the backwards sum in another order
than autograd), 1e-4 * max|ref| for the fluid solves K3, K14-K16
(shared-memory transforms against cuFFT or the plain radix stages, with
low frequencies amplified by 1/gamma^2 = 1e4).
"""
import numpy as np
import pytest
import torch

import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch.ops import kernels
from lagomorph_tpu_torch.ops import fluid
from lagomorph_tpu_torch.ops.kernels import (_build, epdiff2d, epdiff_unit, fft_radix, fft_unit,
                                             fft_whole, shoot2d, warp_unit)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


def _compare(got, ref, rel, offset=1.0):
    err = float((got.double() - ref.double()).abs().max())
    assert err <= rel * (offset + float(ref.double().abs().max()))


def _plain_on_card(fn, *args):
    """Float64 operands on the card take the plain version there (the
    kernels take float32 only): no launch, the plain version's values."""
    before = kernels.launch_counts()
    got = fn(*args)
    assert kernels.launch_counts() == before
    with kernels.plain_versions():
        ref = fn(*args)
    for g, r in zip(*((x,) if torch.is_tensor(x) else x for x in (got, ref))):
        assert g.device.type == "cuda" and torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 32, 24, 40), (3, 3, 17, 9, 12)])
@pytest.mark.parametrize("m_batch", ["one", "N"])
def test_kernels_match_plain_on_cuda(cuda, shape, m_batch):
    """Every forward kernel against its plain version on the card (the
    first shape mixes power-of-two and other axis lengths, so K3 runs both
    of its line transforms; K1 takes batch-1 momenta read with stride 0, and
    batch-N momenta as expmap passes them), with the launch counters moving
    only for the kernel calls, the flags true in the unit regime, autograd
    through K4 giving the plain version's gradients, float64 taking the
    plain version on the card (no launch) and a float32 displacement with a
    float64 image refused."""
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
    _plain_on_card(warp_unit.sample_displacement_unit, I.double(), p.double())
    with pytest.raises(TypeError):  # a float64 image with a float32 displacement
        warp_unit.sample_displacement_unit(I.double(), p)


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
@pytest.mark.parametrize("shape", [(2, 2, 32, 64), (3, 2, 17, 12), (8, 2, 256, 256)])
@pytest.mark.parametrize("m_batch", ["one", "N"])
def test_shoot2d_kernels_match_plain_on_cuda(cuda, shape, m_batch):
    """K8 (phiinv_T, the flag and, under autograd, the stashed trajectories)
    and K9 (both gradients, d_m0 summed over the subjects for batch-1
    momenta) against their plain versions on the card, at power-of-two
    shapes (their register path, 256^2 b8 the 2D step's) and an odd one
    (their tile path, also at 8-line tiles: K8's 8 rows, K9's 6 rows and
    the halo, so that a tile holds the edge of two subjects and K9's halo
    row lies in the next),
    4 substeps at s = -0.2, within 1e-4 * max|ref| (float32 transforms
    against cuFFT, as K3); K8's traj_phiinv[0] and traj_mw[0] (before any
    transform) bit-equal; a second launch of K8 and of K9 bit-identical (no
    atomics); a tripped flag (a displacement of 1.5) comes out false both
    ways.  One launch of each per call."""
    rng = np.random.default_rng(6)
    phiinv0, m0, Mn = shoot2d_inputs(rng, shape, m_batch, cuda)
    N, _, H, W = shape
    path = "tile" if shape == (3, 2, 17, 12) else "register"
    assert shoot2d.fwd_launch_config(N, H, W)["path"] == path
    kernels.reset_launches()
    got_fwd = shoot2d._launch_fwd(phiinv0, m0, Mn, -0.2, 4, True)
    out, ok, tp, tv, tm = got_fwd
    r_out, r_ok, r_tp, r_tv, r_tm = shoot2d.shoot2d_fwd_plain(phiinv0, m0, Mn, -0.2, 4)
    for got, ref in ((out, r_out), (tp, r_tp), (tv, r_tv), (tm, r_tm)):
        _compare(got, ref, 1e-4, 0.0)
    assert torch.equal(tp[0], r_tp[0]) and torch.equal(tm[0], r_tm[0])
    assert bool(ok) and bool(r_ok)
    again = shoot2d._launch_fwd(phiinv0, m0, Mn, -0.2, 4, True)
    assert all(torch.equal(a, b) for a, b in zip(again, got_fwd))
    out2, ok2 = shoot2d.shoot2d(phiinv0, m0, Mn, -0.2, 4)  # no stash: ping-pong planes
    assert torch.equal(out2, out) and bool(ok2)
    fwd_launches = 3
    if path == "tile":
        forced = shoot2d._launch_fwd(phiinv0, m0, Mn, -0.2, 4, True, tile=8)
        for got, ref in zip(forced[:1] + forced[2:], (r_out, r_tp, r_tv, r_tm)):
            _compare(got, ref, 1e-4, 0.0)
        assert bool(forced[1]) and torch.equal(forced[4][0], r_tm[0])
        fwd_launches += 1
    g = torch.as_tensor(rng.standard_normal(tuple(out.shape)), dtype=torch.float32, device=cuda)
    assert shoot2d.bwd_launch_config(N, H, W)["path"] == path
    d_phi, d_m0 = shoot2d._launch_bwd(m0, g, tp, tv, tm, Mn, -0.2)
    r_phi, r_m0 = shoot2d.shoot2d_bwd_plain(m0, g, r_tp, r_tv, r_tm, Mn, -0.2)
    _compare(d_phi, r_phi, 1e-4, 0.0)
    _compare(d_m0, r_m0, 1e-4, 0.0)
    again = shoot2d._launch_bwd(m0, g, tp, tv, tm, Mn, -0.2)
    assert torch.equal(again[0], d_phi) and torch.equal(again[1], d_m0)
    if path == "tile":
        for got, ref in zip(shoot2d._launch_bwd(m0, g, tp, tv, tm, Mn, -0.2, tile=8),
                            (r_phi, r_m0)):
            _compare(got, ref, 1e-4, 0.0)
    launches = 3 if path == "tile" else 2
    assert (kernels.launch_counts()["shoot2d_fwd"] == fwd_launches
            and kernels.launch_counts()["shoot2d_bwd"] == launches)
    leaves = [phiinv0.clone().requires_grad_(True), m0.clone().requires_grad_(True)]
    got = torch.autograd.grad(shoot2d.shoot2d(*leaves, Mn, -0.2, 4)[0], leaves, g)
    assert kernels.launch_counts()["shoot2d_bwd"] == launches + 1
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
    wrappers under autograd (one launch of each backward per call); K12 on
    its row tiles (batch-N m0) ``torch.equal`` to its per-thread route, K10
    and K11 on their column strips (the chooser's band and 3 rows) to
    theirs; flags false out of the unit regime, at a power-of-two and an
    odd shape."""
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
    for march in (0, 3):
        got = epdiff2d._launch_ad_star(p, m0, want_mw=True, march=march)
        thread = epdiff2d._launch_ad_star(p, m0, want_mw=True, march=epdiff2d.THREAD)
        assert all(torch.equal(a, b) for a, b in zip(got, thread))
        assert all(torch.equal(a, b) for a, b in zip(epdiff2d._launch_compose(p, v, -0.2, march),
                                                     epdiff2d._launch_compose(p, v, -0.2,
                                                                              epdiff2d.THREAD)))
    if m_batch == "N":
        for got, thread in zip(epdiff2d._launch_ad_star_bwd(p, m0, g, mw),
                               epdiff2d._launch_ad_star_bwd(p, m0, g, mw, epdiff2d.THREAD)):
            assert torch.equal(got, thread)
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
    _plain_on_card(epdiff2d.ad_star2d, p.double(), m0.double())
    with pytest.raises(TypeError):  # a float32 field with a float64 one
        epdiff2d.ad_star2d(p, m0.double())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 16, 32, 64), (1, 3, 4, 256, 128), (1, 3, 512, 4, 512)])
def test_radix_kernels_match_plain_on_cuda(cuda, shape):
    """K14 (both directions), K15 and the pipeline K14, K15, K14 against
    their plain versions on the card, at (Y, Z) planes that take K14's two
    register line passes (32 x 64, and 256 x 128), the pipeline bit-equal
    to K3 at the first, and at axes of 512 (K14's z pass and K15 in
    radix-2 tiles); the pipeline
    under autograd (3 launches forward, 3 backward, a transposed cotangent)
    against autograd of the plain version; ``sharp`` on the radix route
    (float64 there: the plain version on the card, no launch); axes that
    are no power of two refused."""
    rng = np.random.default_rng(8)
    N, _, X, Y, Z = shape
    F = (N * 3 + 1) // 2
    x = torch.as_tensor(rng.standard_normal((2 * F, X, Y, Z)), dtype=torch.float32, device=cuda)
    Mbr = fluid.form_multiplier(fluid.multiplier_form("fluid_radix"), (X, Y, Z), (0.1, 0.0, 0.01),
                                True, torch.float32, cuda)
    kernels.reset_launches()
    for fn, args in ((fft_radix.radix_zy, (x, False)), (fft_radix.radix_zy, (x, True)),
                     (fft_radix.radix_x, (x, Mbr)), (fft_radix.fluid_radix, (x, Mbr))):
        got = fn(*args)
        with kernels.plain_versions():
            ref = fn(*args)
        _compare(got, ref, 1e-4, 0.0)
    assert kernels.launch_counts()["fluid_radix_zy"] == 4
    assert kernels.launch_counts()["fluid_radix_x"] == 2
    if shape == (2, 3, 16, 32, 64):  # K3's register line path: the same passes, bit-reversed
        Mn = fluid.form_multiplier(fluid.multiplier_form("fluid_flat"), (X, Y, Z),
                                   (0.1, 0.0, 0.01), True, torch.float32, cuda)
        assert torch.equal(got, fft_unit.fluid_flat(x, Mn)), "K14, K15, K14 differ from K3"
    cot = torch.as_tensor(rng.standard_normal((2 * F, Z, Y, X)), dtype=torch.float32,
                          device=cuda).transpose(1, 3)
    grads = []
    for plain in (False, True):
        leaf = x.clone().requires_grad_(True)
        with kernels.plain_versions() if plain else torch.enable_grad():
            grads.append(torch.autograd.grad(fft_radix.fluid_radix(leaf, Mbr), leaf, cot)[0])
    _compare(grads[0], grads[1], 1e-4, 0.0)
    assert kernels.launch_counts()["fluid_radix_zy"] == 8
    metric = lt.FluidMetric((0.1, 0.0, 0.01))
    m = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=cuda)
    prev = lt.set_fluid_fft_kernel("radix")
    try:
        got = metric.sharp(m)
        with kernels.plain_versions():
            ref = metric.sharp(m)
        _plain_on_card(metric.sharp, m.double())
    finally:
        lt.set_fluid_fft_kernel(prev)
    _compare(got, ref, 1e-4, 0.0)
    assert kernels.launch_counts()["fluid_radix_x"] == 5
    with pytest.raises(ValueError):
        fft_radix.fluid_radix(x[:, :, :, : Z - 1].contiguous(), Mbr[:, :, : Z - 1].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 32, 24, 40), (4, 3, 16, 16, 16), (2, 3, 64, 64, 64)])
def test_fluid_whole_matches_plain_on_cuda(cuda, shape):
    """K16 against its plain version (the torch.fft packed solve) on the
    card, at a mixed-radix shape (its tile path) and at power-of-two shapes
    (its line and plane paths), directly, under autograd (one launch each
    way) and through ``sharp`` under ``set_fluid_mxu_whole(True)``; on the
    register paths K16 is bit-equal to K3; float64 takes the plain version
    on the card, a float32 field with a float64 multiplier is refused."""
    rng = np.random.default_rng(9)
    N, _, X, Y, Z = shape
    F = (N * 3 + 1) // 2
    x = torch.as_tensor(rng.standard_normal((2 * F, X, Y, Z)), dtype=torch.float32, device=cuda)
    Mn = lt.FluidMetric((0.1, 0.0, 0.01)).multiplier(shape, torch.float32, cuda, True)
    kernels.reset_launches()
    got = whole = fft_whole.fluid_whole(x, Mn)
    _compare(got, fft_unit.fluid_flat_plain(x, Mn), 1e-4, 0.0)
    cot = torch.as_tensor(rng.standard_normal(tuple(x.shape)), dtype=torch.float32, device=cuda)
    grads = []
    for plain in (False, True):
        leaf = x.clone().requires_grad_(True)
        with kernels.plain_versions() if plain else torch.enable_grad():
            grads.append(torch.autograd.grad(fft_whole.fluid_whole(leaf, Mn), leaf, cot)[0])
    _compare(grads[0], grads[1], 1e-4, 0.0)
    assert kernels.launch_counts()["fluid_whole"] == 3
    m = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=cuda)
    metric = lt.FluidMetric((0.1, 0.0, 0.01))
    prev = lt.set_fluid_mxu_whole(True)
    try:
        got = metric.sharp(m)
        with kernels.plain_versions():
            ref = metric.sharp(m)
    finally:
        lt.set_fluid_mxu_whole(prev)
    _compare(got, ref, 1e-4, 0.0)
    counts = kernels.launch_counts()
    assert counts["fluid_whole"] == 4 and counts["fluid_flat"] == 0
    if not fft_unit.needs_scratch(X, Y, Z):  # K3's passes as K16's phases
        assert torch.equal(whole, fft_unit.fluid_flat(x, Mn))
    _plain_on_card(fft_whole.fluid_whole, x.double(), Mn.double())
    with pytest.raises(TypeError):  # a float32 field with a float64 multiplier
        fft_whole.fluid_whole(x, Mn.double())


# shapes against the warp backward passes' brick of 4 x 8 x 32 voxels:
# smaller than one brick, straddling bricks on every axis, axes of length 1
# and 2, 17 voxels along x (more bricks than one transpose block walks);
# and against K6's first pass, whose blocks march over 16 x-planes of an
# 8 x 32 (y, z) tile: one march plus a remainder, less than one, y and z
# straddling the tile; as tests/test_torch_host_barrier_kernels.py holds
# them on the CPU
EDGE_SHAPES = [(2, 3, 3, 5, 7), (3, 3, 5, 9, 37), (2, 3, 1, 2, 6), (2, 3, 6, 2, 1),
               (2, 3, 17, 3, 5), (2, 3, 19, 11, 35), (2, 3, 5, 9, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_warp_passes_edge_cases_on_cuda(cuda, shape):
    """K4 bit-equal to its plain version, and K5, K6 and K7 within 1e-5 *
    (1 + max|ref|) of theirs, on displacements with voxels outside the unit
    regime (zero weights) and at its edges, at shapes smaller than a brick,
    straddling bricks and with thin axes: one-, three- and five-channel
    images of batch 1 and N, batch-1 and batch-N momenta (no thin axis:
    Ad*'s Jacobian refuses one), s = -0.2 and 0.7; a second launch of each
    backward bit-identical to the first; and K6's first pass alone, its
    ``d_mw`` bit-equal to the plain Jacobian transpose."""
    rng = np.random.default_rng(12)
    N, _, X, Y, Z = shape

    def c(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)

    def edge_disp(scale=1.0):
        d = rng.uniform(-0.99, 0.99, shape)
        pick = rng.uniform(size=shape) < 0.125
        d[pick] = rng.choice([-2.5, -1.5, 1.0, 1.5, 3.7, -1.0, 0.0], size=int(pick.sum()))
        return c(d * scale)

    def hold(fn, plain, *args):
        got = fn(*args)
        for a, r in zip(got, plain(*args)):
            _compare(a, r, 1e-5)
        assert all(torch.equal(a, b) for a, b in zip(got, fn(*args)))

    p = edge_disp()
    for nb, C in ((1, 1), (N, 1), (1, 3), (N, 3), (1, 5)):
        I = c(rng.standard_normal((nb, C, X, Y, Z)))
        got = warp_unit.sample_displacement_unit(I, p)
        assert torch.equal(got, warp_unit.sample_displacement_unit_plain(I, p))
        hold(warp_unit._launch_bwd, warp_unit.sample_displacement_unit_bwd_plain, I, p,
             c(rng.standard_normal((N, C, X, Y, Z))))
    for nb in (1, N) if min(X, Y, Z) > 1 else ():
        m0 = c(rng.standard_normal((nb, 3, X, Y, Z)))
        _, _, mw = epdiff_unit._launch_ad_star(p, m0, want_mw=True)
        g = c(rng.standard_normal(shape))
        hold(epdiff_unit._launch_ad_star_bwd, epdiff_unit.ad_star_bwd_plain, p, m0, g, mw)
        d_mw, d_p = torch.empty_like(p), torch.empty_like(p)
        _build.call("lagomorph_ad_star_bwd_first", p.data_ptr(), m0.data_ptr(), g.data_ptr(),
                    mw.data_ptr(), d_mw.data_ptr(), d_p.data_ptr(), N, nb, X, Y, Z, 0,
                    kernels.stream_of(p))
        r_mw, r_p = epdiff_unit.ad_star_bwd_first_plain(p, m0, g, mw)
        assert torch.equal(d_mw, r_mw)
        _compare(d_p, r_p, 1e-5)
    for s in (-0.2, 0.7):
        hold(lambda a, b, g: epdiff_unit._launch_compose_bwd(a, b, s, g),
             lambda a, b, g: epdiff_unit.compose_bwd_plain(a, b, s, g), p, edge_disp(1.0 / s),
             c(rng.standard_normal(shape)))


@pytest.mark.cuda
def test_float64_takes_plain_versions_on_cuda(cuda):
    """A float64 field on the card takes the plain versions there (the
    kernels take float32 only, as the JAX package's gates): ``sharp`` and
    one atlas step launch no kernel and match the same calls on the CPU in
    float64 (1e-9 of max|ref|: two FFT libraries), while the float32 step
    launches the kernels of the main path."""
    rng = np.random.default_rng(13)
    shape = (2, 3, 16, 12, 20)
    metric = lt.FluidMetric((0.1, 0.0, 0.01))
    m = rng.standard_normal(shape)
    m = m * (0.5 / float(metric.sharp(torch.as_tensor(m)).abs().max()))
    I = rng.standard_normal((1, 1) + shape[2:])
    img = rng.standard_normal((shape[0], 1) + shape[2:])
    step = lt.make_lddmm_atlas_step(metric, reg_weight=0.1, learning_rate_pose=1e-4)
    ref_v = metric.sharp(torch.as_tensor(m))
    ref_step = step(*(torch.as_tensor(a) for a in (I, m, img)))
    kernels.reset_launches()
    got_v = metric.sharp(torch.as_tensor(m, device=cuda))
    got_step = step(*(torch.as_tensor(a, device=cuda) for a in (I, m, img)))
    assert all(n == 0 for n in kernels.launch_counts().values())
    for got, ref in zip((got_v, *got_step), (ref_v, *ref_step)):
        assert got.dtype == torch.float64 and got.device.type == "cuda"
        _compare(got.cpu(), ref, 1e-9, 0.0)
    step(*(torch.as_tensor(a, dtype=torch.float32, device=cuda) for a in (I, m, img)))
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("warp_unit_fwd", "warp_unit_bwd", "ad_star_fwd",
                                       "compose_fwd", "ad_star_bwd", "compose_bwd", "fluid_flat"))


@pytest.mark.cuda
@pytest.mark.parametrize("spatial", [(64, 64, 64), (8, 128, 128), (4, 32, 32), (4, 256, 128),
                                     (1, 2, 32), (16, 64, 4), (6, 10, 14), (2, 3, 512)])
def test_fluid_flat_paths_on_cuda(cuda, spatial):
    """K3 on each of its paths (the plane path at 64^2 and 128^2 planes,
    the line path at other power-of-two axes up to 256, the tile path
    otherwise) against its plain version, forward and under autograd (one
    launch each way), within 1e-4 * max|ref|."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((6,) + spatial), dtype=torch.float32, device=cuda)
    Mn = fluid.form_multiplier(fluid.multiplier_form("fluid_flat"), spatial, (0.1, 0.0, 0.01),
                               True, torch.float32, cuda)
    cot = torch.as_tensor(rng.standard_normal((6,) + spatial), dtype=torch.float32, device=cuda)
    kernels.reset_launches()
    with kernels.plain_versions():
        ref = fft_unit.fluid_flat(x, Mn)
        ref_g = fft_unit.fluid_flat(cot, Mn)
    _compare(fft_unit.fluid_flat(x, Mn), ref, 1e-4, 0.0)
    leaf = x.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(fft_unit.fluid_flat(leaf, Mn), leaf, cot)
    _compare(got, ref_g, 1e-4, 0.0)
    assert kernels.launch_counts()["fluid_flat"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 19, 11, 35), (2, 3, 5, 9, 33), (4, 3, 64, 64, 64)])
@pytest.mark.parametrize("march", [0, 8, 16])
def test_compose_march_on_cuda(cuda, shape, march):
    """K2 (``lagomorph_compose_fwd``, its blocks marching along x over 8 x
    32 (y, z) tiles) at forced march lengths and the one it takes, at
    shapes that cross its march and its tile: out bit-equal to the plain
    version and the flags equal, at s = -0.2 and 0.7, on displacements with
    voxels outside the unit regime and at its edges, a second launch
    bit-identical; inside the regime the flag is true, and false once one
    voxel on the last plane of a march leaves it."""
    rng = np.random.default_rng(14)
    N, _, X, Y, Z = shape

    def c(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)

    def launch(p, v, s):
        out = torch.empty_like(p)
        flag = torch.ones((), dtype=torch.int32, device=cuda)
        _build.call("lagomorph_compose_fwd", p.data_ptr(), v.data_ptr(), s, out.data_ptr(),
                    flag.data_ptr(), N, X, Y, Z, march, kernels.stream_of(p))
        return out, bool(flag)

    def edge_disp(scale=1.0):
        d = rng.uniform(-0.99, 0.99, shape)
        pick = rng.uniform(size=shape) < 0.125
        d[pick] = rng.choice([-2.5, -1.5, 1.0, 1.5, 3.7, -1.0, 0.0], size=int(pick.sum()))
        return c(d * scale)

    p = edge_disp()
    for s in (-0.2, 0.7):
        v = edge_disp(1.0 / s)
        out, flag = launch(p, v, s)
        ref, r_flag = epdiff_unit.compose_plain(p, v, s)
        assert torch.equal(out, ref) and flag is bool(r_flag)
        again = launch(p, v, s)
        assert torch.equal(again[0], out) and again[1] is flag
        v = c(rng.uniform(-0.99, 0.99, shape) / s)
        out, flag = launch(p, v, s)
        assert torch.equal(out, epdiff_unit.compose_plain(p, v, s)[0]) and flag
        if march:
            v[N - 1, 1, min(march, X) - 1, Y - 1, Z - 1] = 1.5 / s
            assert not launch(p, v, s)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 19, 11, 35), (2, 3, 5, 9, 33), (4, 3, 64, 64, 64)])
@pytest.mark.parametrize("march", [0, 8, 16])
def test_ad_star_march_on_cuda(cuda, shape, march):
    """K1 (``lagomorph_ad_star_fwd``, its blocks marching along x over 8 x
    32 (y, z) tiles) at forced march lengths and the one it takes, at
    shapes that cross its march and its tile, with batch-1 and batch-N
    momenta, writing ``mw`` and not: out and mw bit-equal to the plain
    version and the flags equal, on displacements with voxels outside the
    unit regime and at its edges, a second launch bit-identical; inside the
    regime the flag is true, and false once one voxel on the last plane of
    a march leaves it."""
    rng = np.random.default_rng(15)
    N, _, X, Y, Z = shape

    def c(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)

    def launch(p, m0, want_mw):
        out = torch.empty_like(p)
        mw = torch.empty_like(p) if want_mw else None
        flag = torch.ones((), dtype=torch.int32, device=cuda)
        _build.call("lagomorph_ad_star_fwd", p.data_ptr(), m0.data_ptr(), out.data_ptr(),
                    None if mw is None else mw.data_ptr(), flag.data_ptr(), N, m0.shape[0],
                    X, Y, Z, march, kernels.stream_of(p))
        return out, bool(flag), mw

    d = rng.uniform(-0.99, 0.99, shape)
    pick = rng.uniform(size=shape) < 0.125
    d[pick] = rng.choice([-2.5, -1.5, 1.0, 1.5, 3.7, -1.0, 0.0], size=int(pick.sum()))
    for p in (c(d), c(rng.uniform(-0.99, 0.99, shape))):
        for nb in (1, N):
            m0 = c(rng.standard_normal((nb, 3, X, Y, Z)))
            ref, r_flag, r_mw = epdiff_unit.ad_star_plain(p, m0, want_mw=True)
            for want_mw in (True, False):
                out, flag, mw = launch(p, m0, want_mw)
                assert torch.equal(out, ref) and flag is bool(r_flag)
                assert not want_mw or torch.equal(mw, r_mw)
                again = launch(p, m0, want_mw)
                assert torch.equal(again[0], out) and again[1] is flag
                assert not want_mw or torch.equal(again[2], mw)
    assert flag  # the last p lies inside the regime
    if march:
        p[N - 1, 1, min(march, X) - 1, Y - 1, Z - 1] = 1.0  # the upper bound is open
        assert not launch(p, m0, True)[1] and not launch(p, m0, False)[1]
