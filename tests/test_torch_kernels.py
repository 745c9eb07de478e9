"""The port's kernel modules: each kernel's plain version against its JAX
counterpart on the CPU (float64), and the dispatch rules.  The kernels
themselves are held against their plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

* K1 ``epdiff_unit.ad_star`` vs ``lm.Ad_star(..., mode="unit")``;
* K2 ``epdiff_unit.compose`` vs ``lm.compose_disp_vel(..., mode="unit")``;
* K4 ``warp_unit.sample_displacement_unit`` vs
  ``ops.sampling.sample_displacement_unit``;
* K3 ``fft_unit.fluid_flat`` (through ``FluidMetric.sharp``) vs the JAX
  ``FluidMetric.sharp``;
* the K1/K2 flags vs ``lddmm._in_unit``.

On the CPU every ``*_supported()`` gate of the JAX package is false, so it
computes these functions through its plain formulations.  Tolerances: the
stencils do the same float64 operations in the same order (1e-12 absolute;
they come out bit-equal); the fluid solve goes through two libraries' FFTs
(1e-9 relative to max|ref|).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lagomorph_tpu as lm
from lagomorph_tpu import lddmm as jlddmm
from lagomorph_tpu.ops import sampling as jsamp
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch.ops import kernels
from lagomorph_tpu_torch.ops.kernels import epdiff_unit, fft_unit, warp_unit

torch.set_num_threads(2)

STENCIL_ATOL = 1e-12
FFT_RTOL = 1e-9
SHAPES = [(2, 3, 16, 12, 20), (1, 3, 9, 8, 7)]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(ref, got, atol=STENCIL_ATOL):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("m_batch", ["one", "N"])
def test_ad_star_plain_matches_jax(rng, shape, m_batch):
    phiinv = rng.uniform(-1, 1, shape)
    m0 = rng.standard_normal(((1 if m_batch == "one" else shape[0]),) + shape[1:])
    out, flag = epdiff_unit.ad_star(t(phiinv), t(m0))
    close(lm.Ad_star(jnp.asarray(phiinv), jnp.asarray(m0), mode="unit"), out)
    assert bool(flag) is bool(jlddmm._in_unit(jnp.asarray(phiinv))) is True


@pytest.mark.parametrize("shape", SHAPES)
def test_compose_plain_matches_jax(rng, shape):
    phiinv = rng.uniform(-1, 1, shape)
    v = rng.uniform(-4.9, 4.9, shape)
    out, flag = epdiff_unit.compose(t(phiinv), t(v), -0.2)
    close(lm.compose_disp_vel(jnp.asarray(phiinv), jnp.asarray(v), dt=-0.2, mode="unit"), out)
    assert bool(flag) is bool(jlddmm._in_unit(-0.2 * jnp.asarray(v))) is True


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("channels,image_batch", [(1, "one"), (3, "N")])
def test_warp_unit_plain_matches_jax(rng, shape, channels, image_batch):
    I = rng.standard_normal(((1 if image_batch == "one" else shape[0]), channels) + shape[2:])
    d = rng.uniform(-1, 1, shape)
    close(jsamp.sample_displacement_unit(jnp.asarray(I), jnp.asarray(d)),
          warp_unit.sample_displacement_unit(t(I), t(d)))


@pytest.mark.parametrize("shape", SHAPES)
def test_fluid_flat_plain_matches_jax_sharp(rng, shape):
    """K3's plain version, reached through FluidMetric.sharp (beta = 0; the
    (1, 3, ...) shape packs an odd slab count with one zero slab)."""
    m = rng.standard_normal(shape)
    ref = np.asarray(lm.FluidMetric((0.1, 0.0, 0.01)).sharp(jnp.asarray(m)))
    before = kernels.launch_counts()
    got = lt.FluidMetric((0.1, 0.0, 0.01)).sharp(t(m))
    close(ref, got, atol=FFT_RTOL * float(np.abs(ref).max()))
    assert kernels.launch_counts() == before  # the plain version launches nothing


@pytest.mark.parametrize("where,value,expect", [
    (None, 0.0, True), ((0, 2, 3, 4, 5), 1.0, False), ((1, 0, 0, 0, 0), -1.0, True),
    ((0, 1, 8, 11, 19), -1.0000001, False), ((1, 2, 0, 0, 1), np.nan, False),
])
def test_flags_match_jax_in_unit(rng, where, value, expect):
    """K1's flag (of phiinv) and K2's flag (of s*v) against lddmm._in_unit,
    at the half-open bounds [-1, 1)."""
    shape = SHAPES[0]
    p = rng.uniform(-0.9, 0.9, shape)
    if where is not None:
        p[where] = value
    m0 = rng.standard_normal(shape)
    assert bool(epdiff_unit.ad_star(t(p), t(m0))[1]) is expect
    assert bool(jlddmm._in_unit(jnp.asarray(p))) is expect
    # compose flags s*v; s = 1 makes s*v = p exactly
    assert bool(epdiff_unit.compose(t(m0), t(p), 1.0)[1]) is expect


def test_plain_versions_context_and_counters(rng):
    """On the CPU the wrappers take the plain versions and count no
    launches; plain_versions() is explicit and scoped; a device without
    kernels raises."""
    shape = SHAPES[1]
    p = t(rng.uniform(-1, 1, shape))
    kernels.reset_launches()
    assert set(kernels.launch_counts()) == {
        "warp_unit_fwd", "ad_star_fwd", "compose_fwd", "fluid_flat"}
    a = epdiff_unit.ad_star(p, p)[0]
    with kernels.plain_versions():
        assert kernels._PLAIN.get()
        b = epdiff_unit.ad_star_plain(p, p)[0]
    assert not kernels._PLAIN.get()
    assert torch.equal(a, b)
    assert all(n == 0 for n in kernels.launch_counts().values())
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.use_kernel(torch.empty(1, device="meta"))
    for k in kernels.KERNELS.values():
        assert k.source.startswith("lagomorph_tpu_torch/csrc/") and k.source.endswith(".cu")
        assert k.replaces.startswith("lagomorph_tpu/ops/pallas/")


def test_plain_versions_differentiate_on_cpu(rng):
    """On the CPU the plain versions are ordinary differentiable torch code:
    the warp's gradient in the image slot sums to the number of output
    voxels (each output's 27 weights sum to 1)."""
    d = t(rng.uniform(-0.9, 0.9, SHAPES[0]))
    I = t(rng.standard_normal((1, 1) + SHAPES[0][2:])).requires_grad_(True)
    warp_unit.sample_displacement_unit(I, d).sum().backward()
    n_out = SHAPES[0][0] * int(np.prod(SHAPES[0][2:]))
    assert abs(float(I.grad.sum()) - n_out) < 1e-9 * n_out
