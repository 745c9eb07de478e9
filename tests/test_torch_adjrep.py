"""The port's adjoint actions (``lagomorph_tpu_torch/adjrep.py``) against
the JAX package, on the CPU in float64: ``ad``, ``Ad``, ``ad_star``,
``Ad_star``, ``ad_dagger``, ``Ad_dagger``, ``sym`` and ``sym_dagger`` in
2D (12^2) and 3D (8^3) on displacements that leave the unit regime, and
the adjoint identities of tests/test_adjrep.py on the port's functions.

Tolerance: 1e-12 of max|ref| for the actions without a fluid solve, 1e-9
for those with one (the two libraries' FFTs round differently); the
identities to 1e-10 of ``sum |a * b|`` of the left side's inner product
(the metric's solves amplify rounding by up to 1/gamma^2 = 1e6).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lagomorph_tpu as lm
import lagomorph_tpu_torch as lt

torch.set_num_threads(2)

PARAMS = (0.1, 0.01, 0.001)
SHAPES = {2: (2, 2, 12, 12), 3: (2, 3, 8, 8, 8)}
# name, arguments (fields by letter, "M" the metric), whether a fluid solve runs
ACTIONS = (("ad", "vw", False), ("Ad", "pv", False), ("ad_star", "vm", False),
           ("Ad_star", "pn", False), ("ad_dagger", "vwM", True), ("Ad_dagger", "pwM", True),
           ("sym", "vwM", True), ("sym_dagger", "vwM", True))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dim", [2, 3])
def test_actions_match_jax(rng, dim):
    """Each action on the same fields: ``p`` a displacement of up to a few
    voxels (the general and bounded warp tiers), ``n`` batch-1 momenta
    that ``Ad_star`` broadcasts."""
    shape = SHAPES[dim]
    fields = {c: rng.standard_normal(shape) for c in "vwm"}
    fields["n"] = rng.standard_normal((1,) + shape[1:])
    fields["p"] = 1.5 * rng.standard_normal(shape)
    jmetric, metric = lm.FluidMetric(PARAMS), lt.FluidMetric(PARAMS)

    def jargs(names):
        return [jmetric if c == "M" else jnp.asarray(fields[c]) for c in names]

    refs = jax.jit(lambda: {name: getattr(lm, name)(*jargs(a)) for name, a, _ in ACTIONS})()
    for name, a, solves in ACTIONS:
        got = getattr(lt, name)(*[metric if c == "M" else t(fields[c]) for c in a])
        ref = np.asarray(refs[name])
        assert got.shape == ref.shape, name
        tol = (1e-9 if solves else 1e-12) * float(np.abs(ref).max())
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol, err_msg=name)


def _inner(a, b):
    return float(torch.sum(a * b)), float(torch.sum((a * b).abs()))


@pytest.mark.parametrize("dim", [2, 3])
def test_adjoint_identities(rng, dim):
    """``<ad(v, w), m> = <w, ad_star(v, m)>``; ``<ad(x, y), z>_M = <y,
    ad_dagger(x, z)>_M`` and ``<sym(x, y), z>_M = <y, sym_dagger(x, z)>_M``
    with ``<a, b>_M = <flat(a), b>``; ``<Ad(phi, v), m> = <v, Ad_star(phi,
    m)>`` (the splat-based ``Ad``)."""
    shape = (2, dim) + (5,) * dim
    x, y, z, phi = (t(rng.standard_normal(shape)) for _ in range(4))
    metric = lt.FluidMetric(PARAMS)
    pairs = [
        (_inner(lt.ad(x, y), z), _inner(y, lt.ad_star(x, z))),
        (_inner(metric.flat(lt.ad(x, y)), z), _inner(metric.flat(y), lt.ad_dagger(x, z, metric))),
        (_inner(metric.flat(lt.sym(x, y, metric)), z),
         _inner(metric.flat(y), lt.sym_dagger(x, z, metric))),
        (_inner(lt.Ad(phi, x), z), _inner(x, lt.Ad_star(phi, z))),
    ]
    for i, ((lhs, scale), (rhs, _)) in enumerate(pairs):
        assert abs(lhs - rhs) <= 1e-10 * scale, (i, lhs, rhs, scale)


@pytest.mark.parametrize("dim", [2, 3])
def test_Ad_star_gradcheck(rng, dim):
    """Autograd through ``Ad_star`` (the plain version of K1/K10 in the
    unit regime, the gather outside it) against finite differences."""
    for scale in (0.3, 1.5):
        shape = (1, dim) + (3,) * dim
        phiinv = t(scale * rng.standard_normal(shape)).requires_grad_(True)
        m = t(rng.standard_normal(shape)).requires_grad_(True)
        assert torch.autograd.gradcheck(lt.Ad_star, (phiinv, m), atol=1e-6, rtol=1e-5)
