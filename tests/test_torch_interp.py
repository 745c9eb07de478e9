"""The port's splat, Hessian diagonal, ``compose_vel_disp`` and global warp
mode against the JAX package, on the CPU in float64:

* ``splat_linear``, ``splat``, ``interp_hessian_diagonal_image`` and
  ``compose_vel_disp`` in 2D and 3D, and ``splat`` as ``interp``'s
  transpose;
* ``set_warp_mode`` / ``get_warp_mode``: the previous mode returned, a
  mode outside the four refused;
* ``expmap``, ``expmap_advect`` and one ``make_lddmm_atlas_step`` under
  each global mode against the JAX functions under the same mode (set
  before the JAX function is built and traced), with the unit-regime
  kernels' wrappers (K1, K2, K8, K10, K11) counted: none is called under
  "bounded" or "general".

Tolerance: 1e-12 of max|ref| for the scatters and warps (the same sums in
another order), 1e-9 where a fluid solve runs (the two libraries' FFTs
round differently).  The ``modes`` fixture restores both packages'
global modes.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lagomorph_tpu as lm
from lagomorph_tpu import lddmm as jlddmm
from lagomorph_tpu.ops import set_warp_mode as jset_warp_mode
from lagomorph_tpu.ops import sampling as jsampling
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import deform, lddmm as tlddmm
from lagomorph_tpu_torch.ops import sampling as tsampling
from lagomorph_tpu_torch.ops.kernels import epdiff2d, epdiff_unit, shoot2d

torch.set_num_threads(2)

OP_RTOL = 1e-12
FFT_RTOL = 1e-9
PARAMS = (0.1, 0.0, 0.01)
MODES = ("auto", "unit", "bounded", "general")
SHAPES = {2: (2, 2, 12, 10), 3: (2, 3, 8, 7, 6)}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close_rel(ref, got, rtol=OP_RTOL):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * float(np.abs(ref).max()))


@pytest.fixture
def modes():
    """Both packages' global warp modes, restored after the test."""
    jprev, tprev = jset_warp_mode("auto"), lt.set_warp_mode("auto")
    yield
    jset_warp_mode(jprev)
    lt.set_warp_mode(tprev)


@pytest.mark.parametrize("dim", [2, 3])
def test_splat_and_hessian_match_jax(rng, dim):
    """``splat_linear`` at coordinates reaching past every edge (mass piled
    up there), ``splat`` and ``interp_hessian_diagonal_image`` (batched,
    3 channels) against the JAX functions."""
    shape = SHAPES[dim]
    N, spatial = shape[0], shape[2:]
    u = 2.5 * rng.standard_normal(shape)
    vals = rng.standard_normal((N, 3) + spatial)
    coords = rng.uniform(-3, max(spatial) + 2, (N, dim) + spatial)
    I = rng.standard_normal((1, 3) + spatial)
    refs = jax.jit(lambda vals_, coords_, u_, I_: (
        jsampling.splat_linear(vals_, coords_, spatial), lm.splat(vals_, u_, dt=0.7),
        lm.interp_hessian_diagonal_image(I_, u_, dt=0.7)))(
            *(jnp.asarray(a) for a in (vals, coords, u, I)))
    H = lt.interp_hessian_diagonal_image(t(I), t(u), dt=0.7)
    assert tuple(H.shape) == (N, 3) + spatial
    for ref, got in zip(refs, (tsampling.splat_linear(t(vals), t(coords), spatial),
                               lt.splat(t(vals), t(u), dt=0.7), H)):
        close_rel(ref, got)
    with pytest.raises(ValueError, match="batch"):
        lt.ops.splat_linear(t(vals[:1]), t(coords), spatial)


@pytest.mark.parametrize("dim", [2, 3])
def test_splat_is_adjoint_of_interp(rng, dim):
    """``<interp(I, u), g> == <I, splat(g, u)>`` for a batch-N ``I``."""
    shape = SHAPES[dim]
    u = 2.0 * rng.standard_normal(shape)
    I = rng.standard_normal((shape[0], 2) + shape[2:])
    g = rng.standard_normal((shape[0], 2) + shape[2:])
    lhs = float(torch.sum(lt.interp(t(I), t(u)) * t(g)))
    rhs = float(torch.sum(t(I) * lt.splat(t(g), t(u))))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("dim", [2, 3])
def test_compose_vel_disp_matches_jax(rng, dim, modes):
    """``compose_vel_disp`` in the unit regime (K2/K11's plain versions at
    ``dt == 1``), and with ``dt != 1`` and a displacement past the bounded
    tier (the gather)."""
    shape = SHAPES[dim]
    for scale, dt in ((0.4, 1.0), (3.0, 0.6)):
        v = rng.standard_normal(shape)
        u = scale * rng.standard_normal(shape)
        ref = jax.jit(lambda v_, u_: lm.compose_vel_disp(v_, u_, dt=dt))(jnp.asarray(v),
                                                                        jnp.asarray(u))
        close_rel(ref, lt.compose_vel_disp(t(v), t(u), dt=dt))
    assert set(deform.__all__) == set(lm.deform.__all__)
    for name in deform.__all__:
        assert callable(getattr(deform, name))


def test_set_warp_mode_contract(modes):
    """``set_warp_mode`` returns the previous mode and refuses a fifth;
    ``get_warp_mode`` reads the live value; ``interp_auto`` with no
    ``mode`` takes the global one."""
    assert lt.ops.get_warp_mode() == "auto"
    assert lt.set_warp_mode("general") == "auto"
    assert lt.set_warp_mode("unit") == "general"
    assert lt.ops.get_warp_mode() == "unit"
    with pytest.raises(ValueError):
        lt.set_warp_mode("fast")
    assert lt.ops.get_warp_mode() == "unit"
    with pytest.raises(ValueError):
        lt.interp_auto(torch.zeros(1, 1, 4, 4), torch.zeros(1, 2, 4, 4), mode="fast")
    # out of the unit regime the forced unit stencil differs from the gather
    rng = np.random.default_rng(3)
    I, u = t(rng.standard_normal((1, 1, 6, 6))), t(1.7 * rng.standard_normal((1, 2, 6, 6)))
    forced = lt.interp_auto(I, u)
    assert not torch.allclose(forced, lt.interp(I, u))
    assert torch.equal(forced, lt.interp_auto(I, u, mode="unit"))
    lt.set_warp_mode("general")
    assert torch.equal(lt.interp_auto(I, u), lt.interp(I, u))


class _Spy:
    """Counts the calls of the unit-regime kernels' wrappers (K1, K2, K8,
    K10, K11), which run their plain versions here."""

    NAMES = ((epdiff_unit, "ad_star"), (epdiff_unit, "compose"), (shoot2d, "shoot2d"),
             (epdiff2d, "ad_star2d"), (epdiff2d, "compose2d"))

    def __init__(self, monkeypatch):
        self.calls = {name: 0 for _, name in self.NAMES}
        for module, name in self.NAMES:
            monkeypatch.setattr(module, name, self._wrap(name, getattr(module, name)))

    def _wrap(self, name, fn):
        def spied(*args, **kw):
            self.calls[name] += 1
            return fn(*args, **kw)
        return spied

    def total(self):
        return sum(self.calls.values())


def _momenta(rng, shape, max_v0):
    m = rng.standard_normal(shape)
    return m * (max_v0 / float(lt.FluidMetric(PARAMS).sharp(t(m)).abs().max()))


@pytest.mark.parametrize("mode", MODES)
def test_expmap_under_global_mode_matches_jax(rng, mode, modes, monkeypatch):
    """3D ``expmap`` (momenta in the unit regime, so every mode's tier
    holds) and ``expmap_advect`` under each global mode, against the JAX
    functions traced under it (one jit of both); K1 and K2 run under "auto"
    and "unit" only (the 2D gate of K8: the atlas step's test below)."""
    spy = _Spy(monkeypatch)
    jset_warp_mode(mode)
    lt.set_warp_mode(mode)
    jmetric, metric = lm.FluidMetric(PARAMS), lt.FluidMetric(PARAMS)
    m = _momenta(rng, SHAPES[3], 0.4)
    refs = jax.jit(lambda m_: (lm.expmap(jmetric, m_, num_steps=4),
                               lm.expmap_advect(jmetric, m_, num_steps=4)))(jnp.asarray(m))
    close_rel(refs[0], lt.expmap(metric, t(m), num_steps=4), FFT_RTOL)
    close_rel(refs[1], lt.expmap_advect(metric, t(m), num_steps=4), FFT_RTOL)
    if mode in ("bounded", "general"):
        assert spy.total() == 0, spy.calls
    else:
        assert spy.calls["ad_star"] == 3, spy.calls
        assert spy.calls["compose"] == 3 + 4, spy.calls  # expmap's substeps, then advect's


@pytest.mark.parametrize("mode", MODES)
def test_atlas_step_under_global_mode_matches_jax(rng, mode, modes, monkeypatch):
    """One 2D ``make_lddmm_atlas_step`` under each global mode against the
    JAX step jitted under it: the new momenta, the atlas gradient and the
    loss; K8 runs under "auto" and "unit" only, the per-step loop else."""
    spy = _Spy(monkeypatch)
    jset_warp_mode(mode)
    lt.set_warp_mode(mode)
    shape = SHAPES[2]
    m = _momenta(rng, shape, 0.4)
    I = rng.standard_normal((1, 1) + shape[2:])
    img = rng.standard_normal((shape[0], 1) + shape[2:])
    kw = dict(reg_weight=0.1, learning_rate_pose=1e-2, integration_steps=3)
    jstep = jax.jit(jlddmm.make_lddmm_atlas_step(lm.FluidMetric(PARAMS), **kw))
    ref = jstep(*(jnp.asarray(a) for a in (I, m, img)))
    got = lt.make_lddmm_atlas_step(lt.FluidMetric(PARAMS), **kw)(t(I), t(m), t(img))
    for r, g in zip(ref[:2], got[:2]):
        close_rel(r, g, FFT_RTOL)
    assert abs(float(got[2]) - float(ref[2])) <= FFT_RTOL * abs(float(ref[2]))
    assert spy.calls["shoot2d"] == (mode in ("auto", "unit")), spy.calls
    assert spy.total() == spy.calls["shoot2d"], spy.calls
    assert tlddmm._fast_integrator(lt.FluidMetric(PARAMS), t(m), 0.2, None) is (
        tlddmm._shoot2d_flagged if mode in ("auto", "unit") else None)
