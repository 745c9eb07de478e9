"""The port's ``parallel`` package and the parallel paths of the builders
and models, against the JAX package on the CPU in float64.

The JAX functions run on the conftest's virtual CPU devices with a mesh of
n of them (``get_mesh(devices=jax.devices()[:n])``), the port's on a mesh
naming the CPU n times, for n in (2, 4):

* ``process_shard_indices``, ``shard_sizes``, ``pad_batch_to_multiple`` and
  the shardings' layouts;
* ``sharded_fluid_operator`` (both directions): values and VJP against the
  JAX one and the port's dense ``fluid_operator``, and its self-adjointness;
* ``sharded_expmap`` against the JAX one and the dense ``expmap``, value
  and momentum gradient;
* ``sharded_atlas_loss`` with and without a mask, loss and gradients in
  ``m`` and ``I``, and ``make_lddmm_atlas_step(spatial_mesh=...)``;
* ``LDDMMAtlasBuilder`` with a mesh (batch 3 over 2 entries: padding) and
  with ``spatial_shard``, and its guards; ``affine_atlas`` with a mesh and
  ``DeepLDDMMAtlas`` with a mesh;
* the data-parallel step split as two processes would run it (the loss
  normalised by the global count, the sums added) against one step.

Tolerance: 1e-9 of max|ref| (the pencil FFT and the two libraries' FFTs
associate differently, ~1e-15, and descent carries it over iterations).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lagomorph_tpu as lm
import lagomorph_tpu.parallel as jpar
from lagomorph_tpu import affine as jaffine
from lagomorph_tpu import lddmm as jlddmm
from lagomorph_tpu import models as jmodels
from lagomorph_tpu.ops import set_warp_mode as jset_warp_mode
import lagomorph_tpu_torch as lt
import lagomorph_tpu_torch.parallel as tpar
from lagomorph_tpu_torch import affine as taffine
from lagomorph_tpu_torch import convert, lddmm as tlddmm, models as tmodels
from lagomorph_tpu_torch.parallel.mesh import Sharded

torch.set_num_threads(2)

RTOL = 1e-9
PARAMS = (0.1, 0.0, 0.01)
NS = (2, 4)
# XLA's CPU compilation at its lowest optimisation level: the JAX functions
# here run once each, and compiling them is most of the file's time
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jit(f):
    return jax.jit(f, compiler_options=FAST_COMPILE)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def close_rel(ref, got, rtol=RTOL, what=""):
    ref = np.asarray(ref)
    if isinstance(got, Sharded):
        got = got.numpy()
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * float(np.abs(ref).max()),
                               err_msg=what)


def jmesh(n):
    return jpar.get_mesh(devices=jax.devices()[:n])


def tmesh(n):
    return tpar.get_mesh(devices=["cpu"] * n)


def shape_for(n):
    return (2, 3, 4 * n, 4 * n, 6)


def momenta(rng, shape, max_v0=0.5):
    """Momenta whose initial velocity peaks at ``max_v0`` voxels (the unit
    regime, where the sharded shooting is the dense one)."""
    m = rng.standard_normal(shape)
    return m * (max_v0 / float(lt.FluidMetric(PARAMS).sharp(t(m)).abs().max()))


def test_all_and_helpers_match_jax(rng):
    assert tpar.__all__ == jpar.__all__
    for n, world in ((16, 2), (7, 3), (2, 4), (0, 2)):
        assert tpar.shard_sizes(n, world) == jpar.shard_sizes(n, world)
        for rank in range(world):
            assert (tpar.process_shard_indices(n, world, rank)
                    == jpar.process_shard_indices(n, world, rank))
    assert tpar.process_shard_indices(5) == list(range(5))  # no process group: one process
    for n, mult in ((5, 8), (6, 3), (4, 4)):
        x = rng.standard_normal((n, 3))
        ref, rn = jpar.pad_batch_to_multiple(x, mult)
        got, gn = tpar.pad_batch_to_multiple(x, mult)
        np.testing.assert_array_equal(got, ref)
        assert gn == rn
    mesh = tmesh(4)
    assert mesh.shape == {"data": 4} and mesh.size == 4
    for tsh, jsh in ((tpar.data_sharding(mesh), jpar.data_sharding(jmesh(4))),
                     (tpar.replicated_sharding(mesh), jpar.replicated_sharding(jmesh(4))),
                     (tpar.spatial_sharding(mesh, 5), jpar.spatial_sharding(jmesh(4), 5))):
        assert tsh.spec == tuple(jsh.spec)
    x = t(rng.standard_normal((8, 2, 4, 4)))
    xs = tpar.shard_batch(x, mesh)
    assert [s.shape[0] for s in xs] == [2] * 4 and torch.equal(xs.gather(), x)
    xr = tpar.replicate(x[:1], mesh)
    assert len(xr) == 4 and all(torch.equal(s, x[:1]) for s in xr) and xr.shape == (1, 2, 4, 4)
    slabs = tpar.spatial_sharding(mesh, 4).put(x)
    assert slabs.shape == x.shape and torch.equal(slabs.gather(), x)
    assert all(s.is_contiguous() for s in slabs)
    np.testing.assert_array_equal(tpar.local_shard(slabs), x.numpy())
    assert torch.equal(tpar.put_global(x.numpy(), torch.device("cpu")), x)
    np.testing.assert_array_equal(tpar.allsum_hosts(np.arange(3.0)), np.arange(3.0))
    with pytest.raises(ValueError, match="does not split"):
        tpar.shard_batch(x[:3], mesh)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("inverse", [True, False])
def test_sharded_fluid_operator_matches_jax(rng, n, inverse):
    """Values and the vector-Jacobian product against the JAX pencil solve
    and the port's dense operator; ``<A x, y> = <x, A y>``."""
    shape = shape_for(n)
    mv, g = rng.standard_normal(shape), rng.standard_normal(shape)
    def op(x):
        return jpar.sharded_fluid_operator(x, PARAMS, inverse, jmesh(n))

    ref, ref_g = jit(lambda x, c: (op(x), jax.vjp(op, x)[1](c)[0]))(jnp.asarray(mv),
                                                                     jnp.asarray(g))
    x = t(mv).requires_grad_(True)
    got = tpar.sharded_fluid_operator(x, PARAMS, inverse, tmesh(n))
    close_rel(ref, got)
    close_rel(lt.fluid_operator(t(mv), PARAMS, inverse), got)
    (grad,) = torch.autograd.grad(got, x, t(g))
    close_rel(ref_g, grad)
    ag = tpar.sharded_fluid_operator(t(g), PARAMS, inverse, tmesh(n))
    lhs, rhs = float(torch.sum(got.detach() * t(g))), float(torch.sum(t(mv) * ag))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    # sharded in, sharded out, through ShardedFluidMetric
    met = tpar.ShardedFluidMetric(PARAMS, tmesh(n))
    slabs = tpar.spatial_sharding(tmesh(n), 5).put(t(mv))
    out = met.sharp(slabs) if inverse else met.flat(slabs)
    assert isinstance(out, Sharded) and len(out) == n
    close_rel(ref, out)


@pytest.mark.parametrize("n", NS)
def test_sharded_expmap_matches_jax(rng, n):
    """Value and gradient (of ``sum(phiinv**2)``) against the JAX sharded
    shooting and the dense ``expmap`` on the unit tiers; with
    ``checkpoints`` equal to without."""
    m = momenta(rng, shape_for(n))
    jm = jnp.asarray(m)
    jmesh_ = jmesh(n)
    def shoot(x):
        return jpar.sharded_expmap(lm.FluidMetric(PARAMS), x, jmesh_, num_steps=3)

    # one compilation for the value and the gradient
    ref, ref_g = jit(lambda x: (shoot(x), jax.grad(lambda y: jnp.sum(shoot(y) ** 2))(x)))(jm)
    metric = lt.FluidMetric(PARAMS)
    got = tpar.sharded_expmap(metric, t(m), tmesh(n), num_steps=3)
    close_rel(ref, got)
    close_rel(lt.expmap(metric, t(m), num_steps=3, transport_mode="unit", compose_mode="unit"),
              got)
    grads = []
    for ckpt in (False, True):
        x = t(m).requires_grad_(True)
        out = tpar.sharded_expmap(metric, x, tmesh(n), num_steps=3, checkpoints=ckpt)
        grads.append(torch.autograd.grad(torch.sum(out ** 2), x)[0])
    close_rel(ref_g, grads[0])
    assert torch.equal(grads[0], grads[1])
    x = t(m).requires_grad_(True)
    dense = lt.expmap(metric, x, num_steps=3, transport_mode="unit", compose_mode="unit")
    close_rel(torch.autograd.grad(torch.sum(dense ** 2), x)[0], grads[0])


@functools.lru_cache(maxsize=None)
def _loss_case(n, masked):
    rng = np.random.default_rng(10 + n)
    shape = shape_for(n)
    m = momenta(rng, shape)
    I = rng.standard_normal((1, 1) + shape[2:])
    img = rng.standard_normal((2, 1) + shape[2:])
    mask = np.array([1.0, 0.0]) if masked else None
    return m, I, img, mask


@pytest.mark.parametrize("n,masked", [(2, False), (4, True)], ids=["nomask-2", "mask-4"])
def test_sharded_atlas_loss_matches_jax(n, masked):
    """Loss, regulariser and the gradients in ``m`` and ``I``."""
    m, I, img, mask = _loss_case(n, masked)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(m_, I_):
        return jpar.sharded_atlas_loss(lm.FluidMetric(PARAMS), I_, m_, jnp.asarray(img), jmesh(n),
                                       reg_weight=0.5, num_steps=4, mask=jmask)

    (ref, ref_reg), (gm_ref, gI_ref) = jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(m), jnp.asarray(I))
    tm, tI = t(m).requires_grad_(True), t(I).requires_grad_(True)
    loss, reg = tpar.sharded_atlas_loss(lt.FluidMetric(PARAMS), tI, tm, t(img), tmesh(n),
                                        reg_weight=0.5, num_steps=4,
                                        mask=None if mask is None else t(mask))
    gm, gI = torch.autograd.grad(loss, (tm, tI))
    loss, reg = loss.detach(), reg.detach()
    assert abs(float(loss) - float(ref)) <= RTOL * abs(float(ref))
    assert abs(float(reg) - float(ref_reg)) <= RTOL * abs(float(ref_reg))
    close_rel(gm_ref, gm)
    close_rel(gI_ref, gI)
    if masked:
        assert not gm[1].any()  # the masked subject has no gradient
    dense = tlddmm._lddmm_loss(t(I), t(m), t(img), lt.FluidMetric(PARAMS), 0.5, 4,
                               mask=None if mask is None else t(mask))
    assert abs(float(dense[0]) - float(loss)) <= 1e-6 * abs(float(loss))


def test_spatial_step_matches_jax():
    """``make_lddmm_atlas_step(spatial_mesh=...)``, preconditioned, on a
    2-entry mesh: the new momenta, the atlas gradient, the loss and the
    regulariser; the same step on sharded inputs returns sharded outputs."""
    n = 2
    m, I, img, _ = _loss_case(n, False)
    kw = dict(reg_weight=0.5, learning_rate_pose=1e-2, integration_steps=3,
              momentum_preconditioning=True)
    ref = jit(jlddmm.make_lddmm_atlas_step(lm.FluidMetric(PARAMS), spatial_mesh=jmesh(n),
                                               **kw))(jnp.asarray(I), jnp.asarray(m),
                                                      jnp.asarray(img))
    step = tlddmm.make_lddmm_atlas_step(lt.FluidMetric(PARAMS), spatial_mesh=tmesh(n), **kw)
    got = step(t(I), t(m), t(img))
    for r, g, what in zip(ref, got, ("m", "I_grad", "loss", "reg")):
        close_rel(r, g, what=what)
    sp = tpar.spatial_sharding(tmesh(n), 5)
    sharded = step(sp.put(t(I)), sp.put(t(m)), sp.put(t(img)))
    assert isinstance(sharded[0], Sharded) and isinstance(sharded[1], Sharded)
    for a, b in zip(sharded, got):
        close_rel(b.detach().numpy(), a, rtol=1e-14)


def synth_images(n, res, dim=3, seed=3):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(res, dtype=np.float64)] * dim, indexing="ij"))
    c = (res - 1) / 2.0
    return np.stack([np.exp(-sum((grid[d] - c - off[d]) ** 2 for d in range(dim))
                            / (2 * (res / 6) ** 2))
                     for off in rng.uniform(-1.5, 1.5, (n, dim))])[:, None]


BUILDER = dict(num_epochs=2, lddmm_integration_steps=2, reg_weight=1e-1, learning_rate_pose=1e-2,
               learning_rate_image=1e2, progress_bar=False, dtype=np.float64)


def _compare_builders(ref, got):
    close_rel(np.asarray(ref.I), got.I, what="atlas")
    assert len(got.ms) == len(ref.ms)
    for r, m in zip(ref.ms, got._momenta_host()):
        assert np.abs(np.asarray(r)).max() > 0
        close_rel(np.asarray(r), m, what="momenta")
    for k in ("epoch_losses", "epoch_reg_terms", "iter_losses", "iter_reg_terms"):
        close_rel(np.asarray(getattr(ref, k)), np.asarray(getattr(got, k)), what=k)


def test_builder_mesh_matches_jax():
    """5 subjects in minibatches of 3 over a 2-entry mesh (each minibatch
    padded to 4, the padding masked out), 2D, over 2 epochs, streaming and
    with ``keep_data_on_device``, against the JAX builder on a 2-device
    mesh."""
    images = synth_images(5, 10, dim=2)
    prev = jset_warp_mode("general")
    try:
        ref = lm.LDDMMAtlasBuilder(list(images), metric=lm.FluidMetric([0.01, 0.0, 0.1]),
                                   mesh=jmesh(2), batch_size=3, **BUILDER)
        ref.run()
    finally:
        jset_warp_mode(prev)
    for keep in (False, True):
        got = lt.LDDMMAtlasBuilder(list(images), metric=lt.FluidMetric([0.01, 0.0, 0.1]),
                                   mesh=tmesh(2), batch_size=3, keep_data_on_device=keep,
                                   **BUILDER)
        got.run()
        assert got._pad_multiple == 2 and [m.shape[0] for m in got._momenta_host()] == [3, 2]
        assert isinstance(got._staged(0)[1], Sharded)
        _compare_builders(ref, got)


def test_builder_spatial_shard_matches_jax():
    """``spatial_shard=True`` over a 2-entry mesh: 3D subjects at (8, 8, 6),
    minibatches of 2, 2 epochs, against the JAX builder on a 2-device mesh;
    the atlas lies on the mesh as X slabs."""
    images = synth_images(4, 8)[..., 1:7]
    kw = dict(BUILDER, batch_size=2)
    ref = lm.LDDMMAtlasBuilder(list(images), metric=lm.FluidMetric([0.1, 0.0, 1.0]),
                               mesh=jmesh(2), spatial_shard=True, **kw)
    ref.run()
    got = lt.LDDMMAtlasBuilder(list(images), metric=lt.FluidMetric([0.1, 0.0, 1.0]),
                               mesh=tmesh(2), spatial_shard=True, **kw)
    got.run()
    assert isinstance(got.I, Sharded) and len(got.I) == 2
    _compare_builders(ref, got)


def test_spatial_shard_guards_match_jax():
    """The builder's ``spatial_shard`` guards raise the JAX package's
    ``ValueError``s."""
    imgs = list(np.zeros((2, 1, 12, 12, 8)))
    kw = dict(spatial_shard=True, num_epochs=1, progress_bar=False)
    cases = [({"device": "cpu"}, {}, "requires a mesh"),
             ({"mesh": tmesh(2), "momentum_shape": (6, 6, 4)},
              {"mesh": jmesh(2), "momentum_shape": (6, 6, 4)}, "same grid"),
             ({"mesh": tmesh(8)}, {"mesh": jmesh(8)}, "divisible by the mesh size")]
    for topts, jopts, match in cases:
        with pytest.raises(ValueError, match=match):
            lm.LDDMMAtlasBuilder(imgs, **kw, **jopts).initialize()
        with pytest.raises(ValueError, match=match):
            lt.LDDMMAtlasBuilder(imgs, **kw, **topts).initialize()


def test_data_parallel_step_as_two_processes(rng):
    """The atlas step run on each half of a minibatch with the count of the
    whole (as two processes run it) gives, summed, the loss, regulariser
    and atlas gradient of the whole, and each half's momenta those of the
    whole; a minibatch split over a mesh gives the same."""
    shape = (4, 2, 10, 10)
    m = momenta(rng, shape)
    I, img = rng.standard_normal((1, 1, 10, 10)), rng.standard_normal((4, 1, 10, 10))
    step = lt.make_lddmm_atlas_step(lt.FluidMetric(PARAMS), reg_weight=0.5,
                                    learning_rate_pose=1e-2, integration_steps=3)
    ones = torch.ones(4, dtype=torch.float64)
    whole = step(t(I), t(m), t(img), ones, count=4)
    halves = [step(t(I), t(m[h]), t(img[h]), ones[h], count=4)
              for h in (slice(0, 2), slice(2, 4))]
    close_rel(whole[0].numpy(), torch.cat([h[0] for h in halves]))
    for k in (1, 2, 3):
        close_rel(whole[k].numpy(), sum(h[k] for h in halves))
    ref = step(t(I), t(m), t(img))
    for a, b in zip(ref, whole):
        close_rel(a.numpy(), b)
    meshed = step(t(I), tpar.shard_batch(t(m), tmesh(2)), tpar.shard_batch(t(img), tmesh(2)),
                  tpar.shard_batch(ones, tmesh(2)))
    assert isinstance(meshed[0], Sharded)
    for a, b in zip(ref, meshed):
        close_rel(a.numpy(), b)


def test_affine_atlas_mesh_matches_jax(rng):
    """6 subjects in minibatches of 4 (an uneven last batch, padded to the
    mesh) over a 2-entry mesh, 2 epochs, against the JAX ``affine_atlas`` on
    a 2-device mesh, streaming and on the device."""
    imgs = list(synth_images(6, 10, dim=2, seed=5))
    kw = dict(num_epochs=2, batch_size=4, reg_weightA=0.1, reg_weightT=0.1,
              learning_rate_A=1e-2, learning_rate_T=1.0, learning_rate_I=10.0,
              progress_bar=False)
    ref = jaffine.affine_atlas(imgs, np.zeros((6, 2, 2)), np.zeros((6, 2)), mesh=jmesh(2), **kw)
    for keep in (False, True):
        got = taffine.affine_atlas(imgs, np.zeros((6, 2, 2)), np.zeros((6, 2)), mesh=tmesh(2),
                                   keep_data_on_device=keep, **kw)
        for r, g, what in zip(ref, got, ("I", "A", "T", "epoch_losses", "iter_losses")):
            close_rel(np.asarray(r), g if isinstance(g, torch.Tensor) else np.asarray(g),
                      what=what)


def test_deep_lddmm_atlas_mesh_matches_jax():
    """2 epochs of the JAX model on a 2-device mesh (its float32 parameters
    cast to float64, its optimiser state made anew) against the port's on a
    2-entry mesh from the same parameters; 5 subjects at 12^2 in minibatches
    of 3 (padded to 4)."""
    imgs = synth_images(5, 12, dim=2, seed=6)
    kw = dict(batch_size=3, integration_steps=2, reg_weight=1e-2, learning_rate_net=1e-3,
              learning_rate_image=10.0, dtype=np.float64, progress_bar=False)
    params = (0.01, 0.0, 0.1)
    prev = jset_warp_mode("general")
    try:
        ref = jmodels.DeepLDDMMAtlas(list(imgs), metric=lm.FluidMetric(params), mesh=jmesh(2),
                                     **kw)
        ref.params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), ref.params)
        ref.opt_state = ref.tx.init(ref.params)
        init = convert.momentum_net_state(ref.params)
        ref.fit(num_epochs=2)
    finally:
        jset_warp_mode(prev)
    got = tmodels.DeepLDDMMAtlas(list(imgs), metric=lt.FluidMetric(params), mesh=tmesh(2), **kw)
    got.net.load_state_dict(init)
    got.fit(num_epochs=2)
    np.testing.assert_allclose(got.epoch_losses, ref.epoch_losses, rtol=RTOL, atol=0)
    close_rel(ref.I, got.I, what="atlas")
    trained = convert.momentum_net_state(ref.params)
    for k, p in got.net.state_dict().items():
        close_rel(trained[k].numpy(), p, what=k)
