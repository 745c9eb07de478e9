"""The port's models (``lagomorph_tpu_torch/models``) and
``convert.momentum_net_state`` against the JAX package, on the CPU in
float64:

* ``affine_register``, ``rigid_register`` and ``lddmm_register`` in 2D and
  3D (a batch-1 source broadcast over 2 targets; ``lddmm_register`` on its
  hoisted path, with ``momentum_preconditioning`` and ``checkpoints``, and
  with forced warp tiers): the parameters, the final ``phiinv`` and the
  losses;
* ``MomentumNet``'s forward with the flax net's parameters carried across
  by ``convert.momentum_net_state``, 2D and 3D;
* ``DeepLDDMMAtlas`` over 2 epochs (6 subjects at 12^2, batch 3) from the
  JAX model's initial parameters: the epoch losses, the atlas, the net's
  parameters, ``predict_momenta`` and ``deform_atlas``.

Tolerance: 1e-9 of max|ref| (the fluid solves' FFTs round differently in
the two libraries, ~1e-15, and the descent carries it over iterations).
The JAX side of a path with no forced tier runs under its "general" warp
mode (set before the function is traced, restored after): one branch per
warp to compile, the same function in every tier's regime, which these
momenta keep.
"""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import lagomorph_tpu as lm
from lagomorph_tpu import models as jmodels
from lagomorph_tpu.ops import set_warp_mode as jset_warp_mode
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import convert, models as tmodels

torch.set_num_threads(2)

RTOL = 1e-9
SPATIAL = {2: (12, 12), 3: (8, 8, 8)}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def close_rel(ref, got, rtol=RTOL, what=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * float(np.abs(ref).max()),
                               err_msg=what)


@contextlib.contextmanager
def jax_mode(mode):
    prev = jset_warp_mode(mode)
    try:
        yield
    finally:
        jset_warp_mode(prev)


def blobs(dim, n, shift, seed=2):
    """``(n, 1, *spatial)`` float64 blobs offset by up to ``shift`` voxels."""
    rng = np.random.default_rng(seed)
    spatial = SPATIAL[dim]
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float64) for s in spatial],
                                indexing="ij"))
    out = []
    for _ in range(n):
        off = rng.uniform(-shift, shift, dim)
        r2 = sum((grid[d] - (spatial[d] - 1) / 2 - off[d]) ** 2 for d in range(dim))
        out.append(np.exp(-r2 / (2 * (spatial[0] / 5) ** 2)))
    return np.stack(out)[:, None]


@pytest.mark.parametrize("dim", [2, 3])
def test_affine_and_rigid_register_match_jax(dim):
    """Both optimisers over 5 iterations: ``A`` / ``v``, ``T`` and the
    losses before each update."""
    imgs = blobs(dim, 3, 1.5)
    src, tgt = imgs[:1], imgs[1:]
    kw = dict(num_iters=5, learning_rate_A=0.05, learning_rate_T=20.0)
    refs = jmodels.affine_register(jnp.asarray(src), jnp.asarray(tgt), **kw)
    got = tmodels.affine_register(t(src), t(tgt), **kw)
    for name, r, g in zip(("A", "T", "losses"), refs, got):
        close_rel(r, g, what=name)
    assert float(got[2][-1]) < float(got[2][0])
    kw = dict(num_iters=5, learning_rate_v=0.5, learning_rate_T=20.0)
    refs = jmodels.rigid_register(jnp.asarray(src), jnp.asarray(tgt), **kw)
    got = tmodels.rigid_register(t(src), t(tgt), **kw)
    assert tuple(got[0].shape) == ((2,) if dim == 2 else (2, 3))
    for name, r, g in zip(("v", "T", "losses"), refs, got):
        close_rel(r, g, what=name)
    assert float(np.abs(np.asarray(refs[0])).max()) > 1e-6  # the rotations moved


# (dim, momentum_preconditioning, checkpoints, transport_mode, compose_mode)
LDDMM_CASES = [(2, False, False, None, None), (3, False, False, None, None),
               (3, True, True, None, None), (2, True, True, "bounded", "unit")]


@pytest.mark.parametrize("dim,precondition,ckpt,transport,compose", LDDMM_CASES)
def test_lddmm_register_matches_jax(dim, precondition, ckpt, transport, compose):
    """4 iterations of 3 integration steps: the momenta, the final inverse
    deformation and the losses."""
    imgs = blobs(dim, 3, 1.0)
    src, tgt = imgs[:1], imgs[1:]
    params = (0.1, 0.0, 0.03)
    kw = dict(num_iters=4, learning_rate=(2.0 if precondition else 8e-3), reg_weight=1e-3,
              integration_steps=3, momentum_preconditioning=precondition, checkpoints=ckpt,
              transport_mode=transport, compose_mode=compose)
    with jax_mode("general" if transport is None else "auto"):
        refs = jmodels.lddmm_register(jnp.asarray(src), jnp.asarray(tgt), lm.FluidMetric(params),
                                      **kw)
    got = tmodels.lddmm_register(t(src), t(tgt), lt.FluidMetric(params), **kw)
    for name, r, g in zip(("m", "phiinv", "losses"), refs, got):
        close_rel(r, g, what=name)
    assert float(got[2][-1]) < float(got[2][0])
    assert float(got[1].abs().max()) > 0.1  # the deformation moved


def _flax_net(dim, imgs):
    net = jmodels.MomentumNet(dim=dim)
    params = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(imgs, dtype=jnp.float32))
    return net, jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), params)


@pytest.mark.parametrize("dim", [2, 3])
def test_momentum_net_matches_flax(dim):
    """The forward of the port's net with the flax net's parameters
    (``convert.momentum_net_state``), 3 channels in; the fresh net's
    weights have flax's variance, its biases are zero."""
    rng = np.random.default_rng(4)
    imgs = rng.standard_normal((2, 3) + SPATIAL[dim])
    jnet, params = _flax_net(dim, imgs)
    net = tmodels.MomentumNet(dim=dim, in_channels=3).double()
    state = convert.momentum_net_state(params)
    assert set(state) == set(net.state_dict())
    net.load_state_dict(state)
    close_rel(jax.jit(jnet.apply)(params, jnp.asarray(imgs)), net(t(imgs)), rtol=1e-12)
    fresh = tmodels.deep_atlas.init_momentum_net(tmodels.MomentumNet(dim=dim, features=32), 1)
    w = fresh.convs[1].weight.detach()
    assert abs(float(w.var()) * w[0].numel() - 1.0) < 0.05 and float(w.abs().max()) <= 2.0 / (
        0.87962566103423978 * w[0].numel() ** 0.5) + 1e-6
    assert all(not c.bias.detach().any() for c in fresh.convs)


def test_deep_lddmm_atlas_matches_jax():
    """2 epochs of the JAX model (its float32 parameters cast to float64
    and its optimiser state made anew, in this test) against the port's
    from the same parameters."""
    imgs = blobs(2, 6, 1.5, seed=6)
    kw = dict(metric=None, batch_size=3, integration_steps=2, reg_weight=1e-2,
              learning_rate_net=1e-3, learning_rate_image=10.0, dtype=np.float64,
              progress_bar=False)
    params = (0.01, 0.0, 0.1)
    with jax_mode("general"):
        ref = jmodels.DeepLDDMMAtlas(list(imgs), **{**kw, "metric": lm.FluidMetric(params)})
        ref.params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), ref.params)
        ref.opt_state = ref.tx.init(ref.params)
        init = convert.momentum_net_state(ref.params)
        ref.fit(num_epochs=2)
        ref_m = ref.predict_momenta(imgs[:2])
        ref_def = ref.deform_atlas(imgs[:2])
    got = tmodels.DeepLDDMMAtlas(list(imgs), **{**kw, "metric": lt.FluidMetric(params)},
                                 device="cpu")
    got.net.load_state_dict(init)
    got.fit(num_epochs=2)
    assert len(got.epoch_losses) == 2 and got.epoch_losses[-1] < got.epoch_losses[0]
    np.testing.assert_allclose(got.epoch_losses, ref.epoch_losses, rtol=RTOL, atol=0)
    close_rel(ref.I, got.I, what="atlas")
    trained = convert.momentum_net_state(ref.params)
    for k, p in got.net.state_dict().items():
        close_rel(trained[k].numpy(), p, what=k)
    close_rel(ref_m, got.predict_momenta(imgs[:2]), what="predict_momenta")
    close_rel(ref_def, got.deform_atlas(imgs[:2]), what="deform_atlas")
    from lagomorph_tpu_torch.parallel import get_mesh

    meshed = tmodels.DeepLDDMMAtlas(list(imgs), mesh=get_mesh(devices=["cpu"] * 2),
                                    progress_bar=False)
    assert meshed.device.type == "cpu" and meshed._pad_multiple == 2
