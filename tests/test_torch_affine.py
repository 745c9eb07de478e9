"""The port's affine stack against the JAX package's, on the CPU in float64
(inputs from a numpy seed through both):

* ``affine_interp``: values and the gradients in the image, the matrices
  and the translations (``jax.vjp`` against autograd), within
  1e-12 * (1 + max|ref|), in 2D and 3D, a broadcast and a batch-N image,
  one and two channels; the identity no-op and 2D matching 3D;
* the helpers: the closed-form inverses, ``affine_inverse`` (and its round
  trip), ``rotation_exp_map`` in 2D and 3D with its gradient at ``v = 0``
  and at random ``v`` (``jax.grad``), ``rigid_inverse``;
* ``make_affine_atlas_step``: one and two SGD steps, ridge weights 0 and >
  0, a mask with a zero: ``A``, ``T``, the atlas gradient and the loss
  within 1e-10 relative;
* ``affine_atlas`` over 2 epochs (atlas, transforms updated in place,
  losses within 1e-10), ``StandardizedDataset``, the HDF5 writers and
  loader (each package reads the other's files; Zarr paths fail as the JAX
  package's do where zarr does not import);
* no quiet fallback: the entry points raise for a CUDA device without one.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from lagomorph_tpu import affine as jaffine
from lagomorph_tpu import data as jdata
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import affine as taffine
from lagomorph_tpu_torch import data as tdata

torch.set_num_threads(2)

TOL = 1e-12  # affine_interp and the helpers: of 1 + max|ref|
STEP_TOL = 1e-10  # the step and the atlas: relative to max|ref|


def close(got, ref, tol=TOL, offset=1.0):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * (offset + np.abs(ref).max()))


def t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def transforms(rng, n, dim, spread=0.1, shift=1.5):
    return (np.eye(dim) + spread * rng.standard_normal((n, dim, dim)),
            shift * rng.standard_normal((n, dim)))


SPATIAL = {2: (7, 9), 3: (5, 6, 7)}


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("broadcast", [True, False])
@pytest.mark.parametrize("dim", [2, 3])
def test_affine_interp_matches_jax(rng, dim, broadcast, C):
    """Values and all three gradients; the shifts carry some coordinates
    past the edges (the clamped corners)."""
    N = 3
    I = rng.standard_normal((1 if broadcast else N, C) + SPATIAL[dim])
    A, T = transforms(rng, N, dim)
    g = rng.standard_normal((N, C) + SPATIAL[dim])
    out, vjp = jax.vjp(jaffine.affine_interp, jnp.asarray(I), jnp.asarray(A), jnp.asarray(T))
    refs = vjp(jnp.asarray(g))
    tI, tA, tT = t(I, True), t(A, True), t(T, True)
    got = lt.affine_interp(tI, tA, tT)
    close(got, out)
    for ref, leaf in zip(refs, torch.autograd.grad(got, (tI, tA, tT), t(g))):
        close(leaf, ref)


def test_affine_interp_casts_to_the_image_dtype(rng):
    """float64 transforms on a float32 image give a float32 result, as in
    the JAX package; mismatched batches and ranks raise."""
    I = rng.standard_normal((1, 1, 6, 5)).astype(np.float32)
    A, T = transforms(rng, 2, 2)
    out = lt.affine_interp(t(I), t(A), t(T))
    assert out.dtype == torch.float32
    ref = jaffine.affine_interp(jnp.asarray(I), jnp.asarray(A), jnp.asarray(T))
    assert ref.dtype == jnp.float32
    close(out, ref, tol=1e-6)
    with pytest.raises(ValueError):
        lt.affine_interp(t(I), t(A), t(T[:1]))
    with pytest.raises(ValueError):
        lt.affine_interp(t(I[..., None]), t(A), t(T))


@pytest.mark.parametrize("bs", [1, 2])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("nc", [1, 2])
def test_affine_interp_identity(rng, bs, dim, nc):
    """The identity transform is an exact no-op."""
    I = rng.standard_normal((bs, nc) + (2,) * dim)
    A = np.broadcast_to(np.eye(dim), (bs, dim, dim))
    out = lt.affine_interp(t(I), t(A), torch.zeros(bs, dim, dtype=torch.float64))
    assert torch.equal(out, t(I))


@pytest.mark.parametrize("bs", [1, 2])
@pytest.mark.parametrize("nc", [1, 2])
def test_affine_interp_2d_matches_3d(rng, bs, nc):
    """A 2D transform equals its embedding in a flat 3D volume."""
    I2 = rng.standard_normal((bs, nc, 4, 5))
    A2, T2 = transforms(rng, bs, 2, shift=0.3)
    A3 = np.zeros((bs, 3, 3))
    A3[:, :2, :2] = A2
    A3[:, 2, 2] = 1.0
    T3 = np.concatenate([T2, np.zeros((bs, 1))], axis=1)
    out2 = lt.affine_interp(t(I2), t(A2), t(T2))
    out3 = lt.affine_interp(t(I2[..., None]), t(A3), t(T3))
    close(out3, out2[..., None].numpy())


@pytest.mark.parametrize("dim", [2, 3])
def test_inverses_match_jax(rng, dim):
    """The closed-form inverse and ``affine_inverse`` against the JAX
    package's, and the round trip of random points."""
    A, T = transforms(rng, 4, dim)
    inv = {2: (jaffine.invert_2x2, taffine.invert_2x2), 3: (jaffine.invert_3x3, taffine.invert_3x3)}
    close(inv[dim][1](t(A)), inv[dim][0](jnp.asarray(A)))
    Ainv, Tinv = taffine.affine_inverse(t(A), t(T))
    for got, ref in zip((Ainv, Tinv), jaffine.affine_inverse(jnp.asarray(A), jnp.asarray(T))):
        close(got, ref)
    x = rng.standard_normal((4, dim))
    y = np.einsum("nab,nb->na", A, x) + T
    close(np.einsum("nab,nb->na", Ainv.numpy(), y) + Tinv.numpy(), x)
    close(taffine.det_2x2(t(A[:, :2, :2])), jaffine.det_2x2(jnp.asarray(A[:, :2, :2])))


@pytest.mark.parametrize("where", ["zero", "random"])
@pytest.mark.parametrize("dim", [2, 3])
def test_rotation_exp_map_and_gradient_match_jax(rng, dim, where):
    """``rotation_exp_map`` and the gradient of ``sum(R * W)`` in ``v``
    against ``jax.grad``, at ``v = 0`` (exact and finite: the series branch
    of the 3D map) and at random ``v``; rotations are orthogonal."""
    shape = (3,) if dim == 2 else (3, 3)
    v = np.zeros(shape) if where == "zero" else rng.standard_normal(shape)
    W = rng.standard_normal((3, dim, dim))

    def jf(v_):
        return jnp.sum(jaffine.rotation_exp_map(v_) * W)

    tv = t(v, True)
    R = taffine.rotation_exp_map(tv)
    close(R, jaffine.rotation_exp_map(jnp.asarray(v)))
    close(R @ R.transpose(1, 2), np.broadcast_to(np.eye(dim), (3, dim, dim)))
    (gv,) = torch.autograd.grad(torch.sum(R * t(W)), tv)
    ref = np.asarray(jax.grad(jf)(jnp.asarray(v)))
    assert np.isfinite(ref).all() and torch.isfinite(gv).all()
    close(gv, ref)
    if where == "zero":
        assert np.abs(ref).max() > 0  # not the zero gradient of a constant branch
    with pytest.raises(ValueError):
        taffine.rotation_exp_map(torch.zeros(2, 4))


@pytest.mark.parametrize("dim", [2, 3])
def test_rigid_inverse_matches_jax(rng, dim):
    v = rng.standard_normal((3,) if dim == 2 else (3, 3))
    T = rng.standard_normal((3, dim))
    negv, Tinv = taffine.rigid_inverse(t(v), t(T))
    ref = jaffine.rigid_inverse(jnp.asarray(v), jnp.asarray(T))
    close(negv, ref[0])
    close(Tinv, ref[1])
    R = taffine.rotation_exp_map(t(v))
    close(torch.einsum("nab,nb->na", R, Tinv) + t(T), np.zeros((3, dim)))


STEP_CASES = [  # (dim, affine_steps, reg_weightA, reg_weightT, masked)
    (2, 1, 0.0, 0.0, False),
    (2, 2, 0.3, 0.2, True),
    (2, 1, 0.3, 0.0, True),
    (3, 2, 0.0, 0.2, False),
]


@pytest.mark.parametrize("dim,steps,wA,wT,masked", STEP_CASES)
def test_affine_atlas_step_matches_jax(rng, dim, steps, wA, wT, masked):
    """``A``, ``T``, the atlas gradient (of the last step) and the loss."""
    N, sp = 4, SPATIAL[dim]
    I = rng.standard_normal((1, 1) + sp)
    img = rng.standard_normal((N, 1) + sp)
    A, T = transforms(rng, N, dim, spread=0.05)
    A -= np.eye(dim)  # the step's A is the offset from the identity
    mask = np.array([1.0, 1.0, 0.0, 1.0]) if masked else None
    kw = dict(affine_steps=steps, reg_weightA=wA, reg_weightT=wT, learning_rate_A=0.05,
              learning_rate_T=0.5)
    ref = jaffine.make_affine_atlas_step(dim, **kw)(
        jnp.asarray(I), jnp.asarray(A), jnp.asarray(T), jnp.asarray(img),
        None if mask is None else jnp.asarray(mask))
    got = taffine.make_affine_atlas_step(dim, **kw)(
        t(I), t(A), t(T), t(img), None if mask is None else t(mask))
    for g, r in zip(got, ref):
        close(g, r, tol=STEP_TOL, offset=0.0)
    assert not np.allclose(got[0].numpy(), A)  # the transforms moved


ATLAS_CASES = [  # (dim, image_update_freq, keep_data_on_device, reg weights)
    (2, 0, False, 0.0),
    (2, 1, True, 0.1),
    (2, 0, True, 0.1),
    (2, 1, False, 0.0),
    (3, 0, False, 0.1),
]


def blob_subjects(rng, n, res, dim):
    """Anisotropic blobs through random near-identity affine maps, as
    ``examples/affine_atlas.py`` draws them."""
    grid = np.stack(np.meshgrid(*[np.arange(res, dtype=float)] * dim, indexing="ij"))
    c = (res - 1) / 2
    widths = (res / 5, res / 7, res / 6)[:dim]
    imgs = []
    for _ in range(n):
        A = np.eye(dim) + 0.05 * rng.standard_normal((dim, dim))
        x = np.einsum("ab,b...->a...", A, grid - c) + (rng.uniform(-2, 2, dim) + c).reshape(
            (dim,) + (1,) * dim)
        imgs.append(np.exp(-sum(((x[d] - c) / widths[d]) ** 2 for d in range(dim)) / 2))
    return np.stack(imgs)[:, None]


@pytest.mark.parametrize("dim,freq,on_device,reg", ATLAS_CASES)
def test_affine_atlas_matches_jax(rng, dim, freq, on_device, reg):
    """Two epochs over 6 subjects in minibatches of 4 (an uneven last
    batch): the atlas, the transforms (the port's updated in place) and
    both loss lists."""
    imgs = list(blob_subjects(rng, 6, 12 if dim == 2 else 8, dim))
    kw = dict(num_epochs=2, batch_size=4, image_update_freq=freq, reg_weightA=reg,
              reg_weightT=reg, learning_rate_A=1e-2, learning_rate_T=1.0,
              learning_rate_I=10.0, keep_data_on_device=on_device, progress_bar=False)
    zeros = (np.zeros((6, dim, dim)), np.zeros((6, dim)))
    ref = jaffine.affine_atlas(imgs, zeros[0].copy(), zeros[1].copy(), **kw)
    As, Ts = zeros[0].copy(), zeros[1].copy()
    got = taffine.affine_atlas(imgs, As, Ts, device="cpu", **kw)
    assert got[1] is As and got[2] is Ts
    assert got[0].shape == (1, 1) + (imgs[0].shape[1:])
    for g, r in zip(got[:3], ref[:3]):
        close(g, r, tol=STEP_TOL, offset=0.0)
    for g, r in zip(got[3:], ref[3:]):
        assert len(g) == len(r) == (2 if g is got[3] else 4)
        close(np.asarray(g), r, tol=STEP_TOL, offset=0.0)
    assert np.abs(Ts).max() > 0 and got[3][-1] < got[3][0]


def test_affine_atlas_indexed_dataset_and_initial_atlas(rng):
    """``(index, image)`` items and a given initial atlas (a tensor here,
    an array in the JAX package) give the JAX package's result."""
    imgs = blob_subjects(rng, 5, 10, 2)
    I0 = imgs.mean(axis=0)[0] + 0.01
    kw = dict(num_epochs=1, batch_size=2, learning_rate_T=1.0, progress_bar=False)
    ref = jaffine.affine_atlas(jdata.IndexedDataset(list(imgs)), np.zeros((5, 2, 2)),
                               np.zeros((5, 2)), I=I0, **kw)
    got = taffine.affine_atlas(tdata.IndexedDataset(list(imgs)), np.zeros((5, 2, 2)),
                               np.zeros((5, 2)), I=t(I0), device="cpu", **kw)
    for g, r in zip(got[:3], ref[:3]):
        close(g, r, tol=STEP_TOL, offset=0.0)


def test_standardized_dataset_matches_jax(rng):
    """Float64 items stay float64, integer items become float32; each item
    mapped through the inverse of its transform."""
    imgs = blob_subjects(rng, 3, 9, 2)
    As, Ts = transforms(rng, 3, 2, spread=0.05)
    As -= np.eye(2)
    for items, dtype, tol in ((list(imgs), np.float64, TOL),
                              (list((imgs * 200).astype(np.uint8)), np.float32, 1e-6)):
        ref = jaffine.StandardizedDataset(items, As, Ts)
        got = taffine.StandardizedDataset(items, As, Ts, device="cpu")
        assert len(got) == 3
        for i in range(3):
            assert got[i].dtype == dtype
            close(got[i], ref[i], tol=tol)


def test_writers_and_loader_read_either_way(rng, tmp_path):
    """A file written by either package's ``write_dataset_h5`` reads in the
    other's ``H5Dataset`` (one key and a tuple of keys), in the same
    layout (chunks of one subject, lzf); Zarr (without zarr) and unknown extensions
    raise."""
    h5py = pytest.importorskip("h5py")
    imgs = rng.standard_normal((3, 1, 5, 4)).astype(np.float32)
    labels = rng.integers(0, 9, (3, 2))
    pairs = list(zip(imgs, labels))
    for name, write in (("port", tdata.write_dataset), ("jax", jdata.write_dataset)):
        write(list(imgs), str(tmp_path / f"{name}.h5"))
        write(pairs, str(tmp_path / f"{name}_pairs.h5"), key=("images", "labels"))
    for name, load in (("port", jdata.load_dataset), ("jax", tdata.load_dataset)):
        ds = load(str(tmp_path / f"{name}.h5"))
        assert len(ds) == 3
        for i in range(3):
            np.testing.assert_array_equal(ds[i], imgs[i])
        ds = load(str(tmp_path / f"{name}_pairs.h5"), key=("images", "labels"))
        for i in range(3):
            np.testing.assert_array_equal(ds[i][1], labels[i])
    with h5py.File(tmp_path / "port.h5", "r") as a, h5py.File(tmp_path / "jax.h5", "r") as b:
        for k in ("chunks", "compression", "dtype", "shape"):
            assert getattr(a["images"], k) == getattr(b["images"], k)
        assert a["images"].chunks == (1, 1, 5, 4) and a["images"].compression == "lzf"
    # Zarr paths are ported: without zarr they raise ImportError, as the
    # JAX package's do (tests/test_torch_data.py reads them either way)
    try:
        import zarr  # noqa: F401
    except ImportError:
        for d in (tdata, jdata):
            with pytest.raises(ImportError):
                d.write_dataset(list(imgs), str(tmp_path / "x.zarr"))
            with pytest.raises(ImportError):
                d.load_dataset(str(tmp_path / "x.zarr"))
    with pytest.raises(RuntimeError):
        tdata.load_dataset(str(tmp_path / "x.npy"))
    with pytest.raises(Exception, match="keys given"):
        tdata.write_dataset(pairs, str(tmp_path / "bad.h5"))


def test_entry_points_refuse_what_is_not_there(rng):
    """A CUDA device without one raises (no fallback to the CPU); as in the
    JAX package, ``world_size`` and ``rank`` are accepted and change
    nothing, and a mesh of two entries gives the run without one."""
    imgs = list(blob_subjects(rng, 2, 6, 2))
    zeros = (np.zeros((2, 2, 2)), np.zeros((2, 2)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            taffine.affine_atlas(imgs, *zeros, num_epochs=1, progress_bar=False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            taffine.affine_atlas(imgs, *zeros, num_epochs=1, progress_bar=False, device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            taffine.StandardizedDataset(imgs, *zeros)
    from lagomorph_tpu_torch.parallel import get_mesh

    def run(**kw):
        return taffine.affine_atlas(imgs, np.zeros((2, 2, 2)), np.zeros((2, 2)), num_epochs=1,
                                    batch_size=2, progress_bar=False, **kw)

    ref = run(device="cpu")
    for kw in (dict(mesh=get_mesh(devices=["cpu"] * 2)), dict(world_size=2, rank=1, device="cpu")):
        got = run(**kw)
        np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=0,
                                   atol=1e-12 * float(ref[0].abs().max()))
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-15)
