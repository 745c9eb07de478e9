"""The port's 2D plots (``lagomorph_tpu_torch.vis``) against the JAX
package's (tests/test_vis.py), on torch tensors: the same segments, the
same arrows, the same refusals."""
import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from matplotlib import pyplot as plt  # noqa: E402

from lagomorph_tpu import vis as jvis  # noqa: E402
from lagomorph_tpu_torch import vis  # noqa: E402


def test_to_numpy_takes_tensors():
    a = torch.arange(6.0, dtype=torch.float64).reshape(2, 3).requires_grad_(True)
    n = vis.to_numpy(a * 2)
    assert isinstance(n, np.ndarray) and n.dtype == np.float64
    np.testing.assert_array_equal(n, 2 * np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(vis.to_numpy([[1, 2]]), jvis.to_numpy([[1, 2]]))
    x = np.ones(3)
    assert vis.to_numpy(x) is x


def test_to_numpy_rejects_garbage():
    class Bad:
        def __array__(self):
            raise RuntimeError("no")

    with pytest.raises(TypeError):
        vis.to_numpy(Bad())


def segments(mod, u, **kw):
    fig, ax = plt.subplots()
    try:
        mod.gridplot(u, ax=ax, **kw)
        (lc,) = ax.collections
        return [np.asarray(s) for s in lc.get_segments()], ax.yaxis_inverted()
    finally:
        plt.close(fig)


@pytest.mark.parametrize("kw", [{"Nx": 8, "Ny": 8}, {"Nx": 5, "Ny": 3},
                                {"Nx": None, "Ny": 4, "displacement": False}])
def test_gridplot_matches_jax(rng, kw):
    """The same field, as a tensor to the port and an array to JAX: equal
    segments (rows, then columns) on an inverted y-axis."""
    u = rng.standard_normal((1, 2, 16, 12)).astype(np.float32)
    got, inv = segments(vis, torch.from_numpy(u), **kw)
    want, jinv = segments(jvis, u, **kw)
    assert inv and jinv and len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_gridplot_zero_displacement_is_regular_grid():
    segs, _ = segments(vis, torch.zeros(1, 2, 32, 32), Nx=8, Ny=8)
    assert len(segs) == 16
    assert np.allclose(segs[0][:, 1], 0.0)


def test_gridplot_offsets_lines():
    u = torch.zeros(1, 2, 16, 16)
    u[0, 0] = 2.0
    segs, _ = segments(vis, u, Nx=4, Ny=4)
    assert np.allclose(segs[0][:, 1], 2.0)


def test_gridplot_rejects_batched_or_3d():
    with pytest.raises(ValueError):
        vis.gridplot(torch.zeros(2, 2, 8, 8))
    with pytest.raises(ValueError):
        vis.gridplot(torch.zeros(1, 3, 8, 8, 8))


def test_quiver_matches_jax(rng):
    u = rng.standard_normal((1, 2, 16, 16)).astype(np.float32)
    out = []
    for mod, field in ((vis, torch.from_numpy(u)), (jvis, u)):
        fig, ax = plt.subplots()
        mod.quiver(field, Nx=4, Ny=4, ax=ax)
        (q,) = ax.collections
        out.append((np.asarray(q.get_offsets()), np.asarray(q.U), np.asarray(q.V)))
        plt.close(fig)
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
