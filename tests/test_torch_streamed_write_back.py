"""A streamed atlas builder (``keep_data_on_device=False``) writes each
minibatch's updated momenta back into its own host array in place: the
arrays it was given stay as they were, its arrays keep their identity over
epochs (no new host array a minibatch), and their values are the resident
builder's."""
import numpy as np
import pytest
import torch

import lagomorph_tpu_torch as lt

torch.set_num_threads(2)


def _inputs(shape, n, batch, seed=0):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                                indexing="ij"))
    centre = (np.asarray(shape, dtype=np.float64) - 1) / 2
    imgs = []
    for _ in range(n):
        c = centre + rng.uniform(-1, 1, len(shape))
        r2 = sum((grid[a] - c[a]) ** 2 for a in range(len(shape)))
        imgs.append(np.exp(-r2 / (2 * (shape[0] / 6) ** 2))[None].astype(np.float32))
    metric = lt.FluidMetric((0.1, 0.05, 0.01))
    ms = []
    for i in range(0, n, batch):
        m = rng.standard_normal((min(batch, n - i), len(shape)) + shape)
        v = metric.sharp(torch.from_numpy(m))
        ms.append((m * (0.5 / float(v.norm(dim=1).max()))).astype(np.float32))
    return imgs, ms, metric


def _builder(imgs, ms, metric, batch, **kw):
    b = lt.LDDMMAtlasBuilder(imgs, I0=np.mean(imgs, axis=0), ms=ms, num_epochs=1,
                             batch_size=batch, learning_rate_pose=1e-3,
                             learning_rate_image=100.0, reg_weight=0.1, metric=metric,
                             device="cpu", progress_bar=False, **kw)
    b.initialize()
    return b


@pytest.mark.parametrize("workers", [0, 1])
def test_streamed_momenta_written_back_in_place(workers):
    imgs, ms, metric = _inputs((16, 12), 7, 3)
    given = [m.copy() for m in ms]
    streamed = _builder(imgs, ms, metric, 3, keep_data_on_device=False, loader_workers=workers)
    own = list(streamed.ms)
    assert not any(np.shares_memory(a, b) for a, b in zip(own, ms))
    resident = _builder(imgs, [m.copy() for m in given], metric, 3, keep_data_on_device=True)
    for _ in range(2):
        streamed.epoch()
        resident.epoch()
    assert all(a is b for a, b in zip(streamed.ms, own))
    assert all(np.array_equal(a, b) for a, b in zip(ms, given))
    for a, b in zip(streamed.ms, resident.ms):
        np.testing.assert_array_equal(a, b.detach().cpu().numpy())
    assert not any(np.array_equal(a, g) for a, g in zip(streamed.ms, given))
