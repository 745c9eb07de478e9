"""The streamed atlas builder on a CUDA card (skipped without one): its
loader threads stage each next minibatch while the step runs, it writes the
updated momenta back into its own host arrays in place, and its epochs give
the resident builder's bits.

This file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda_streamed.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

import lagomorph_tpu_torch as lt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the copies to and from it and the kernels are the card's")
    return torch.device("cuda", 0)


def _subjects(shape, n, batch, seed):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                                indexing="ij"))
    centre = (np.asarray(shape, dtype=np.float64) - 1) / 2
    imgs = []
    for _ in range(n):
        c = centre + rng.uniform(-2, 2, len(shape))
        r2 = sum((grid[a] - c[a]) ** 2 for a in range(len(shape)))
        imgs.append(np.exp(-r2 / (2 * (shape[0] / 6) ** 2))[None].astype(np.float32))
    metric = lt.FluidMetric((0.1, 0.0, 0.01))
    ms = []
    for i in range(0, n, batch):
        m = rng.standard_normal((min(batch, n - i), len(shape)) + shape)
        v = metric.sharp(torch.from_numpy(m))
        ms.append((m * (0.5 / float(v.norm(dim=1).max()))).astype(np.float32))
    return imgs, ms, metric


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [1, 2])
def test_streamed_builder_writes_back_and_matches_resident(cuda, workers):
    imgs, ms, metric = _subjects((32, 32, 32), 10, 4, seed=workers)
    kw = dict(I0=np.mean(imgs, axis=0), num_epochs=1, batch_size=4, learning_rate_pose=1e-3,
              learning_rate_image=100.0, reg_weight=0.1, metric=metric, device=cuda,
              progress_bar=False)
    streamed = lt.LDDMMAtlasBuilder(imgs, ms=[m.copy() for m in ms], keep_data_on_device=False,
                                    loader_workers=workers, **kw)
    resident = lt.LDDMMAtlasBuilder(imgs, ms=[m.copy() for m in ms], keep_data_on_device=True,
                                    **kw)
    streamed.initialize()
    resident.initialize()
    own = list(streamed.ms)
    for _ in range(3):
        assert streamed.epoch() == resident.epoch()
    assert all(a is b for a, b in zip(streamed.ms, own))
    for a, b in zip(streamed.ms, resident.ms):
        assert torch.equal(torch.from_numpy(a), b.cpu())
    assert torch.equal(streamed.I, resident.I)
    streamed.close_loaders()
