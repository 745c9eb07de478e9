"""The port's data tools against the JAX package's, on the CPU:

* every dataset wrapper, ``batch_iterator`` and ``batch_average``
  ``np.array_equal`` to the JAX package's on the same HDF5 file;
* the writers and loaders, each package reading the other's files;
* ``parse_slice_spec`` and the ``data`` verbs (``average``, ``downscale``,
  ``crop``, ``numexpr``, ``split``, ``splitcv``, with ``--copy_other_keys``
  and ``--stratify_key``), both packages' tools run in this process on
  the same file, writing equal files (the arrays, and the attributes but
  the one that names the package);
* the vetted numexpr fallback: the same values and the same rejections;
* the loaders: ``ProcessPrefetcher`` (the protocol, oversize batches and
  errors, the degrade at ``LM_PREFETCH_TIMEOUT=2``, the dead pool, the
  result salvaged from a pool that died after delivering it, the killed
  workers joined outside the lock), the native read-ahead cache (its round
  trip, and reads in a forked worker), and the builder with each loader
  equal to the thread loader and, in float64, to the JAX builder with the
  same loader.

zarr and numexpr do not import here: their cases skip, as the JAX
package's do.
"""
import contextlib
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import lagomorph_tpu as lm
from lagomorph_tpu import data as jdata
from lagomorph_tpu.__main__ import LagomorphTool as JaxTool
from lagomorph_tpu.ops import set_warp_mode
import lagomorph_tpu_torch as lt
from lagomorph_tpu_torch import data as tdata
from lagomorph_tpu_torch.__main__ import LagomorphTool
from lagomorph_tpu_torch.native import NativeBatchCache, native_available

h5py = pytest.importorskip("h5py")
torch.set_num_threads(2)

RTOL = 1e-9  # float64 builders, of max|ref| (tests/test_torch_atlas.py)
needs_gxx = pytest.mark.skipif(not native_available(), reason="no g++ to build the native cache")


@pytest.fixture
def h5file(tmp_path, rng):
    """tests/test_data.py's file: 6 images of 8 x 8 and their labels."""
    fn = str(tmp_path / "in.h5")
    imgs = rng.standard_normal((6, 1, 8, 8)).astype(np.float32)
    labels = (np.arange(6) % 2).astype(np.int64)
    with h5py.File(fn, "w") as f:
        f.create_dataset("images", data=imgs)
        f.create_dataset("labels", data=labels)
    return fn, imgs, labels


def both(make):
    """``make(package)`` for the JAX package's data module and the port's."""
    return make(jdata), make(tdata)


def assert_items_equal(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        if isinstance(x, tuple):
            assert isinstance(y, tuple) and len(x) == len(y)
            for u, v in zip(x, y):
                assert np.array_equal(np.asarray(u), np.asarray(v))
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype
            assert np.array_equal(x, y)


def test_h5dataset_matches_jax(h5file):
    fn, imgs, labels = h5file
    for kw in ({"key": "images"}, {"key": ("images", "labels")},
               {"key": "images", "force_dim": 4}, {"key": "images", "dtype": np.float64}):
        j, t = both(lambda d: d.H5Dataset(fn, **kw))
        assert_items_equal(j, t)
    assert np.array_equal(t[2], imgs[2].astype(np.float64))


WRAPPERS = {
    "indexed": lambda d, ds: d.IndexedDataset(ds),
    "subset": lambda d, ds: d.SubsetDataset(ds, [5, 0, 3]),
    "map": lambda d, ds: d.MapDataset(ds, lambda x: 2 * x),
    "memory": lambda d, ds: d.MemoryDataset(ds, progress_bar=False),
    "crop": lambda d, ds: d.CropDataset(ds, [(1, 7, None), (2, 6, None)]),
    "crop_step": lambda d, ds: d.CropDataset(ds, [(None, None, 2), (1, -1, 3)]),
    "numexpr": lambda d, ds: d.NumexprDataset(ds, "sqrt(abs(x))*3 + 1"),
    "downscaled": lambda d, ds: d.DownscaledDataset(ds, 2),
    "downscaled_by_3": lambda d, ds: d.DownscaledDataset(ds, 3),
    "downscaled_int": lambda d, ds: d.DownscaledDataset(d.MapDataset(ds, lambda x: (x * 10).astype(np.int16)), 2),
    "precached": lambda d, ds: d.PreCachedDataset(ds, cache_dir=None),
    "lazycached": lambda d, ds: d.LazyCachedDataset(ds),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_dataset_wrappers_match_jax(h5file, name):
    """Each wrapper of the same HDF5 dataset gives the JAX package's items,
    dtype and values, read twice (the caches' second read)."""
    fn, imgs, _ = h5file
    j, t = both(lambda d: WRAPPERS[name](d, d.H5Dataset(fn, key="images")))
    assert_items_equal(j, t)
    assert_items_equal(j, t)
    if name == "downscaled":
        assert t[0].shape == (1, 4, 4)
        assert np.allclose(t[0][0, 0, 0], imgs[0, 0, :2, :2].mean())


def test_batch_iterator_and_average_match_jax(h5file):
    fn, _, _ = h5file
    for make in (lambda d: d.H5Dataset(fn), lambda d: d.IndexedDataset(d.H5Dataset(fn))):
        j, t = both(lambda d: list(d.batch_iterator(make(d), 4, dtype=np.float64)))
        assert len(j) == len(t) == 2
        for a, b in zip(j, t):
            assert_items_equal(a, b) if isinstance(a, tuple) else np.testing.assert_array_equal(a, b)
        ja, ta = (d.batch_average(x, progress_bar=False) for d, x in ((jdata, j), (tdata, t)))
        np.testing.assert_array_equal(ja, ta)


def test_cached_dataloader_matches_jax(h5file, tmp_path):
    fn, _, _ = h5file
    j, t = both(lambda d: d.CachedDataLoader(d.batch_iterator(d.H5Dataset(fn), 4),
                                             cache_dir=str(tmp_path / "c"), progress_bar=False))
    assert_items_equal(j, t)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)


def read_h5(path):
    """Every dataset of an HDF5 file and its attributes but the package's
    version, the file's directory written ``{out}`` in ``command_args``:
    ``{key: (array, attrs)}``."""
    out = os.path.dirname(path)
    with h5py.File(path, "r") as f:
        return {k: (f[k][...], {a: v.replace(out, "{out}") if a == "command_args" else v
                                for a, v in f[k].attrs.items() if a != "lagomorph_version"})
                for k in f.keys()}


def assert_files_equal(a, b):
    fa, fb = read_h5(a), read_h5(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k][0].dtype == fb[k][0].dtype and np.array_equal(fa[k][0], fb[k][0]), k
        assert fa[k][1] == fb[k][1], k


@pytest.mark.parametrize("key", ["images", ("images", "labels")])
def test_writers_and_loaders_read_either_way(h5file, tmp_path, key):
    """A dataset written by either package's ``write_dataset`` loads in the
    other's ``load_dataset``, and both write the same file (chunks of one
    subject, lzf); an unknown extension raises in both."""
    fn, _, _ = h5file
    out = {}
    for name, d in (("jax", jdata), ("port", tdata)):
        out[name] = str(tmp_path / f"{name}.h5")
        d.write_dataset(d.H5Dataset(fn, key=key), out[name], key=key)
    assert_files_equal(out["jax"], out["port"])
    with h5py.File(out["port"], "r") as f:
        assert f["images"].chunks == (1, 1, 8, 8) and f["images"].compression == "lzf"
    assert_items_equal(jdata.load_dataset(out["port"], key=key),
                       tdata.load_dataset(out["jax"], key=key))
    for d in (jdata, tdata):
        with pytest.raises(RuntimeError, match="extension"):
            d.load_dataset(str(tmp_path / "x.npz"))
        with pytest.raises(RuntimeError, match="extension"):
            d.write_dataset(d.H5Dataset(fn), str(tmp_path / "x.npz"))


def test_zarr_files_match_jax(h5file, tmp_path):
    """``.zarr`` paths: each package reads the other's store."""
    pytest.importorskip("zarr")
    fn, _, _ = h5file
    out = {}
    for name, d in (("jax", jdata), ("port", tdata)):
        out[name] = str(tmp_path / f"{name}.zarr")
        d.write_dataset(d.H5Dataset(fn), out[name])
    assert_items_equal(jdata.load_dataset(out["port"]), tdata.load_dataset(out["jax"]))


def test_zarr_needs_zarr(h5file, tmp_path, monkeypatch):
    """Where zarr does not import, a ``.zarr`` path raises ImportError in
    both packages (not the port's former NotImplementedError)."""
    fn, _, _ = h5file
    monkeypatch.setitem(sys.modules, "zarr", None)
    for d in (jdata, tdata):
        with pytest.raises(ImportError):
            d.load_dataset(str(tmp_path / "in.zarr"))
        with pytest.raises(ImportError):
            d.write_dataset(d.H5Dataset(fn), str(tmp_path / "out.zarr"))


@pytest.mark.parametrize("spec", ["5:-5,0:127,::2", "3", ":,1:,::-1", "0:6,0:4", "2:10:3"])
def test_parse_slice_spec_matches_jax(spec):
    assert tdata.parse_slice_spec(spec) == jdata.parse_slice_spec(spec)


def run_both(monkeypatch, verb, args, outputs, tmp_path):
    """Run ``data <verb> <args>`` through each package's tool in this
    process, the outputs' names formatted with the package's; returns the
    paths of each package's outputs."""
    paths = {}
    for name, tool in (("jax", JaxTool), ("port", LagomorphTool)):
        d = tmp_path / name
        d.mkdir()
        argv = [a.format(out=str(d)) for a in args]
        monkeypatch.setattr(sys, "argv", [name, "data", verb, *argv])
        tool().run()
        paths[name] = [o.format(out=str(d)) for o in outputs]
    return paths


VERBS = {
    "average": ("average", ["{in}", "{out}/avg.h5", "--batch_size", "4"], ["{out}/avg.h5"]),
    "downscale": ("downscale", ["{in}", "{out}/ds.h5", "--scale", "2", "--copy_other_keys"],
                  ["{out}/ds.h5"]),
    "downscale_by_3": ("downscale", ["{in}", "{out}/ds.h5", "--scale", "3"], ["{out}/ds.h5"]),
    "crop": ("crop", ["{in}", "{out}/crop.h5", "--slices", "0:6,1:-1:2", "--copy_other_keys"],
             ["{out}/crop.h5"]),
    "numexpr": ("numexpr", ["{in}", "{out}/ne.h5", "-e", "where(x > 0, x, 0) * 2 + 1"],
                ["{out}/ne.h5"]),
    "split": ("split", ["{in}", "{out}/tr.h5", "{out}/te.h5", "--test_size", "0.5",
                        "--random_seed", "3"], ["{out}/tr.h5", "{out}/te.h5"]),
    "split_stratified": ("split", ["{in}", "{out}/tr.h5", "{out}/te.h5", "--test_size", "2",
                                   "--stratify_key", "labels", "--copy_other_keys"],
                         ["{out}/tr.h5", "{out}/te.h5"]),
    "splitcv": ("splitcv", ["{in}", "{out}/f{fold}_{split}.h5", "--num_folds", "3"],
                [f"{{out}}/f{k}_{s}.h5" for k in range(3) for s in ("train", "test")]),
    "splitcv_stratified": ("splitcv", ["{in}", "{out}/f{fold}_{split}.h5", "--stratify_key",
                                       "labels", "--h5keys", "images"],
                           [f"{{out}}/f{k}_{s}.h5" for k in range(2) for s in ("train", "test")]),
}


@pytest.mark.parametrize("case", list(VERBS))
def test_data_verbs_match_jax(h5file, tmp_path, monkeypatch, case):
    """``python -m lagomorph_tpu_torch data ...`` writes the files ``python
    -m lagomorph_tpu data ...`` writes: the same arrays, keys and
    provenance (``command_args``)."""
    if case == "numexpr":
        monkeypatch.setitem(sys.modules, "numexpr", None)  # the vetted fallback, both sides
    fn, imgs, labels = h5file
    verb, args, outputs = VERBS[case]
    args = [a.replace("{in}", fn) for a in args]
    if "{fold}" in args[1]:  # str.format of the output pattern happens in the verb
        args[1] = args[1].replace("{fold}", "{{fold}}").replace("{split}", "{{split}}")
    paths = run_both(monkeypatch, verb, args, outputs, tmp_path)
    for a, b in zip(paths["jax"], paths["port"]):
        assert_files_equal(a, b)
    if verb.startswith("split"):  # each (train, test) pair splits the 6 subjects
        sizes = [read_h5(p)["images"][0].shape[0] for p in paths["port"]]
        assert all(a + b == 6 and b > 0 for a, b in zip(sizes[::2], sizes[1::2])), sizes


def test_numexpr_fallback_is_vetted_as_jax(monkeypatch):
    """Without numexpr both packages evaluate through the same
    AST-whitelisted evaluator and reject the same expressions."""
    ds = [np.full((1, 4, 4), 2.0)]
    monkeypatch.setitem(sys.modules, "numexpr", None)
    for expr in ("sqrt(x)*3 + 1", "where(x > 1, x, 0)", "-x ** 2 // 3 % 2", "arctan2(x, 1.5)",
                 "maximum(x, 3) + log1p(x)"):
        j, t = both(lambda d: d.NumexprDataset(ds, expr)[0])
        np.testing.assert_array_equal(j, t)
    for bad in ("__import__('os').system('true')", "x.dtype", "x[0]", "(lambda: 1)()",
                "[i for i in (1,)]", "open('/etc/passwd')", "y + 1"):
        for d in (jdata, tdata):
            with pytest.raises(ValueError):
                d.NumexprDataset(ds, bad)[0]


def test_numexpr_library_when_present(h5file):
    pytest.importorskip("numexpr")
    fn, imgs, _ = h5file
    j, t = both(lambda d: d.NumexprDataset(d.H5Dataset(fn), "x/2"))
    assert_items_equal(j, t)


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------


def test_process_prefetcher_basics(h5file, tmp_path):
    """Worker processes deliver the bytes of direct reads, in any fetch
    order; an index never submitted is read directly; a batch is
    submitted again after its fetch (the next epoch)."""
    fn, _, _ = h5file
    batches = tdata.CachedDataLoader(tdata.batch_iterator(tdata.H5Dataset(fn), 2),
                                     cache_dir=str(tmp_path), progress_bar=False)
    pf = tdata.ProcessPrefetcher(batches, workers=2)
    try:
        pf.submit(0)
        pf.submit(2)
        assert np.array_equal(pf.get(2), batches[2])
        assert np.array_equal(pf.get(1), batches[1])  # never submitted
        assert np.array_equal(pf.get(0), batches[0])
        pf.submit(0)
        assert np.array_equal(pf.get(0), batches[0])
        assert not pf._failed
    finally:
        pf.close()
    pf.close()  # idempotent


class Weird:
    """Batch 0 (the slot's size) smaller than batch 2; batch 3 raises."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        if i == 3:
            raise ValueError("boom")
        return np.full((2 + 4 * i,), float(i), np.float32)


def test_process_prefetcher_oversize_and_errors():
    """A batch larger than the slot comes through the queue; a worker's
    exception re-raises in the parent; a ring full of unfetched batches
    raises instead of deadlocking."""
    pf = tdata.ProcessPrefetcher(Weird(), workers=1, depth=2)
    try:
        pf.submit(1)
        pf.submit(2)
        assert np.array_equal(pf.get(2), np.full((10,), 2.0, np.float32))
        assert np.array_equal(pf.get(1), np.full((6,), 1.0, np.float32))
        pf.submit(3)
        with pytest.raises(ValueError, match="boom"):
            pf.get(3)
        pf.submit(0)
        pf.submit(1)
        with pytest.raises(RuntimeError, match="ring full"):
            pf.submit(2)
        assert np.array_equal(pf.get(0), np.zeros(2, np.float32))
        assert np.array_equal(pf.get(1), np.full((6,), 1.0, np.float32))
    finally:
        pf.close()


_PARENT_PID = os.getpid()


class Stuck:
    """Items read in the parent; a worker never delivers."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        if os.getpid() != _PARENT_PID:
            import time

            time.sleep(3600)
        return np.full((4,), float(i), np.float32)


class FromWorker:
    """Items marked by where they were read: 100 + i in a worker, i in the
    parent."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.full((4,), float(i + (100 if os.getpid() != _PARENT_PID else 0)), np.float32)


def test_process_prefetcher_degrades_instead_of_hanging(monkeypatch):
    """A pool that never delivers degrades to direct reads after
    ``LM_PREFETCH_TIMEOUT``; a dead pool with nothing delivered degrades at
    the next liveness check; the killed workers are joined after the lock
    is released."""
    monkeypatch.setenv("LM_PREFETCH_TIMEOUT", "2")
    pf = tdata.ProcessPrefetcher(Stuck(), workers=1, depth=2)
    try:
        pf.submit(1)
        procs = list(pf._procs)
        held = []
        for p in procs:
            join = p.join
            p.join = lambda timeout=None, join=join: (held.append(pf._lock.locked()),
                                                      join(timeout))
        with pytest.warns(RuntimeWarning, match="degraded"):
            out = pf.get(1)
        assert np.array_equal(out, np.full((4,), 1.0, np.float32))
        assert pf._failed and not pf._procs and not pf._shm and not pf._killed
        assert held == [False] and not any(p.is_alive() for p in procs)
        pf.submit(2)  # a no-op once degraded
        assert np.array_equal(pf.get(2), np.full((4,), 2.0, np.float32))

        pf2 = tdata.ProcessPrefetcher(Stuck(), workers=1, depth=2)
        pf2.submit(1)
        for p in pf2._procs:
            p.kill()
            p.join()
        with pytest.warns(RuntimeWarning, match="degraded"):
            assert np.array_equal(pf2.get(1), np.full((4,), 1.0, np.float32))
        pf2.close()
    finally:
        pf.close()


class _LateQueue:
    """A result queue whose first blocking wait expires empty: the result
    lands just after the wait, as when a worker puts its last batch and
    exits between the parent's wait and its liveness check."""

    def __init__(self, q):
        self.q, self.waited = q, False

    def get(self, block=True, timeout=None):
        import queue

        if block and not self.waited:
            self.waited = True
            raise queue.Empty
        return self.q.get(block=block, timeout=timeout)


def test_process_prefetcher_salvages_last_result(monkeypatch):
    """A worker that exits right after delivering a batch: ``get`` returns
    the delivered batch (read by the worker), without degrading."""
    monkeypatch.setenv("LM_PREFETCH_TIMEOUT", "30")
    pf = tdata.ProcessPrefetcher(FromWorker(), workers=1, depth=2)
    try:
        pf.submit(1)
        pf._task_q.put(None)  # the worker exits after batch 1
        for p in pf._procs:
            p.join(timeout=30)
            assert not p.is_alive()
        pf._done_q = _LateQueue(pf._done_q)
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            out = pf.get(1)
        assert pf._done_q.waited and not pf._failed
        assert np.array_equal(out, np.full((4,), 101.0, np.float32))
    finally:
        pf._done_q = getattr(pf._done_q, "q", pf._done_q)
        pf.close()


@needs_gxx
def test_native_cache_roundtrip(rng, tmp_path):
    """tests/test_native.py's round trip: in order (read-ahead), at random
    and over two epochs, equal to the batches written."""
    batches = [rng.standard_normal((4, 1, 8, 8)).astype(np.float32) for _ in range(5)]
    cache = NativeBatchCache(batches, cache_dir=str(tmp_path))
    try:
        for a, b in zip(cache, batches):
            assert np.array_equal(a, b)
        assert np.array_equal(cache[3], batches[3]) and np.array_equal(cache[0], batches[0])
        for a, b in zip(cache, batches):
            assert np.array_equal(a, b)
        with pytest.raises(IndexError):
            cache[5]
    finally:
        cache.close()
    assert not os.listdir(tmp_path)


@needs_gxx
def test_native_cache_in_forked_workers(rng, tmp_path, monkeypatch):
    """A worker forked from the cache's process reads the files itself: one
    worker reading consecutive batches (each read in the library would
    wait on a read-ahead thread the fork did not copy) never degrades."""
    monkeypatch.setenv("LM_PREFETCH_TIMEOUT", "20")
    batches = [rng.standard_normal((2, 1, 6, 6)).astype(np.float32) for _ in range(4)]
    cache = NativeBatchCache(batches, cache_dir=str(tmp_path))
    list(cache)  # the read-ahead state a builder leaves after its first pass
    pf = tdata.ProcessPrefetcher(cache, workers=1)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            for epoch in range(2):
                for i in range(len(batches)):
                    pf.submit(i)
                    assert np.array_equal(pf.get(i), batches[i])
        assert not pf._failed
    finally:
        pf.close()
        cache.close()


def blob_images(n, res, dim, seed=3):
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(res, dtype=np.float64)] * dim, indexing="ij"))
    c = (res - 1) / 2.0
    return [np.exp(-sum((grid[d] - c - o[d]) ** 2 for d in range(dim)) / (2 * (res / 6) ** 2))[None]
            for o in rng.uniform(-1.5, 1.5, (n, dim))]


BUILDER = dict(num_epochs=2, batch_size=2, lddmm_integration_steps=3, reg_weight=1e-1,
               learning_rate_pose=1e-2, learning_rate_image=1e2, progress_bar=False)
LOADERS = {
    "process": {"loader_workers": 2, "loader_mode": "process"},
    "process_cache": {"loader_workers": 2, "loader_mode": "process", "dataloader_cache": "tmp"},
    "thread_cache": {"loader_workers": 2, "loader_mode": "thread", "dataloader_cache": "tmp"},
    "cache_without_gxx": {"dataloader_cache": "tmp"},
}


def state(b):
    return (b.I.detach().clone(), [torch.as_tensor(np.asarray(m)) for m in b.ms],
            list(b.iter_losses), list(b.epoch_losses))


@pytest.mark.parametrize("loader", list(LOADERS))
def test_builder_loaders_equal_thread_loader(loader, tmp_path, monkeypatch):
    """Each loader gives the thread loader's atlas, momenta and losses
    exactly (float32, 5 subjects: an uneven last batch), with no degrade;
    the cache is the native one where g++ is found and the ``.npy`` one
    where it is not; ``run`` closes the prefetcher."""
    opts = dict(LOADERS[loader])
    if opts.get("dataloader_cache") == "tmp":
        opts["dataloader_cache"] = str(tmp_path / "cache")
    if loader == "cache_without_gxx":
        monkeypatch.setattr(lt.native, "native_available", lambda: False)
    elif "dataloader_cache" in opts and not native_available():
        pytest.skip("no g++ to build the native cache")
    monkeypatch.setenv("LM_PREFETCH_TIMEOUT", "30")
    imgs = [x.astype(np.float32) for x in blob_images(5, 10, 2)]
    kw = dict(BUILDER, metric=lt.FluidMetric([0.01, 0.0, 0.1]), device="cpu")
    ref = lt.LDDMMAtlasBuilder(imgs, loader_workers=2, loader_mode="thread", **kw)
    ref.run()
    b = lt.LDDMMAtlasBuilder(imgs, **opts, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        b.run()
    got, want = state(b), state(ref)
    assert torch.equal(got[0], want[0]) and got[2:] == want[2:]
    assert all(torch.equal(x, y) for x, y in zip(got[1], want[1]))
    assert getattr(b, "_img_prefetch", None) is None
    if "dataloader_cache" in opts:
        kind = tdata.CachedDataLoader if loader == "cache_without_gxx" else NativeBatchCache
        assert type(b._batches) is kind


@contextlib.contextmanager
def general_tier():
    prev = set_warp_mode("general")
    try:
        yield
    finally:
        set_warp_mode(prev)


def test_builder_process_loader_matches_jax(tmp_path, monkeypatch):
    """The port's builder with ``loader_mode="process"`` and a
    ``dataloader_cache`` against the JAX builder with the same loader, in
    float64 (tests/test_torch_atlas.py's tolerance)."""
    monkeypatch.setenv("LM_PREFETCH_TIMEOUT", "30")
    imgs = blob_images(4, 10, 2)
    opts = dict(BUILDER, dtype=np.float64, loader_workers=2, loader_mode="process")
    with general_tier():
        ref = lm.LDDMMAtlasBuilder(imgs, metric=lm.FluidMetric([0.01, 0.0, 0.1]),
                                   dataloader_cache=str(tmp_path / "jax"), **opts)
        ref.run()
    b = lt.LDDMMAtlasBuilder(imgs, metric=lt.FluidMetric([0.01, 0.0, 0.1]), device="cpu",
                             dataloader_cache=str(tmp_path / "port"), **opts)
    b.run()
    assert b.I.dtype == torch.float64
    pairs = [(np.asarray(ref.I), b.I.numpy())]
    pairs += [(np.asarray(r), np.asarray(m)) for r, m in zip(ref.ms, b.ms)]
    pairs += [(np.asarray(getattr(ref, k)), np.asarray(getattr(b, k)))
              for k in ("epoch_losses", "iter_losses", "epoch_reg_terms", "iter_reg_terms")]
    for want, got in pairs:
        assert got.shape == want.shape and np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * float(np.abs(want).max()))
