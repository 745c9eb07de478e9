"""Datasets, minibatches, caches, streaming averages, dataset files and the
``data`` command.

Port of ``lagomorph_tpu/data.py``: the dataset protocol and its wrappers
(in-memory, Zarr, HDF5, indexed, subset, map, crop, numexpr, downscaled and
the two on-disk item caches), ``batch_iterator``, the on-disk minibatch
cache, the process prefetcher that the builders' ``loader_mode="process"``
reads through, ``batch_average``, the HDF5 and Zarr writers and loader,
``parse_slice_spec`` and the ``data`` command (``average``, ``downscale``,
``crop``, ``numexpr``, ``split``, ``splitcv``).  Datasets yield numpy
arrays; the builders stage them on their device, and the ``data`` verbs
touch no device.  ``h5py``, ``zarr``, ``numexpr`` and ``sklearn`` are
imported only where they are used, ``tqdm`` only for a progress bar.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from .utils import Tool, progress

__all__ = [
    "Dataset",
    "MemoryDataset",
    "ZarrDataset",
    "H5Dataset",
    "IndexedDataset",
    "SubsetDataset",
    "MapDataset",
    "CropDataset",
    "NumexprDataset",
    "DownscaledDataset",
    "PreCachedDataset",
    "LazyCachedDataset",
    "CachedDataLoader",
    "ProcessPrefetcher",
    "batch_iterator",
    "dataset_length",
    "batch_average",
    "write_dataset_h5",
    "write_dataset_zarr",
    "write_dataset",
    "load_dataset",
]

_H5_EXTENSIONS = (".h5", ".hdf5", ".hdf")


class Dataset:
    """Minimal dataset protocol: ``__len__`` and ``__getitem__``."""

    def __len__(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx):  # pragma: no cover - abstract
        raise NotImplementedError


def dataset_length(dataset):
    return len(dataset)


class MemoryDataset(Dataset):
    """Every element of ``dataset`` loaded into host memory."""

    def __init__(self, dataset, progress_bar=True):
        rng = range(len(dataset))
        if progress_bar:
            rng = progress(rng, "pre-loading data")
        self.elements = [dataset[i] for i in rng]

    def __len__(self):
        return len(self.elements)

    def __getitem__(self, idx):
        return self.elements[idx]


class ZarrDataset(Dataset):
    """The array ``key`` of a Zarr store whose first dimension indexes
    subjects."""

    def __init__(self, path, key="images", force_dim=None):
        try:
            import zarr
        except ImportError:
            print("Please install the zarr library to use ZarrDataset.")
            raise
        self.path = path
        self.key = key
        self.ds = zarr.open(path)[key]

    def __len__(self):
        return self.ds.shape[0]

    def __getitem__(self, idx):
        return np.asarray(self.ds[idx, ...])


class H5Dataset(Dataset):
    """An HDF5 file whose first dimension indexes subjects.  ``key`` may be
    a tuple of dataset names, and an item is then a tuple of arrays;
    ``force_dim`` prepends singleton axes to the first key's items until
    they have ``1 + force_dim`` dimensions."""

    def __init__(self, h5path, key="images", dtype=None, force_dim=None):
        import h5py

        self.h5path = h5path
        if not isinstance(key, (tuple, list)):
            key = (key,)
        self.key = tuple(key)
        if not isinstance(dtype, (tuple, list)):
            dtype = tuple(dtype for _ in self.key)
        self.dtype = tuple(dtype)
        self.force_dim = force_dim
        with h5py.File(self.h5path, "r") as f:
            length = None
            for k in self.key:
                if length is None:
                    length = f[k].shape[0]
                elif f[k].shape[0] != length:
                    raise Exception(f"Mismatched lengths of datasets with keys {key}")
            self._len = length

    def __len__(self):
        return self._len

    def __getitem__(self, idx):
        import h5py

        Is = []
        # the file is opened per item, which keeps worker processes safe
        for i, (k, dt) in enumerate(zip(self.key, self.dtype)):
            with h5py.File(self.h5path, "r") as f:
                I = np.asarray(f[k][idx, ...])
            if i == 0:
                if dt is not None:
                    I = I.astype(dt)
                if self.force_dim is not None:
                    if I.ndim > self.force_dim + 1:
                        raise Exception(
                            f"Cannot force dimension to {self.force_dim} from {I.ndim}"
                        )
                    while I.ndim < self.force_dim + 1:
                        I = I[None]
            Is.append(I)
        return Is[0] if len(Is) == 1 else tuple(Is)


class IndexedDataset(Dataset):
    """``(index, element)`` pairs of ``dataset``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return idx, self.dataset[idx]


class SubsetDataset(Dataset):
    """The elements of ``dataset`` at ``indices``, in that order."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(np.asarray(indices).reshape(-1))

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]


class MapDataset(Dataset):
    """``fun`` of each element of ``dataset``."""

    def __init__(self, dataset, fun):
        self.dataset = dataset
        self.fun = fun

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return self.fun(self.dataset[idx])


class CropDataset(Dataset):
    """Every item cropped by per-axis ``(start, stop, step)`` slices;
    missing leading axes are taken whole."""

    def __init__(self, dataset, slices):
        self.dataset = dataset
        ndim = np.ndim(self.dataset[0])
        slices = list(slices)
        if len(slices) < ndim:
            slices = [(None, None, None)] * (ndim - len(slices)) + slices
        self.slices = tuple(slice(*s) for s in slices)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return np.ascontiguousarray(self.dataset[idx][self.slices])


_NUMEXPR_SAFE_FUNCS = {
    name: getattr(np, name)
    for name in (
        "sqrt exp expm1 log log1p log10 sin cos tan arcsin arccos arctan "
        "arctan2 sinh cosh tanh abs absolute minimum maximum where"
    ).split()
}


def _safe_numexpr_eval(expression: str, x: np.ndarray):
    """Evaluate a numexpr-style arithmetic expression of ``x`` without
    numexpr, through an AST whitelist: arithmetic and comparison operators,
    numeric constants, the name ``x`` and a fixed set of numpy ufuncs.
    Anything else (attribute access, subscripts, other calls,
    comprehensions, lambdas, ...) raises ValueError: expressions come from
    the command line, so this is deliberately not a bare ``eval``."""
    import ast

    tree = ast.parse(expression, mode="eval")
    allowed = (
        ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant, ast.Name,
        ast.Call, ast.Compare, ast.Load,
        ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.Pow, ast.FloorDiv,
        ast.USub, ast.UAdd,
        ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq, ast.NotEq,
    )
    for node in ast.walk(tree):
        if not isinstance(node, allowed):
            raise ValueError(
                f"unsupported syntax in numexpr expression: {type(node).__name__}"
            )
        if isinstance(node, ast.Constant) and not isinstance(
            node.value, (int, float, complex, bool)
        ):
            raise ValueError("only numeric constants are allowed")
        if isinstance(node, ast.Call):
            if (
                not isinstance(node.func, ast.Name)
                or node.func.id not in _NUMEXPR_SAFE_FUNCS
                or node.keywords
            ):
                raise ValueError("only whitelisted numpy calls are allowed")
        if (
            isinstance(node, ast.Name)
            and node.id != "x"
            and node.id not in _NUMEXPR_SAFE_FUNCS
        ):
            raise ValueError(f"unknown name in numexpr expression: {node.id!r}")
    return eval(  # noqa: S307 - AST-whitelisted above, no builtins
        compile(tree, "<numexpr>", "eval"),
        {"__builtins__": {}},
        {**_NUMEXPR_SAFE_FUNCS, "x": x},
    )


class NumexprDataset(Dataset):
    """A numexpr expression in ``x`` applied to each element: through
    numexpr where it imports, otherwise through the vetted AST-whitelisted
    numpy evaluator (:func:`_safe_numexpr_eval`), never a bare ``eval``."""

    def __init__(self, dataset, expression):
        self.dataset = dataset
        self.expression = expression

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        x = np.asarray(self.dataset[idx])
        try:
            import numexpr
        except ImportError:
            return _safe_numexpr_eval(self.expression, x)
        return numexpr.evaluate(self.expression, local_dict={"x": x})


class DownscaledDataset(Dataset):
    """Each item average-pooled by the integer ``scale`` over its spatial
    axes (all but the first, the channel axis): cropped to multiples of
    ``scale``, then a reshape and a mean, on the host.  Items that are not
    float32 or float64 are cast to float32 first."""

    def __init__(self, dataset, scale):
        self.dataset = dataset
        self.scale = int(scale)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        J = np.asarray(self.dataset[idx])
        if J.dtype not in (np.float32, np.float64):
            J = J.astype(np.float32)
        s = self.scale
        J = J[(slice(None),) + tuple(slice(0, (n // s) * s) for n in J.shape[1:])]
        newshape = [J.shape[0]]
        pool_axes = []
        for n in J.shape[1:]:
            newshape.extend([n // s, s])
            pool_axes.append(len(newshape) - 1)
        return J.reshape(newshape).mean(axis=tuple(pool_axes))


def _cache_tmpdir(cache_dir, kind):
    """A temporary directory under ``cache_dir`` (made if missing) for a
    cache of class name ``kind``."""
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=cache_dir, prefix=f"lagomorph_tpu_torch.{kind}.")


class PreCachedDataset(Dataset):
    """The items of ``dataset`` at ``sampler`` (every index by default),
    each saved to a ``.npy`` file of a temporary directory when the object
    is made, then read from there."""

    def __init__(self, dataset, sampler=None, cache_dir=None):
        self.dataset = dataset
        if sampler is None:
            sampler = range(len(dataset))
        self.sampler = sampler
        self._tmpdir = _cache_tmpdir(cache_dir, "PreCachedDataset")
        self.tmpdir = self._tmpdir.name
        for j in sampler:
            np.save(self.filename(j), np.asarray(dataset[j]))

    def filename(self, j):
        return os.path.join(self.tmpdir, f"{j}.npy")

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, j):
        fn = self.filename(j)
        if not os.path.isfile(fn):
            raise ValueError(f"Index {j} was not cached by PreCachedDataset")
        return np.load(fn)


class LazyCachedDataset(Dataset):
    """The items of ``dataset``, each saved to a ``.npy`` file of a
    temporary directory at its first read and read from there after."""

    def __init__(self, dataset, cache_dir=None):
        self.dataset = dataset
        self._tmpdir = _cache_tmpdir(cache_dir, "LazyCachedDataset")
        self.tmpdir = self._tmpdir.name

    def filename(self, j):
        return os.path.join(self.tmpdir, f"{j}.npy")

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, j):
        fn = self.filename(j)
        if os.path.isfile(fn):
            return np.load(fn)
        di = np.asarray(self.dataset[j])
        np.save(fn, di)
        return di


def batch_iterator(dataset, batch_size, dtype=None, indices=None):
    """Yield stacked numpy minibatches of ``dataset`` (over ``indices``, all
    by default), cast to ``dtype`` when given.  Items that are ``(index,
    array)`` pairs (:class:`IndexedDataset`) yield ``(indices, batch)``."""
    order = list(range(len(dataset)) if indices is None else indices)
    for start in range(0, len(order), batch_size):
        items = [dataset[i] for i in order[start:start + batch_size]]
        if (items and isinstance(items[0], tuple) and len(items[0]) == 2
                and np.isscalar(items[0][0])):
            ix = np.asarray([it[0] for it in items])
            arr = np.stack([np.asarray(it[1]) for it in items])
            yield ix, (arr if dtype is None else arr.astype(dtype))
        else:
            arr = np.stack([np.asarray(it) for it in items])
            yield arr if dtype is None else arr.astype(dtype)


class CachedDataLoader:
    """Pass once through a batch iterator, caching each minibatch in a
    ``.npy`` file of a temporary directory (under ``cache_dir``), then
    replay them from disk, in order or by index."""

    def __init__(self, batches, cache_dir=None, progress_bar=True):
        self._tmpdir = _cache_tmpdir(cache_dir, "CachedDataLoader")
        self.tmpdir = self._tmpdir.name
        self.filenames = []
        if progress_bar:
            batches = progress(batches, desc="Caching minibatches")
        for j, b in enumerate(batches):
            fn = os.path.join(self.tmpdir, f"{j}.npy")
            np.save(fn, np.asarray(b))
            self.filenames.append(fn)

    def __len__(self):
        return len(self.filenames)

    def __iter__(self):
        for f in self.filenames:
            yield np.load(f)

    def __getitem__(self, i):
        return np.load(self.filenames[i])


class ProcessPrefetcher:
    """Batches read by forked worker processes: the workers take batch
    indices off a task queue, materialise ``loader[i]`` (the disk read and
    decode, the half of staging that holds the interpreter lock) and
    publish the bytes through a ring of shared-memory slots.  The parent
    keeps the device and does only the copy to it.

    ``loader`` must be random-access (``len()``, ``[i] -> np.ndarray``) and
    inheritable by a fork: a list of host arrays, :class:`CachedDataLoader`,
    ``native.NativeBatchCache`` or a dataset-backed loader holding no device
    tensor.  Workers are forked at the first :meth:`submit` and run numpy
    only: they touch neither CUDA nor torch, whose state in the parent
    (CUDA context, library threads, thread pools) they must not use.

    Protocol: ``submit(i)`` queues batch ``i`` into a free slot (blocking
    for a slot once ``depth`` submissions are in flight); ``get(i)`` blocks
    until its bytes land and returns a copy the parent owns (the slot is
    recycled at once).  ``get`` of an index never submitted reads it
    directly in this process.  A result larger than the slot (sized on
    batch 0) or a worker's exception comes back through the result queue
    instead (pickled; the exception re-raised by ``get``).

    Watchdog: a fork of a process with running threads can leave a child
    holding a lock another thread held at the fork, and the child then
    wedges.  ``get`` therefore waits at most ``LM_PREFETCH_TIMEOUT`` seconds
    (default 120) for a batch in flight.  On expiry, or when every worker
    has died with no result left in the queue, the prefetcher degrades:
    it kills its workers by their PIDs, releases the shared memory and
    reads this and every later batch directly, with a ``RuntimeWarning``.
    The killed workers are joined after the lock is released, so no caller
    waits on a join."""

    def __init__(self, loader, workers=2, depth=None):
        import multiprocessing as mp
        import threading

        try:
            self._ctx = mp.get_context("fork")
        except ValueError as e:  # pragma: no cover - non-POSIX
            raise RuntimeError("ProcessPrefetcher requires the fork start method") from e
        self.loader = loader
        self.workers = max(1, int(workers))
        self.depth = int(depth) if depth else self.workers + 1
        # submit() and get() may run on different threads (the epoch loop and
        # the staging pool): one lock serialises the ring and queue state
        self._lock = threading.Lock()
        self._started = False
        self._failed = False
        self._timeout = float(os.environ.get("LM_PREFETCH_TIMEOUT", "120"))
        self._pending = {}  # batch index -> slot
        self._ready = {}  # batch index -> (slot, shape, dtype, payload or None)
        self._free = []
        self._procs = []
        self._shm = []
        self._killed = []  # workers killed by a degrade, joined outside the lock

    @staticmethod
    def _worker(loader, task_q, done_q, shm_names, slot_bytes):
        from multiprocessing import shared_memory

        segs = [shared_memory.SharedMemory(name=n) for n in shm_names]
        try:
            while True:
                msg = task_q.get()
                if msg is None:
                    return
                i, slot = msg
                try:
                    arr = np.ascontiguousarray(np.asarray(loader[i]))
                    if arr.nbytes <= slot_bytes:
                        view = np.ndarray(arr.shape, arr.dtype, buffer=segs[slot].buf)
                        view[...] = arr
                        done_q.put((i, slot, arr.shape, arr.dtype.str, None))
                    else:  # larger than the slot: through the queue
                        done_q.put((i, slot, None, None, arr))
                except Exception as e:  # re-raised by the parent's get()
                    done_q.put((i, slot, None, None, e))
        finally:
            for s in segs:
                s.close()

    def _start(self):
        from multiprocessing import shared_memory

        probe = np.ascontiguousarray(np.asarray(self.loader[0]))
        self._slot_bytes = max(probe.nbytes, 1)
        self._task_q = self._ctx.Queue()
        self._done_q = self._ctx.Queue()
        for k in range(self.depth):
            self._shm.append(shared_memory.SharedMemory(create=True, size=self._slot_bytes))
            self._free.append(k)
        names = [s.name for s in self._shm]
        for _ in range(self.workers):
            p = self._ctx.Process(
                target=self._worker,
                args=(self.loader, self._task_q, self._done_q, names, self._slot_bytes),
                daemon=True,
            )
            p.start()
            self._procs.append(p)
        self._started = True

    def _drain_one(self, block=True):
        """Move one worker result into ``_ready`` (called with ``_lock``
        held).  A blocking wait polls in chunks of 1 s, up to ``_timeout``,
        checking the workers' liveness each chunk; when they have all died,
        one last non-blocking read takes a result that landed just before.
        A timeout (a wedged fork) or a dead pool with nothing left degrades
        the prefetcher instead of hanging.  Returns False when nothing was
        moved."""
        import queue
        import time

        deadline = time.monotonic() + self._timeout
        while True:
            try:
                i, slot, shape, dt, extra = self._done_q.get(
                    block=block, timeout=min(1.0, self._timeout) if block else None)
                break
            except queue.Empty:
                if not block:
                    return False
                if not any(p.is_alive() for p in self._procs):
                    try:  # a worker's last result, put just before it exited
                        i, slot, shape, dt, extra = self._done_q.get(block=False)
                        break
                    except queue.Empty:
                        self._degrade("workers died")
                        return False
                if time.monotonic() >= deadline:
                    self._degrade(f"no result within {self._timeout:.0f}s (wedged fork?)")
                    return False
        self._ready[i] = (slot, shape, dt, extra)
        self._pending.pop(i, None)
        return True

    def _degrade(self, why):
        """Kill the workers and read this and every later batch directly
        (called with ``_lock`` held; the kills are joined by
        :meth:`_join_killed`, outside it)."""
        import warnings

        warnings.warn(f"ProcessPrefetcher degraded to direct reads: {why}",
                      RuntimeWarning, stacklevel=4)
        self._failed = True
        for p in self._procs:
            if p.is_alive():
                p.kill()  # the child's own PID, never a pattern
        self._killed.extend(self._procs)
        self._release()

    def _release(self):
        for s in self._shm:
            try:
                s.close()
                s.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass
        self._procs, self._shm, self._free = [], [], []
        self._pending.clear()
        self._ready.clear()
        self._started = False

    def _join_killed(self):
        """Join the workers a degrade killed (outside ``_lock``)."""
        with self._lock:
            killed, self._killed = self._killed, []
        for p in killed:
            p.join(timeout=5)

    def submit(self, i):
        """Queue batch ``i`` for the workers (a no-op for an index in
        flight or landed, or once degraded).  Blocks only while every slot
        is in use."""
        i = int(i)
        with self._lock:
            if self._failed or i in self._pending or i in self._ready:
                return
            if not self._started:
                self._start()
            while not self._free:
                if not self._pending:
                    # every slot holds a landed batch nobody fetched: a
                    # blocking drain would wait forever
                    raise RuntimeError(
                        "ProcessPrefetcher ring full of unfetched batches: "
                        "call get() before submitting more (or raise depth)")
                if not self._drain_one(block=True):
                    break  # degraded while waiting for a slot
            else:
                slot = self._free.pop()
                self._pending[i] = slot
                self._task_q.put((i, slot))
        self._join_killed()

    def get(self, i):
        """Batch ``i`` as an array the caller owns, waiting for the workers
        when it is in flight; an index never submitted is read directly."""
        i = int(i)
        out = extra = None
        with self._lock:
            direct = i not in self._pending and i not in self._ready
            while not direct and i not in self._ready:
                direct = not self._drain_one(block=True)  # degraded: it never lands
            if not direct:
                slot, shape, dt, extra = self._ready.pop(i)
                if extra is None:  # copied out of the slot, which is then free
                    out = np.array(np.ndarray(shape, np.dtype(dt), buffer=self._shm[slot].buf))
                self._free.append(slot)
        self._join_killed()
        if direct:
            return np.asarray(self.loader[i])
        if isinstance(extra, Exception):
            raise extra
        return out if extra is None else np.asarray(extra)

    def close(self):
        """Stop the workers and release the shared memory (idempotent;
        :meth:`submit` forks new workers after it)."""
        self._join_killed()
        if not self._started:
            return
        for _ in self._procs:
            self._task_q.put(None)
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():  # pragma: no cover - a stuck worker
                p.terminate()
                p.join(timeout=5)
        self._release()

    def __del__(self):  # pragma: no cover - best-effort clean-up
        try:
            self.close()
        except Exception:
            pass


def batch_average(batches, dim=0, progress_bar=True):
    """Streaming average of minibatches along ``dim``, accumulated in
    float64 and returned in the batches' dtype when that is float32 or
    float64.  ``batches``: numpy arrays or ``(indices, array)`` pairs."""
    avg = None
    dtype = None
    sumsizes = 0
    if progress_bar:
        batches = progress(batches, "image avg")
    for img in batches:
        if isinstance(img, tuple):
            _, img = img
        img = np.asarray(img)
        sz = img.shape[dim]
        if dtype is None:
            dtype = img.dtype
        avi = img.astype(np.float64).sum(axis=dim)
        if avg is None:
            avg = avi / sz
        else:
            avg = avg * (sumsizes / (sumsizes + sz)) + avi / (sumsizes + sz)
        sumsizes += sz
    if dtype in (np.float32, np.float64):
        avg = avg.astype(dtype)
    return avg


def _item_parts(item):
    """One dataset item as a tuple of numpy arrays (a single array becomes
    a 1-tuple)."""
    parts = item if isinstance(item, (list, tuple)) else (item,)
    return tuple(np.asarray(p) for p in parts)


def _sizing_plan(dataset, key):
    """``key`` as a tuple and the per-key prototypes (shape, dtype) of the
    dataset's first item, checked against the number of keys."""
    keys = tuple(key) if isinstance(key, (list, tuple)) else (key,)
    protos = _item_parts(dataset[0])
    if len(protos) != len(keys):
        raise Exception(
            f"Dataset returns tuple with {len(protos)} entries, "
            f"but only {len(keys)} keys given"
        )
    return keys, protos


def _fill_arrays(dataset, arrays, desc):
    """Stream every item of ``dataset`` into pre-allocated per-key arrays
    (h5py or zarr: anything supporting ``arr[i, ...] = value``)."""
    for i in progress(range(len(dataset)), desc):
        for sink, part in zip(arrays, _item_parts(dataset[i])):
            sink[i, ...] = part


def write_dataset_h5(dataset, h5path, key="images"):
    """Write ``dataset`` to an HDF5 file in the JAX package's layout: one
    dataset a key, chunks of one subject, ``lzf`` compression.  ``key``
    may be a tuple for datasets whose items are tuples."""
    import h5py

    keys, protos = _sizing_plan(dataset, key)
    with h5py.File(h5path, "w") as f:
        arrays = [
            f.create_dataset(k, shape=(len(dataset), *p.shape), dtype=p.dtype,
                             chunks=(1, *p.shape), compression="lzf")
            for k, p in zip(keys, protos)
        ]
        _fill_arrays(dataset, arrays, desc=f"writing {os.path.basename(h5path)}")


def write_dataset_zarr(dataset, path, key="images"):
    """Write ``dataset`` to a Zarr directory store in the JAX package's
    layout: one array a key, chunks of one subject."""
    try:
        import zarr
    except ImportError:
        print("Please install the zarr library to use write_dataset_zarr.")
        raise
    root = zarr.group(store=zarr.DirectoryStore(path), overwrite=True)
    keys, protos = _sizing_plan(dataset, key)
    arrays = [
        root.zeros("/" + k, shape=(len(dataset), *p.shape), chunks=(1, *p.shape),
                   dtype=p.dtype)
        for k, p in zip(keys, protos)
    ]
    _fill_arrays(dataset, arrays, desc=f"writing {os.path.basename(path)}")


def _file_kind(path):
    """``"h5"`` or ``"zarr"``, from ``path``'s extension."""
    ext = os.path.splitext(path)[1]
    if ext.lower() in _H5_EXTENSIONS:
        return "h5"
    if ext.lower() == ".zarr":
        return "zarr"
    raise RuntimeError(f'Could not determine file type from extension "{ext}"')


def write_dataset(dataset, path, **kwargs):
    """Write ``dataset`` to ``path``, whose extension names the format
    (HDF5: ``.h5``, ``.hdf5``, ``.hdf``; Zarr: ``.zarr``)."""
    if _file_kind(path) == "h5":
        return write_dataset_h5(dataset, path, **kwargs)
    return write_dataset_zarr(dataset, path, **kwargs)


def load_dataset(path, **kwargs):
    """The dataset stored at ``path`` (an :class:`H5Dataset` or a
    :class:`ZarrDataset`, by extension; ``kwargs`` go to it)."""
    if _file_kind(path) == "h5":
        return H5Dataset(path, **kwargs)
    return ZarrDataset(path, **kwargs)


def parse_slice_spec(spec: str):
    """A comma- and colon-separated slice string such as ``"5:-5,0:127,::2"``
    as a list of ``(start, stop, step)`` triples (an empty field is None; a
    lone number is a stop)."""
    triples = []
    for field in spec.split(","):
        bounds = [int(b) if b else None for b in field.split(":")]
        if len(bounds) == 1:
            bounds = [None, bounds[0]]
        bounds += [None] * (3 - len(bounds))
        triples.append(tuple(bounds[:3]))
    return triples


# The verbs' shared flags: (flag, argparse keywords).  Names, defaults and
# meaning are the JAX package's ``data`` command's.
_FLAG = {
    "h5key": ("--h5key", dict(default="images",
                              help="HDF5 dataset name to read (and write)")),
    "key": ("--key", dict(default="images",
                          help="dataset name to read (and write)")),
    "h5keys": ("--h5keys", dict(
        default="images,labels",
        help="comma-separated dataset names carried through the split")),
    "copy_other_keys": ("--copy_other_keys", dict(
        action="store_true",
        help="also copy every other key of the input file, unchanged")),
    "random_seed": ("--random_seed", dict(
        default=0, type=int, help="seed for the pseudo-random split")),
    "stratify_key": ("--stratify_key", dict(
        default=None, help="Key to use for stratification labels")),
}


class _Tool(Tool):
    """Generic dataset utilities not specific to one class of registration methods"""

    module_name = "lagomorph_tpu_torch data"
    subcommands = ["average", "crop", "downscale", "numexpr", "split", "splitcv"]

    def _verb_args(self, verb, positionals, flags):
        """Parse ``sys.argv[2:]`` with a parser of ``positionals`` and
        ``flags`` (names of :data:`_FLAG` or ``(names, keywords)`` pairs)."""
        import sys

        parser = self.new_parser(verb)
        for name, kw in positionals:
            parser.add_argument(name, **kw)
        for f in flags:
            names, kw = _FLAG[f] if isinstance(f, str) else f
            parser.add_argument(*((names,) if isinstance(names, str) else names), **kw)
        return parser.parse_args(sys.argv[2:])

    @staticmethod
    def copy_other_keys(infile, outfile, key):
        import h5py

        keep = (key,) if isinstance(key, str) else tuple(key)
        with h5py.File(infile, "r") as fi, h5py.File(outfile, "a") as fo:
            for k in progress(fi.keys(), desc="other keys"):
                if k not in keep:
                    fi.copy(k, fo)

    def _emit(self, transformed, out_path, key, args, zarr_ok=False):
        """Write a dataset, stamp the provenance on its first key and copy
        the input's other keys with ``--copy_other_keys``."""
        import h5py

        if zarr_ok:
            write_dataset(transformed, out_path, key=key)
        else:
            write_dataset_h5(transformed, out_path, key=key)
        first = key if isinstance(key, str) else key[0]
        with h5py.File(out_path, "a") as f:
            self._stamp_dataset(f[first], args)
        if getattr(args, "copy_other_keys", False):
            self.copy_other_keys(args.input, out_path, key)

    @staticmethod
    def _grouping_labels(path, label_key):
        """The stratification labels at ``label_key`` (a trailing singleton
        axis dropped), or None."""
        import h5py

        if label_key is None:
            return None
        with h5py.File(path, "r") as f:
            labels = np.array(f[label_key])
        if labels.ndim == 2 and labels.shape[1] == 1:
            labels = labels[:, 0]
        elif labels.ndim > 2:
            raise Exception(f"Dimension of dataset {label_key} cannot be more than two")
        return labels

    _IN_OUT = (
        ("input", dict(type=str, help="Path to input image HDF5 file")),
        ("output", dict(type=str, help="Path to output HDF5 file")),
    )

    def average(self):
        """Average a dataset inside an HDF5 file in the first dimension"""
        import h5py

        args = self._verb_args(
            "average",
            self._IN_OUT,
            [
                ("--h5key", dict(default="images", help="HDF5 dataset name to average over")),
                ("--output_h5key", dict(default="average_image",
                                        help="dataset name for the mean image in the output")),
                ("--batch_size", dict(default=50, type=int,
                                      help="subjects per streaming batch")),
            ],
        )
        batches = batch_iterator(H5Dataset(args.input, key=args.h5key), args.batch_size)
        mean_img = batch_average(batches)
        with h5py.File(args.output, "w") as f:
            self._stamp_dataset(f.create_dataset(args.output_h5key, data=mean_img[None]), args)

    def downscale(self):
        """Downscale an image dataset using average pooling"""
        args = self._verb_args(
            "downscale",
            self._IN_OUT,
            ["key",
             ("--scale", dict(default=2, type=int, help="width of the average-pooling window")),
             "copy_other_keys"],
        )
        src = load_dataset(args.input, key=args.key)
        self._emit(DownscaledDataset(src, scale=args.scale), args.output, args.key, args,
                   zarr_ok=True)

    def crop(self):
        """Crop all the images in an image dataset"""
        args = self._verb_args(
            "crop",
            self._IN_OUT,
            ["h5key",
             ("--slices", dict(required=True,
                               help='per-axis pixel ranges, comma- and colon-separated '
                                    '(e.g. "5:-5,0:127,0:256")')),
             "copy_other_keys"],
        )
        src = H5Dataset(args.input, key=args.h5key)
        self._emit(CropDataset(src, slices=parse_slice_spec(args.slices)), args.output,
                   args.h5key, args)

    def numexpr(self):
        """Apply a numeric expression to an image dataset using numexpr"""
        args = self._verb_args(
            "numexpr",
            self._IN_OUT,
            ["h5key",
             (("--expression", "-e"), dict(required=True,
                                           help='expression in the variable x (e.g. "x/255")')),
             "copy_other_keys"],
        )
        src = H5Dataset(args.input, key=args.h5key)
        self._emit(NumexprDataset(src, expression=args.expression), args.output, args.h5key,
                   args)

    def split(self):
        """Split a dataset into training and testing (or validation)"""
        args = self._verb_args(
            "split",
            (
                ("input", dict(type=str, help="Path to input image HDF5 file")),
                ("train_output", dict(type=str, help="Path to output HDF5 file (training)")),
                ("test_output", dict(type=str, help="Path to output HDF5 file (testing)")),
            ),
            ["h5keys", "copy_other_keys", "random_seed",
             ("--test_size", dict(default=0.25,
                                  help="fraction of subjects if <= 1, else a subject count")),
             "stratify_key"],
        )
        keys = args.h5keys.split(",")
        dataset = H5Dataset(args.input, key=keys)
        labels = self._grouping_labels(args.input, args.stratify_key)
        test_size = float(args.test_size)
        if test_size > 1:  # a subject count, not a fraction
            test_size = int(test_size)

        from sklearn.model_selection import train_test_split

        train_ix, test_ix = train_test_split(range(len(dataset)), test_size=test_size,
                                             random_state=args.random_seed, stratify=labels)
        self._emit(SubsetDataset(dataset, train_ix), args.train_output, keys, args)
        self._emit(SubsetDataset(dataset, test_ix), args.test_output, keys, args)

    def splitcv(self):
        """Split a dataset into training and testing sets for cross-validation"""
        args = self._verb_args(
            "splitcv",
            (
                ("input", dict(type=str, help="Path to input image HDF5 file")),
                ("output_format", dict(type=str,
                                       help="Path to output HDF5 file "
                                            "(use placeholders {fold} and {split})")),
            ),
            ["h5keys", "copy_other_keys", "random_seed",
             ("--num_folds", dict(default=2, type=int, help="number of cross-validation folds")),
             "stratify_key"],
        )
        keys = args.h5keys.split(",")
        dataset = H5Dataset(args.input, key=keys)
        labels = self._grouping_labels(args.input, args.stratify_key)

        from sklearn.model_selection import KFold, StratifiedKFold

        cv_cls = KFold if labels is None else StratifiedKFold
        cv = cv_cls(n_splits=args.num_folds, shuffle=True, random_state=args.random_seed)
        folds = cv.split(np.arange(len(dataset)), *(() if labels is None else (labels,)))
        for fold, (train_ix, test_ix) in enumerate(folds):
            for name, indices in (("train", train_ix), ("test", test_ix)):
                out = args.output_format.format(fold=fold, split=name)
                self._emit(SubsetDataset(dataset, indices), out, keys, args)
