"""Datasets, minibatches, streaming averages and dataset files for the
atlas builders.

Port of the numpy parts of ``lagomorph_tpu/data.py`` that the builders and
their commands use: the dataset protocol, in-memory, HDF5 and indexed
datasets, ``batch_iterator``, the on-disk minibatch cache,
``batch_average``, and the HDF5 writer and loader (``write_dataset``,
``load_dataset``).  Datasets yield numpy arrays; the builders stage them on
their device.  ``h5py`` is imported only where a file is read or written,
``tqdm`` only for a progress bar.  Not ported (ROADMAP.md A.7): the Zarr,
cropping, mapping and cached datasets, the Zarr writer, the process
prefetcher and the ``data`` command.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from .utils import progress

__all__ = [
    "Dataset",
    "MemoryDataset",
    "H5Dataset",
    "IndexedDataset",
    "CachedDataLoader",
    "batch_iterator",
    "dataset_length",
    "batch_average",
    "load_dataset",
    "write_dataset",
    "write_dataset_h5",
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
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
        self._tmpdir = tempfile.TemporaryDirectory(
            dir=cache_dir, prefix="lagomorph_tpu_torch.CachedDataLoader."
        )
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
    (anything supporting ``arr[i, ...] = value``)."""
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


def _check_h5_path(path):
    """Raise unless ``path``'s extension names an HDF5 file (a Zarr path:
    not ported)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in _H5_EXTENSIONS:
        return
    if ext == ".zarr":
        raise NotImplementedError(
            f"{path}: Zarr datasets are not ported (ROADMAP.md A.7); use an HDF5 file")
    raise RuntimeError(f'Could not determine file type from extension "{ext}"')


def write_dataset(dataset, path, **kwargs):
    """Write ``dataset`` to ``path``, whose extension names the format
    (HDF5: ``.h5``, ``.hdf5``, ``.hdf``)."""
    _check_h5_path(path)
    return write_dataset_h5(dataset, path, **kwargs)


def load_dataset(path, **kwargs):
    """The dataset stored at ``path`` (an :class:`H5Dataset`; ``kwargs`` go
    to it)."""
    _check_h5_path(path)
    return H5Dataset(path, **kwargs)
