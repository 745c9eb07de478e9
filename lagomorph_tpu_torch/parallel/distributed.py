"""Multi-process data-parallel helpers.

Port of ``lagomorph_tpu/parallel/distributed.py`` to ``torch.distributed``
(the default process group; :class:`..utils.Tool` sets it up).  Torch's
idiom is one process per device, where a JAX process may own several local
devices; the deployments are the same:

* each process owns an interleaved shard of the dataset
  (:func:`process_shard_indices`, the DistributedSampler analogue);
* each process stages its own rows of a minibatch and never holds another
  process's (:func:`put_global` and :func:`local_shard` are the identity on
  them: the global batch exists only as the union of the processes' rows);
* the builders sum the losses and the atlas gradient over the processes
  with ``all_reduce``, where GSPMD inserts a psum in the JAX package.

Everything degrades to plain single-process behaviour when no process group
is initialised (``process_count() == 1``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..profiling import span
from ..utils import process_count, process_index
from .mesh import Sharded, Sharding


def process_shard_indices(n: int, world: int | None = None, rank: int | None = None):
    """This process's subject indices: interleaved ``rank, rank+world, ...``
    (same assignment rule as torch's DistributedSampler without padding)."""
    world = process_count() if world is None else world
    rank = process_index() if rank is None else rank
    return list(range(rank, n, world))


def shard_sizes(n: int, world: int) -> list:
    """Number of subjects owned by each process."""
    return [len(range(r, n, world)) for r in range(world)]


def put_global(local, sharding):
    """This process's rows of a global batch, staged for its step: on the
    process's own mesh (a :class:`.mesh.Sharding`: a :class:`.mesh.Sharded`
    over it) or on one device (a torch device).  The identity on the rows:
    no process holds another's, so nothing is assembled."""
    t = local if isinstance(local, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(local))
    if isinstance(sharding, Sharding):
        return sharding.put(t)
    return t.to(sharding)


def local_shard(garr) -> np.ndarray:
    """This process's rows of a batch-sharded value as a host array, in
    row order (the inverse of :func:`put_global`)."""
    if isinstance(garr, Sharded):
        return garr.numpy()
    if isinstance(garr, torch.Tensor):
        return garr.detach().cpu().numpy()
    return np.asarray(garr)


def allsum_hosts(x) -> np.ndarray:
    """Elementwise sum of a (small) host array across processes: one
    ``all_reduce`` of a CPU tensor (gloo) in the array's dtype.  float64
    stays float64, so the JAX package's hi/lo float32 split is not
    needed."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    import torch.distributed as dist

    t = torch.from_numpy(np.array(x, copy=True))
    dist.all_reduce(t)
    return t.numpy()


def allsum_(*tensors):
    """Sum each tensor in place over the processes (``all_reduce``, the span
    ``lt.allsum``); nothing without a process group.  Returns the
    tensors."""
    if process_count() > 1:
        import torch.distributed as dist

        with span("lt.allsum"):
            for t in tensors:
                dist.all_reduce(t)
    return tensors
