"""The device mesh and its shardings.

Port of ``lagomorph_tpu/parallel/mesh.py``.  One process drives a mesh of
devices, as JAX's single controller does: a :class:`Mesh` is an ordered
tuple of torch devices with one axis name (``"data"``), and a sharded value
is a :class:`Sharded`, one tensor per mesh entry (a list).  What GSPMD
does inside a jitted step is done here by the callers: a shard moves to
another entry's device with ``.to(device)`` and pieces are joined with
``torch.cat``, which autograd differentiates, so a sharded computation
needs no hand-written backward.

A mesh may name one device more than once: ``Mesh([cuda:0] * 4)`` runs a
4-shard computation on one card (each shard's work is issued in turn; a
``.to`` onto the same device is no copy).  Nothing here assumes distinct
devices.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_MESH = None


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A one-axis device mesh: ``devices`` in order (repeats allowed) and
    the name of its axis.  ``shape`` maps the axis name to the number of
    entries, as a JAX mesh's does."""

    def __init__(self, devices, axis_names=("data",)):
        self.devices = tuple(_device(d) for d in devices)
        self.axis_names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        if not self.devices or len(self.axis_names) != 1:
            raise ValueError("a mesh has one axis and at least one device")

    @property
    def shape(self):
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names[0]!r})"


class Sharded(list):
    """A sharded value: one tensor per mesh entry, each on its entry's
    device.  ``axis``: the array axis split over the mesh (the pieces in
    mesh order), None for a replicated value (equal copies)."""

    def __init__(self, shards, axis, mesh):
        super().__init__(shards)
        self.axis = axis
        self.mesh = mesh

    def like(self, shards):
        """``shards`` laid out as this value is."""
        return Sharded(shards, self.axis, self.mesh)

    @property
    def shape(self):
        shape = list(self[0].shape)
        if self.axis is not None:
            shape[self.axis] = sum(s.shape[self.axis] for s in self)
        return tuple(shape)

    def gather(self, device=None) -> torch.Tensor:
        """The whole value as one tensor on ``device`` (the first entry's
        device by default)."""
        device = self[0].device if device is None else device
        if self.axis is None:
            return self[0].to(device)
        return torch.cat([s.to(device) for s in self], dim=self.axis)

    def numpy(self) -> np.ndarray:
        return self.gather("cpu").detach().numpy()


@dataclass(frozen=True)
class Sharding:
    """How a value is laid out on a mesh: ``spec`` names, per array axis,
    the mesh axis it is split over (None: not split), as a JAX
    ``PartitionSpec``; an empty spec replicates."""

    mesh: Mesh
    spec: tuple = ()

    @property
    def axis(self):
        """The array axis split over the mesh, None when replicated."""
        return next((i for i, s in enumerate(self.spec) if s is not None), None)

    def put(self, x) -> Sharded:
        """``x`` (a tensor, or an array on the host) laid out on the mesh.  A
        split axis must divide evenly."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        devices = self.mesh.devices
        axis = self.axis
        if axis is None:
            return Sharded([t.to(d) for d in devices], None, self.mesh)
        if t.shape[axis] % len(devices):
            raise ValueError(
                f"axis {axis} of size {t.shape[axis]} does not split over {len(devices)} devices"
            )
        pieces = torch.tensor_split(t, len(devices), dim=axis)
        return Sharded([p.to(d).contiguous() for p, d in zip(pieces, devices)], axis, self.mesh)


def get_mesh(axis_name: str = "data", devices=None) -> Mesh:
    """Return (and cache) a 1D data-parallel mesh over every visible CUDA
    device (the CPU where there is none).

    Several processes: each process builds its own mesh over its own
    devices (one process per card is torch's idiom; the JAX package's mesh
    spans every process's devices)."""
    global _MESH
    if _MESH is not None and devices is None:
        return _MESH
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        mesh = Mesh([torch.device("cuda", i) for i in range(n)] or ["cpu"], (axis_name,))
        _MESH = mesh
        return mesh
    return Mesh(devices, (axis_name,))


def data_sharding(mesh: Mesh) -> Sharding:
    """Sharding that splits the leading (batch) axis over the mesh."""
    return Sharding(mesh, (mesh.axis_names[0],))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def spatial_sharding(mesh: Mesh, ndim: int, spatial_axis: int = 0) -> Sharding:
    """Sharding that splits one spatial axis of an NC+spatial array over the
    mesh.  ``ndim`` is the total array rank; ``spatial_axis`` indexes into
    the spatial dims (0 = first spatial axis, i.e. array axis 2)."""
    spec = [None] * ndim
    spec[2 + spatial_axis] = mesh.axis_names[0]
    return Sharding(mesh, tuple(spec))


def shard_batch(x, mesh: Mesh) -> Sharded:
    """``x`` with its leading axis split over the mesh."""
    return data_sharding(mesh).put(x)


def replicate(x, mesh: Mesh) -> Sharded:
    """A copy of ``x`` on every mesh entry."""
    return replicated_sharding(mesh).put(x)


def pad_batch_to_multiple(x: np.ndarray, multiple: int):
    """Pad the leading axis up to a multiple by repeating the last item
    (needed to shard uneven final minibatches).  Returns ``(padded,
    original_size)``."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0), n


def as_shards(x, mesh: Mesh, axis: int) -> list:
    """The shards of ``x`` split along ``axis`` over ``mesh``: ``x`` itself
    when it is :class:`Sharded`, else ``x`` split (differentiably)."""
    if isinstance(x, Sharded):
        if len(x) != mesh.size or x.axis != axis:
            raise ValueError(f"a value sharded {len(x)} ways on axis {x.axis}, "
                             f"not {mesh.size} ways on axis {axis}")
        return list(x)
    return list(Sharding(mesh, (None,) * axis + (mesh.axis_names[0],)).put(x))


def join_like(shards, x, axis: int):
    """``shards`` (split along ``axis``) returned as ``x`` came: a
    :class:`Sharded` for a sharded ``x``, else one tensor on ``x``'s
    device."""
    if isinstance(x, Sharded):
        return x.like(shards)
    return torch.cat([s.to(x.device) for s in shards], dim=axis)


def shardwise(fn, *xs):
    """``fn`` applied shard by shard when an argument is :class:`Sharded`
    (the others passed whole to every call), else ``fn(*xs)``."""
    like = next((x for x in xs if isinstance(x, Sharded)), None)
    if like is None:
        return fn(*xs)
    return like.like([fn(*(x[k] if isinstance(x, Sharded) else x for x in xs))
                      for k in range(len(like))])
