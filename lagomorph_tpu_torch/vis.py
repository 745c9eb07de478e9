"""2D visualisation (matplotlib): deformed grids and quiver plots.

Port of ``lagomorph_tpu/vis.py``: :func:`gridplot` draws the image of a
regular grid under a deformation as one ``LineCollection``, :func:`quiver`
an arrow a subsampled voxel; both take an explicit ``ax``.  Fields are
NC(D)HW tensors or arrays (:func:`to_numpy` detaches a tensor and copies it
to the host); axis 0 of the field is plotted vertically with the y-axis
inverted (image convention) and axis 1 horizontally.  matplotlib is
imported by the plotting functions only.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_numpy", "gridplot", "quiver"]


def to_numpy(arr):
    """``arr`` as a host ``numpy.ndarray``: a torch tensor (on any device;
    detached, copied to the host), a numpy array, a nested list or anything
    exposing ``__array__``."""
    if isinstance(arr, np.ndarray):
        return arr
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    try:
        return np.asarray(arr)
    except Exception as e:
        raise TypeError(f"Cannot convert type {type(arr)} to numpy.ndarray") from e


def _deformed_coords(u, Nx, Ny, displacement):
    """Subsample a (1, 2, X, Y) field to roughly (Nx, Ny) line crossings and
    return the absolute positions (r, c) of each crossing, where r runs along
    tensor axis 0 and c along axis 1.

    With ``displacement`` the field holds offsets and the subsampled voxel
    coordinates are added; otherwise the field is already an absolute
    coordinate map.
    """
    u = to_numpy(u)
    if u.ndim != 4 or u.shape[0] != 1 or u.shape[1] != 2:
        raise ValueError(
            f"expected a single 2D field of shape (1, 2, X, Y), got {u.shape}"
        )
    X, Y = u.shape[2:]
    sr = max(1, X // (Nx if Nx is not None else X))
    sc = max(1, Y // (Ny if Ny is not None else Y))
    rows = np.arange(0, X, sr)
    cols = np.arange(0, Y, sc)
    r = u[0, 0][np.ix_(rows, cols)].astype(np.float64)
    c = u[0, 1][np.ix_(rows, cols)].astype(np.float64)
    if displacement:
        r = r + rows[:, None]
        c = c + cols[None, :]
    return r, c


def gridplot(u, Nx=64, Ny=64, displacement=True, color="black", ax=None, **kwargs):
    """Draw the image of a regular grid under a deformation.

    ``u``: ``(1, 2, X, Y)`` displacement field (or coordinate map when
    ``displacement=False``).  ``Nx``/``Ny`` bound the number of grid lines in
    each direction (``None`` = every voxel row/column).  Extra kwargs go to
    :class:`matplotlib.collections.LineCollection`.
    """
    from matplotlib import pyplot as plt
    from matplotlib.collections import LineCollection

    r, c = _deformed_coords(u, Nx, Ny, displacement)
    # one segment array: all grid rows, then all grid columns; plotted with
    # axis-1 position horizontal and axis-0 position vertical
    row_lines = np.stack([c, r], axis=-1)            # (nrows, ncols, 2)
    col_lines = row_lines.transpose(1, 0, 2)         # (ncols, nrows, 2)
    segments = list(row_lines) + list(col_lines)
    if ax is None:
        ax = plt.gca()
    ax.add_collection(LineCollection(segments, colors=color, **kwargs))
    ax.autoscale_view()
    ax.axis("equal")
    if not ax.yaxis_inverted():
        ax.invert_yaxis()
    return ax


def quiver(u, Nx=32, Ny=32, color="black", units="xy", angles="xy", scale=1.0,
           ax=None, **kwargs):
    """Arrow plot of a 2D displacement field: one arrow per subsampled voxel,
    anchored at the voxel and pointing along the displacement."""
    from matplotlib import pyplot as plt

    r, c = _deformed_coords(u, Nx, Ny, displacement=False)
    X, Y = to_numpy(u).shape[2:]
    rows = np.arange(0, X, max(1, X // (Nx if Nx is not None else X)))
    cols = np.arange(0, Y, max(1, Y // (Ny if Ny is not None else Y)))
    anchor_r, anchor_c = np.meshgrid(rows, cols, indexing="ij")
    if ax is None:
        ax = plt.gca()
    ax.quiver(
        anchor_c, anchor_r, c, r,
        color=color, angles=angles, units=units, scale=scale, **kwargs,
    )
    ax.axis("equal")
    if not ax.yaxis_inverted():
        ax.invert_yaxis()
    return ax
