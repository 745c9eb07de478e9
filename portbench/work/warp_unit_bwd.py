"""(bytes, float32 operations) of K5, the 3D atlas warp's backward: read d,
g, I; write dI, d_disp. A frozen copy of ``chip_smoke.work`` (commit
7d81de2)."""
from __future__ import annotations

from portbench.work._counts import shapes, transpose_ops, weight_grad_ops


def work(cfg):
    N, V, _ = shapes(cfg)
    f3 = 4 * 3 * N * V  # one 3-channel field
    f1 = 4 * N * V  # one 1-channel field
    atlas = 4 * V  # the batch-1 atlas
    return 2 * f3 + f1 + 2 * atlas, N * V * (transpose_ops(1) + weight_grad_ops(1))
