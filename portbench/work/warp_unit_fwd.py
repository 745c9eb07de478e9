"""(bytes, float32 operations) of K4, the 3D atlas warp: read d, I; write
out. A frozen copy of ``chip_smoke.work`` (commit 7d81de2)."""
from __future__ import annotations

from portbench.work._counts import shapes, warp_ops


def work(cfg):
    N, V, _ = shapes(cfg)
    f3 = 4 * 3 * N * V  # one 3-channel field
    f1 = 4 * N * V  # one 1-channel field
    atlas = 4 * V  # the batch-1 atlas
    return f3 + atlas + f1, N * V * warp_ops(1)
