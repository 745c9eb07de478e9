"""(bytes, float32 operations) of K2, compose: read phi, v; write out. A
frozen copy of ``chip_smoke.work`` (commit 7d81de2)."""
from __future__ import annotations

from portbench.work._counts import shapes, warp_ops


def work(cfg):
    N, V, _ = shapes(cfg)
    f3 = 4 * 3 * N * V  # one 3-channel field
    return 3 * f3, N * V * (3 + warp_ops(3) + 3 + 6)
