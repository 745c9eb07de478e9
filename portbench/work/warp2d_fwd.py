"""(bytes, float32 operations) of the 2D atlas warp (plain PyTorch in the
port): read d, I; write out; per pixel two axes of weights, 9 tap weights,
9 products and 8 sums, counted as ``chip_smoke.py`` counts the 2D stencils
(commit 7d81de2)."""
from __future__ import annotations

from portbench.work._counts import AXIS_W2, TAP_W2, shapes


def work(cfg):
    N, V, _ = shapes(cfg)
    return 4 * (2 * N * V + V + N * V), N * V * (AXIS_W2 + TAP_W2 + 17)
