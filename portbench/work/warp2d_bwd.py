"""(bytes, float32 operations) of the 2D atlas warp's backward: read d, g, I;
write dI (the batch-1 atlas) and d_disp; the transposed warp (the weights
once, a product and a sum per tap) and the weight gradient (weights and
slopes, per tap the value and two products and sums), counted as
``chip_smoke.py`` counts the 2D stencils (commit 7d81de2)."""
from __future__ import annotations

from portbench.work._counts import AXIS_W2, TAP_W2, shapes


def work(cfg):
    N, V, _ = shapes(cfg)
    return 4 * (2 * 2 * N * V + N * V + 2 * V), N * V * (AXIS_W2 + TAP_W2 + 18
                                                          + 2 * AXIS_W2 + 9 * (1 + 2 * 3))
