"""Float32 operations per voxel of the port's stencils and the card's
published peaks: a frozen copy of ``chip_smoke.py``'s counts, ``bound``
and peaks (commit 7d81de2), and the shapes of a configuration.  Each input
is counted read once and each output written once."""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

AXIS_W = 27  # three axes of weights: floor, subtract, 2 compares, 4 mul, 1 add
TAP_W = 36  # 27 tap weights: 9 (x, y) products, 27 products with z
JAC_OPS = 36  # 9 central differences (2 each), 9 products, 6 sums, 3 diagonal adds
DIV_OPS = 51  # 9 transposed differences of products (5 each), 6 sums
AXIS_W2, TAP_W2 = 18, 9  # the 2D stencils: two axes of weights, 9 tap weights
WARP2 = AXIS_W2 + TAP_W2 + 17 * 2
AD2 = WARP2 + 14  # + 4 central differences (2 each), 2 diagonal adds, 4 products
COMPOSE2 = WARP2 + 4  # + s*v (2) and the two sums
FLAG2 = 8  # two compares per component, s*v and phiinv
TRANSPOSE2 = AXIS_W2 + TAP_W2 + 18 * 2
WGRAD2 = 2 * AXIS_W2 + 9 * (3 + 2 * 3)  # weights and slopes; per tap <c, I> and 2 products and sums
ADSTAR2_BWD = TRANSPOSE2 + WGRAD2 + 12 + 2 * 10 + 4
COMPOSE2_BWD = TRANSPOSE2 + WGRAD2 + 4


def warp_ops(C):  # forward warp: 27 products and 26 sums per channel
    return AXIS_W + TAP_W + 53 * C


def transpose_ops(C):  # its transpose: one product and one sum per (tap, channel)
    return AXIS_W + TAP_W + 54 * C


def weight_grad_ops(C):  # d_disp: weights and slopes, 27 (x, y) pair products,
    # per tap the channel dot product (2C - 1) and three products and sums (9)
    return AXIS_W + 9 + 27 + 27 * (2 * C - 1 + 9)


def bound_ms(nbytes, flops):
    """The least time in ms the card could take for work that must move
    ``nbytes`` bytes and do ``flops`` float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S) * 1e3


def shapes(cfg):
    """``(N, V, substeps)``: the batch, the voxels of a field and the
    shooting's substeps after the peeled first."""
    return (int(cfg["batch_size"]), math.prod(cfg["shape"]),
            int(cfg["lddmm_integration_steps"]) - 1)
