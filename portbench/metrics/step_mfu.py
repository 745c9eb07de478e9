"""Percent of the card's float32 peak (67 TFLOP/s) that the whole step's
operations fill over an untraced iteration's wall time: the float32
operations of the configuration's ``roofline`` functions (``work/<name>.py``,
at each minibatch's rows, averaged over an epoch) over the mean seconds of
the window's untraced iterations."""
from portbench.work._counts import FP32_FLOP_PER_S


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["device"] or not ctx.iter_s:
        return None
    ops = ctx.per_step(lambda nbytes, flops: flops)
    return None if ops is None else 100.0 * ops / (FP32_FLOP_PER_S * ctx.iter_s)
