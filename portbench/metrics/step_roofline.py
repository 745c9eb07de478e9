"""Percent of the device's busy time per iteration that the step's
functions would take at the card's roofline: the sum over the
configuration's ``roofline`` functions (name: calls a step) of each call's
bound (``work/<name>.py``: the larger of its bytes over 3.35 TB/s and its
float32 operations over 67 TFLOP/s) at each minibatch's rows, averaged
over an epoch, over busy ms per iteration.  The denominator is all busy
time, so it reads the same work whatever implements it."""
from portbench.work._counts import bound_ms


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["iterations"] or not ctx.busy_us:
        return None
    need = ctx.per_step(bound_ms)
    return None if need is None else 100.0 * need / (ctx.busy_us * 1e-3 / tr["iterations"])
