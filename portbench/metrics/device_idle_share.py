"""Percent of an untraced iteration's wall time in which no operation ran
on the device: 100 (1 - busy union an iteration of the traced stretch /
the mean seconds of the window's untraced iterations).  The profiler slows
the host, so the traced stretch's own wall would read its cost as idle."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["device"] or not tr["iterations"] or not ctx.iter_s:
        return None
    return 100.0 * (1.0 - ctx.busy_us * 1e-6 / tr["iterations"] / ctx.iter_s)
