"""Device ms per iteration of the operations that are not the port's own
kernels (names without ``lagomorph::``): PyTorch's elementwise kernels,
reductions, cuFFT, copies and sets, over the traced stretch."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["iterations"] or not tr["device"]:
        return None
    us = sum(dur for name, _, dur in tr["device"] if "lagomorph::" not in name)
    return us * 1e-3 / tr["iterations"]
