"""Host ms per iteration over the traced stretch inside the program's
``lt.iteration`` spans but outside the ``lt.read.*`` spans within them
(``lagomorph_tpu_torch.profiling.span``): Python, autograd and the
launches, the time the host takes to issue an iteration.  The profiler's
own cost on the host lands here too.  None where the trace holds no
``lt.`` span."""


def _union(intervals):
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["iterations"]:
        return None
    host = tr["host"]
    if not any(n.startswith("lt.") for _, n, _, _ in host):
        return None
    iters = [(ts, ts + dur) for _, n, ts, dur in host if n == "lt.iteration"]
    reads = [(ts, ts + dur) for _, n, ts, dur in host if n.startswith("lt.read.")]
    us = 0.0
    for a, b in iters:
        us += (b - a) - _union([(max(r0, a), min(r1, b)) for r0, r1 in reads if r0 < b and r1 > a])
    return us * 1e-3 / tr["iterations"]
