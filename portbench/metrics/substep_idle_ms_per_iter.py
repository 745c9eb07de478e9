"""Device idle ms per iteration over the traced stretch in the gaps that
open while the host is inside one of the program's ``lt.substep`` spans
(``lagomorph_tpu_torch.profiling.span``, one a substep of the shooting's
per-substep loop): the launches of the loop do not keep the card fed.  Read
as ``read_idle_ms_per_iter`` reads the ``lt.read.*`` spans: each idle gap
(``tracing.busy_and_gaps``) counts whole, from its opening to the next
operation's start.  None where the trace holds no ``lt.substep`` span or
no device operation."""
from portbench.tracing import busy_and_gaps


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["iterations"] or not tr["device"]:
        return None
    spans = sorted((ts, ts + dur) for _, n, ts, dur in tr["host"] if n == "lt.substep")
    if not spans:
        return None
    _, gaps = busy_and_gaps(tr["device"])
    idle, k, open_ = 0.0, 0, []
    for t0, t1 in gaps:  # both sorted by start: one sweep
        while k < len(spans) and spans[k][0] <= t0:
            open_.append(spans[k])
            k += 1
        open_ = [s for s in open_ if s[1] > t0]
        if open_:
            idle += t1 - t0
    return idle * 1e-3 / tr["iterations"]
