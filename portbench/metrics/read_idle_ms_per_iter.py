"""Device idle ms per iteration over the traced stretch in the gaps that
open while the host is inside one of the program's ``lt.read.*`` spans
(``lagomorph_tpu_torch.profiling.span``): the queue drains behind a host
read of the card, which then waits for the next launch.  Each idle gap
(``tracing.busy_and_gaps``) counts whole, from its opening to the next
operation's start.  None where the trace holds no ``lt.`` span or no
device operation."""
from portbench.tracing import busy_and_gaps


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["iterations"] or not tr["device"]:
        return None
    host = tr["host"]
    if not any(n.startswith("lt.") for _, n, _, _ in host):
        return None
    reads = sorted((ts, ts + dur) for _, n, ts, dur in host if n.startswith("lt.read."))
    _, gaps = busy_and_gaps(tr["device"])
    idle, k, open_ = 0.0, 0, []
    for t0, t1 in gaps:  # both sorted by start: one sweep
        while k < len(reads) and reads[k][0] <= t0:
            open_.append(reads[k])
            k += 1
        open_ = [r for r in open_ if r[1] > t0]
        if open_:
            idle += t1 - t0
    return idle * 1e-3 / tr["iterations"]
