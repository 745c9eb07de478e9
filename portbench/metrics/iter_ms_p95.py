"""The 95th percentile of the intervals between successive iteration
returns over the window (rank 0's), the first from the window's start, in
ms: ``statistics.quantiles(n=20)``'s last cut."""
import statistics


def read(run):
    return statistics.quantiles(run.intervals, n=20)[-1] * 1e3
