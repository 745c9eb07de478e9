"""Host synchronisations with the device per iteration over the traced
stretch: the CUDA runtime's stream, device and event synchronisations and
synchronous copies, up to the harness's closing fence (``portbench::fence``:
its synchronisation and the profiler's stop after it are the harness's)."""

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["iterations"] or not tr["device"]:
        return None
    end = min((ts for _, name, ts, _ in tr["host"] if name == "portbench::fence"),
              default=float("inf"))
    n = sum(1 for cat, name, ts, _ in tr["host"]
            if cat == "cuda_runtime" and name in SYNCS and ts < end)
    return n / tr["iterations"]
