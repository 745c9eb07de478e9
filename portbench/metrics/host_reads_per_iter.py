"""The program's host reads of the card per iteration over the traced
stretch: its ``lt.read.*`` spans (``lagomorph_tpu_torch.profiling.span``:
the shooting's flag, the warp's tier, the loss, the regulariser).  None
where the trace holds no ``lt.`` span: a program without spans."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr["iterations"]:
        return None
    names = [n for _, n, _, _ in tr["host"]]
    if not any(n.startswith("lt.") for n in names):
        return None
    return sum(n.startswith("lt.read.") for n in names) / tr["iterations"]
