"""Percent of K12's and K13's device time per iteration that they would
take at the card's roofline: their bounds a step (``work/adstar2d_bwd.py``
and ``work/compose2d_bwd.py``, each call the larger of its bytes over 3.35
TB/s and its float32 operations over 67 TFLOP/s, times its calls a step in
the configuration's ``roofline``, at each minibatch's rows, averaged over
an epoch) over the device ms a traced iteration of the kernels whose names
hold ``ad_star2d_bwd`` or ``compose2d_bwd`` (K12's tile kernel, its two
per-thread kernels ``ad_star2d_bwd`` and ``ad_star2d_bwd_m0``, and K13;
matched by name alone, since they lie in an anonymous namespace).  None
where the trace holds none of them."""
from portbench.work._counts import bound_ms

FUNCTIONS = ("adstar2d_bwd", "compose2d_bwd")


def is_kernel(name):
    return "ad_star2d_bwd" in name or "compose2d_bwd" in name


def share(ctx, functions, is_kernel):
    """100 x the bounds a step of ``functions`` over the device ms a traced
    iteration of the operations ``is_kernel`` names."""
    tr = ctx.trace
    if tr is None or not tr["iterations"] or not ctx.rows:
        return None
    us = sum(dur for name, _, dur in tr["device"] if is_kernel(name))
    if not us:
        return None
    calls = ctx.cfg.get("roofline", {})
    need = sum(calls.get(f, 0) * bound_ms(*ctx.work(f)(dict(ctx.cfg, batch_size=b)))
               for b in ctx.rows for f in functions) / len(ctx.rows)
    return 100.0 * need / (us * 1e-3 / tr["iterations"])


def read(ctx):
    return share(ctx, FUNCTIONS, is_kernel)
