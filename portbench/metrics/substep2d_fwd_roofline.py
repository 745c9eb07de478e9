"""Percent of K10's and K11's device time per iteration that they would
take at the card's roofline: their bounds a step (``work/adstar2d_fwd.py``
and ``work/compose2d_fwd.py``, each call the larger of its bytes over 3.35
TB/s and its float32 operations over 67 TFLOP/s, times its calls a step in
the configuration's ``roofline``, at each minibatch's rows, averaged over
an epoch) over the device ms a traced iteration of the kernels whose names
hold ``ad_star2d`` or ``compose2d`` and not ``_bwd`` (``ad_star2d_fwd``,
``ad_star2d_march``, ``compose2d_fwd``, ``compose2d_march``: K10 and K11 on
either route; matched by name alone, since they lie in an anonymous
namespace).  None where the trace holds none of them."""
from portbench.metrics.substep2d_bwd_roofline import share

FUNCTIONS = ("adstar2d_fwd", "compose2d_fwd")


def is_kernel(name):
    return ("ad_star2d" in name or "compose2d" in name) and "_bwd" not in name


def read(ctx):
    return share(ctx, FUNCTIONS, is_kernel)
