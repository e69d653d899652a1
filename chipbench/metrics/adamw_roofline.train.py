"""AdamW's update at its roofline: the bytes the update cannot avoid in the
traced window's steps (each parameter, its gradient and its two f32
moments read once, the parameter and the moments written once: 2 x the
parameter's bytes + the gradient's + 16 a parameter, gradients in the
parameters' dtype) at the HBM peak, over the device time of the
operations launched inside the port's ``adamw.update`` spans, in
percent; with the port's ``adamw.kernel_elems`` over ``adamw.elems``
counters on standard error.  Nothing where the program has no such
span."""

import math
import sys

from chipbench import weights, yardstick

SPAN = "adamw.update"


def parameters(m: dict):
    """(parameters, the update's bytes a step) of the model ``m``."""
    n = nbytes = 0
    for leaf in weights.leaves(m, train=True):
        k = math.prod(leaf.shape)
        b = leaf.dtype.itemsize
        n += k
        nbytes += k * (3 * b + 16)
    return n, nbytes


def read(record: dict):
    spans = record["ranges"].get(SPAN, [])
    steps = record["work"].get("steps")
    if not spans or not steps:
        return None
    measured = sum(b - a for _, a, b, launch in record["device_ops"]
                   if launch is not None
                   and any(s <= launch <= e for s, e in spans))
    if measured <= 0:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        trace = None
    if trace is not None:
        got = trace.snapshot()
        print(f"adamw elements: {got.get('adamw.kernel_elems')} by the "
              f"kernel of {got.get('adamw.elems')} updated", file=sys.stderr,
              flush=True)
    _, nbytes = parameters(record["model"])
    return 100.0 * yardstick.bound_s(0, steps * nbytes) / measured
