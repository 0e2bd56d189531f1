"""Device time of the kernels launched under the program's
``train.optimizer`` span (AdamW's update: global norm, clip, moments,
parameters; ``models/train.py``'s ``OPTIMIZER_SPAN``), over the
device's busy time, in percent."""
from port_bench import program_spans as ps


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_us <= 0:
        return None
    us = ctx.trace.span_us(ps.OPTIMIZER)
    return 100.0 * us / ctx.trace.busy_us if us > 0 else None
