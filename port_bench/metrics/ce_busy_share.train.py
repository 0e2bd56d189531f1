"""Device time of the kernels launched under the program's
``chunked_ce`` span (``models/train.py``'s ``CE_SPAN``) and its backward,
over the device's busy time, in percent."""

SPAN = "chunked_ce"


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_us <= 0:
        return None
    us = ctx.trace.span_us(SPAN)
    return 100.0 * us / ctx.trace.busy_us if us > 0 else None
