"""Device idle time inside the program's ``dmr.reconfig`` and
``dmr.step`` spans (the runner's DMR_RECONFIG calls and its dispatch of
each iteration), over the traced window, in percent
(``program_spans.py``)."""
from port_bench import program_spans as ps


def read(ctx):
    us = ps.idle_inside(ctx.trace, [ps.RECONFIG, ps.STEP])
    if us is None or ctx.trace.window_us <= 0:
        return None
    return 100.0 * us / ctx.trace.window_us
