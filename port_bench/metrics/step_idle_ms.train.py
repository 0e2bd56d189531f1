"""Device idle time inside the program's ``dmr.step`` spans (one
training step's dispatch: its batch upload, forward, backward and
optimizer launches), over their number, in ms (``program_spans.py``)."""
from port_bench import program_spans as ps


def read(ctx):
    return ps.idle_ms_per_span(ctx.trace, ps.STEP)
