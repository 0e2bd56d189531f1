"""Device idle time inside the program's ``dmr.resize`` spans (a
resize, whole: clamp, mesh, placements, redistribution, closure swap),
over their number, in ms: the runner's host work a resize leaves the
card waiting on (``program_spans.py``)."""
from port_bench import program_spans as ps


def read(ctx):
    return ps.idle_ms_per_span(ctx.trace, ps.RESIZE)
