"""Mean host time of the window's resizing ``dmr.reconfig`` calls, each
from a drained start to its synchronised end (the runner's layer:
``dmr/runner.py``, ``dmr/patterns.py``, ``core/redistribute.py``)."""


def read(ctx):
    ms = [r["ms"] for r in ctx.resizes]
    return sum(ms) / len(ms) if ms else None
