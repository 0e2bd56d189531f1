"""Profiler spans of the port, free when no profiler runs.

    with span(STEP_SPAN):
        ...

Under ``torch.profiler.profile`` a span is a ``record_function`` range:
it lands in the same trace as the device's records, on one clock, so a
span can be laid over the device's busy and idle intervals.  With no
profiler running, ``span`` returns one shared ``nullcontext`` and costs
a flag read, where a ``record_function`` enter and exit costs ~10 us.
(The profiler's fast entry, ``_RecordFunctionFast``, opens a range for
~1 us, but on an H100 host it made reducing a traced granite-3-2b
window's 600k records take 70 s instead of 48.)  Spans are held in the
profiler's memory and written out with its trace; nothing here keeps or
exports them.

Each span's name is a constant beside the code it covers (``CE_SPAN`` in
``models/train.py``, ``STEP_SPAN`` in ``dmr/runner.py``, ...).
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` span named ``name`` while the profiler is
    on, else the shared null context."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL
