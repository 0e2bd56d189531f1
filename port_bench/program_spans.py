"""The program's own profiler spans in a traced window, laid over the
device's idle time.

The port opens a ``record_function`` span at its runner's and train
step's boundaries while a profiler runs (``repro_torch.spans``; with no
profiler they cost nothing).  They land in the harness's trace beside
the device's records, on one clock, so the device's idle time can be put
down to the program's layer the host was in, time-weighted: a gap is
split over the spans it crosses, not given whole to the span in which it
began (``Trace.idle_by_span``, the harness's view).

The spans, by name:

- ``dmr.reconfig``: a DMR_RECONFIG call, the inhibitor check included;
- ``dmr.query``: the RMS round trip inside it;
- ``dmr.resize``: a resize, whole (clamp, mesh, placements,
  redistribution, closure swap, event, listener);
- ``dmr.redistribute``: the state tree's redistribution (pattern
  grouping, every move, the donor's last give-ups), or a custom
  whole-tree callable;
- ``dmr.pattern.<spec>``: one pattern's moves and their sync, named by
  its ``per_pattern`` key (``dmr.pattern.default``);
- ``dmr.step``: the dispatch of one iteration or training step;
- ``train.batch``: a training step's batch upload, host to device;
- ``train.optimizer``: AdamW's update (global norm, clip, moments,
  parameters);
- ``chunked_ce``: a chunk of the cross-entropy (the model's layer).

This reads the trace that ``trace_reduce.Trace`` holds: its host
records (``_evs``), its device busy intervals inside the window
(``_merged``) and its window.  A program without these spans (an older
checkout) gives no span, and every reader built on this returns None.

    python3 port_bench/program_spans.py --workload <cell> --seed <n> \
        --seconds <s>

runs one traced run of a cell, as ``run.py --trace 1`` does, prints its
line, then the device's idle time in the window by the innermost span
the host was in (``split``), in seconds, on stderr.
"""
from __future__ import annotations

import functools
import heapq
from typing import Dict, Iterable, List, Optional, Tuple

RECONFIG = "dmr.reconfig"
RESIZE = "dmr.resize"
STEP = "dmr.step"
OPTIMIZER = "train.optimizer"
#: the spans read here: the harness's and the program's
SPLIT_PREFIXES = ("bench.", "dmr.", "train.", "chunked_ce")
WINDOW = "bench.window"

Interval = Tuple[float, float]
Span = Tuple[float, float, str]


@functools.lru_cache(maxsize=1)
def _spans(trace) -> List[Span]:
    """(start, end, name) of the harness's and the program's host records
    (names that start with one of ``SPLIT_PREFIXES``, the window's own
    span left out), clipped to the window, by start: one pass over the
    trace's records, kept for the trace's readers."""
    from torch.autograd import DeviceType
    w0, w1 = trace.window
    out = []
    for e in trace._evs:
        if e.device_type != DeviceType.CPU or \
                not e.name.startswith(SPLIT_PREFIXES) or e.name == WINDOW:
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t > s:
            out.append((s, t, e.name))
    out.sort()
    return out


def host_spans(trace, match) -> List[Span]:
    """The spans of ``_spans`` whose name ``match`` accepts."""
    return [s for s in _spans(trace) if match(s[2])]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_intervals(trace) -> List[Interval]:
    """The window less the union of the device's records, as ``Trace``
    reckons busy time."""
    w0, w1 = trace.window
    out, t = [], w0
    for s, e in trace._merged + [(w1, w1)]:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    return out


def overlap(a: List[Interval], b: List[Interval]) -> float:
    """The length of the intersection of two sorted, disjoint lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            tot += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _has_device(trace) -> bool:
    return trace is not None and trace.busy_us > 0


def idle_inside(trace, names) -> Optional[float]:
    """Device idle time (us) inside the union of the spans named in
    ``names``; None without device records or without such a span."""
    if not _has_device(trace):
        return None
    names = set(names)
    spans = host_spans(trace, names.__contains__)
    if not spans:
        return None
    return overlap(idle_intervals(trace),
                   union((s, e) for s, e, _ in spans))


def idle_ms_per_span(trace, name: str) -> Optional[float]:
    """Device idle time inside the spans ``name``, over their number, in
    ms."""
    us = idle_inside(trace, [name])
    if us is None:
        return None
    n = len(host_spans(trace, name.__eq__))
    return us / n / 1e3


def innermost(trace) -> List[Span]:
    """The window cut into (start, end, span) pieces, each piece's span
    the innermost one open there (the one that began last, across
    threads), ``bench.window`` where none is."""
    spans = _spans(trace)
    w0, w1 = trace.window
    cuts = sorted({w0, w1, *(s for s, _, _ in spans),
                   *(e for _, e, _ in spans)})
    out, open_, k = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(spans) and spans[k][0] <= a:
            s, e, name = spans[k]
            # the latest start first; of two that start together, the one
            # that ends first, then the program's before the harness's
            heapq.heappush(open_, (-s, e, name.startswith("bench."), k))
            k += 1
        # a span that ended under the top leaves the heap once it is the
        # top
        while open_ and open_[0][1] <= a:
            heapq.heappop(open_)
        out.append((a, b, spans[open_[0][3]][2] if open_ else WINDOW))
    return out


def idle_by_innermost(trace) -> Dict[str, float]:
    """Device idle time (us) in the window by the innermost span the host
    was in, time-weighted."""
    if not _has_device(trace):
        return {}
    idle = idle_intervals(trace)
    out: Dict[str, float] = {}
    j = 0
    for a, b, name in innermost(trace):
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            out[name] = out.get(name, 0.0) + \
                min(b, idle[k][1]) - max(a, idle[k][0])
            k += 1
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import time

    from port_bench import harness
    run_py = harness.load_module("run.py")   # the run's environment
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch
    cell = harness.resolve(harness.load_json(harness.ROOT /
                                             "BENCHMARK.json"),
                           args.workload)
    if not torch.cuda.is_available():
        print("program_spans: no CUDA card", file=sys.stderr)
        return 2
    run = harness.Run(cell=cell, device=torch.device("cuda", 0),
                      seconds=args.seconds, seed=args.seed, trace=True,
                      t0=run_py.T0)
    driver = harness.load_module(f"drivers/{cell.config['driver']}.py")
    out = driver.run(run)
    rc = harness.finish(run, out)
    t = time.perf_counter()
    split = idle_by_innermost(out.window.trace)
    print(f"info split_s {time.perf_counter() - t}", file=sys.stderr)
    print("split " + json.dumps({k: v / 1e6 for k, v in sorted(
        split.items(), key=lambda kv: -kv[1])}), file=sys.stderr)
    return rc


if __name__ == "__main__":
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main())
