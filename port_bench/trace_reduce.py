"""Reduce a ``torch.profiler`` trace of a run's window to what the
per-layer readers read: device busy time, device time by kernel name,
the device time of a ``record_function`` span (its backward included),
and the idle gaps of the device by the harness's span the host was in.

Device records are the profiler's device-side events (kernels, copies,
sets); a span's device-side record, a name the host side has too, is
left out.  Times are microseconds on the profiler's clock.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

#: the harness's spans, around each call into the program
HOST_SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"


def _walk(e):
    todo = [e]
    while todo:
        e = todo.pop()
        yield e
        todo.extend(e.cpu_children)


def span_events(evs, name: str) -> list:
    """The operator records of ``evs`` that belong to the span ``name``:
    each span and what it ran (a recomputation inside the backward
    included), and each record of the autograd engine that ran the
    backward of an operator the span's forward ran (matched by the
    forward's thread and sequence number), with all they ran; each
    record once."""
    step = "autograd::engine::evaluate_function"

    def in_backward(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if e.name.startswith(step):
                return True
        return False

    roots = [e for e in evs if e.name == name]
    fwd = {(d.thread, d.sequence_nr) for r in roots if not in_backward(r)
           for d in _walk(r) if d.sequence_nr >= 0}
    roots += [e for e in evs if e.name.startswith(step) and
              (e.fwd_thread, e.sequence_nr) in fwd]
    seen = {}
    for r in roots:
        for d in _walk(r):
            seen.setdefault(d.id, d)
    return list(seen.values())


class Trace:
    """One window's trace, reduced."""

    def __init__(self, prof, window: Optional[Tuple[float, float]] = None):
        from torch.autograd import DeviceType
        self._evs = prof.events()
        host = [e for e in self._evs if e.device_type == DeviceType.CPU]
        host_names = {e.name for e in host}
        self.device: List[Tuple[str, float, float]] = sorted(
            (e.name, e.time_range.start, e.time_range.end)
            for e in self._evs
            if e.device_type == DeviceType.CUDA and e.name not in host_names
            and e.time_range.end > e.time_range.start)
        self.device.sort(key=lambda r: r[1])
        win = [e for e in host if e.name == WINDOW_SPAN]
        if window is None and win:
            window = (win[0].time_range.start, win[0].time_range.end)
        if window is None and self.device:
            window = (self.device[0][1], self.device[-1][2])
        self.window = window or (0.0, 0.0)
        self.spans = sorted(
            ((e.time_range.start, e.time_range.end, e.name) for e in host
             if e.name.startswith(HOST_SPAN_PREFIX) and e.name != WINDOW_SPAN),
            key=lambda s: s[0])
        self._merged = self._merge()

    def _merge(self) -> List[Tuple[float, float]]:
        w0, w1 = self.window
        out: List[List[float]] = []
        for _, s, e in self.device:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_us(self) -> float:
        return sum(e - s for s, e in self._merged)

    def kernel_us(self) -> Dict[str, float]:
        """Device time by record name, summed over the window."""
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device:
            out[name] += e - s
        return dict(out)

    def matching(self, substrings) -> Tuple[int, float]:
        """(records, device us) of the records whose name holds one of
        ``substrings``."""
        n, us = 0, 0.0
        for name, s, e in self.device:
            if any(sub in name for sub in substrings):
                n += 1
                us += e - s
        return n, us

    def span_us(self, name: str) -> float:
        """Device time of the kernels that the span ``name`` (and its
        backward) launched."""
        return sum(k.duration for e in span_events(self._evs, name)
                   for k in e.kernels)

    def _span_at(self, t: float) -> str:
        # the harness's spans follow each other, none inside another: the
        # last one to start at or before t is the only one that can hold t
        i = bisect.bisect_right(self.spans, (t, float("inf"), "")) - 1
        if i >= 0 and self.spans[i][1] >= t:
            return self.spans[i][2]
        return WINDOW_SPAN

    def idle_by_span(self) -> Dict[str, float]:
        """Device idle time inside the window, by the harness's span the
        host was in when each gap began."""
        w0, w1 = self.window
        out: Dict[str, float] = defaultdict(float)
        t = w0
        for s, e in self._merged + [(w1, w1)]:
            if s > t:
                out[self._span_at(t)] += s - t
            t = max(t, e)
        return dict(out)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.kernel_us().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_span().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:160], us / 1e6] for n, us in ops],
                "idle_gaps": [[n, us / 1e6] for n, us in gaps[:top]]}
