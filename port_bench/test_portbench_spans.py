"""The program's spans read against the device's idle time
(``program_spans.py``): on a trace made by hand, and on the tiny CPU
runs of the cells, whose traces have the spans but no device record."""
import types

import pytest

from port_bench import harness, program_spans as ps, tiny
from port_bench.trace_reduce import Trace

READERS = ("resize_idle_ms.app", "resize_idle_ms.train", "runner_idle.app",
           "step_idle_ms.train", "optimizer_busy_share.train")


def _ev(name, start, end, device=False, kernels=()):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        kernels=list(kernels), cpu_children=[], cpu_parent=None,
        sequence_nr=-1, thread=0, fwd_thread=0, id=id(name) + start)


def _ctx(trace, cell="granite-3-2b.train-elastic", steps=1):
    return harness.LayerContext(
        cell=harness.resolve(harness.load_json(harness.ROOT /
                                               "BENCHMARK.json"), cell),
        window_s=trace.window_us / 1e6, steps=steps, resizes=[],
        trace=trace, peaks={})


@pytest.fixture
def hand_trace():
    """The device busy over [0, 10), [40, 50) (a resize's copy) and
    [70, 100); idle over [10, 40) and [50, 70).  The idle gap [10, 40)
    begins in the drain and runs on through the runner's host work."""
    k = types.SimpleNamespace(duration=5)
    evs = [_ev("bench.window", 0, 100),
           _ev("bench.drain", 0, 20),
           _ev("bench.reconfig", 20, 60), _ev("dmr.reconfig", 20, 60),
           _ev("dmr.query", 21, 24), _ev("dmr.resize", 25, 60),
           _ev("dmr.redistribute", 30, 50),
           _ev("bench.step", 60, 100), _ev("dmr.step", 60, 100),
           _ev("train.optimizer", 80, 90, kernels=[k]),
           _ev("gemv", 0, 10, device=True),
           _ev("Memcpy DtoD", 40, 50, device=True),
           _ev("gemv", 70, 100, device=True)]
    return Trace(types.SimpleNamespace(events=lambda: evs))


def test_idle_counts_inside_a_span_for_its_covered_part_only(hand_trace):
    t = hand_trace
    assert ps.idle_intervals(t) == [(10, 40), (50, 70)]
    # the harness gives the whole gap [10, 40) to the drain
    assert t.idle_by_span()["bench.drain"] == 30
    # inside dmr.resize [25, 60): [25, 40) and [50, 60)
    assert ps.idle_inside(t, [ps.RESIZE]) == 15 + 10
    assert ps.idle_ms_per_span(t, ps.RESIZE) == pytest.approx(0.025)
    assert ps.idle_inside(t, [ps.RECONFIG, ps.STEP]) == 20 + 20
    # the harness's spans start with the program's here: the program's,
    # inside, take the time
    assert ps.idle_by_innermost(t) == {
        "bench.drain": 10, "dmr.reconfig": 1 + 1, "dmr.query": 3,
        "dmr.resize": 5 + 10, "dmr.redistribute": 10, "dmr.step": 10}
    assert sum(ps.idle_by_innermost(t).values()) == \
        t.window_us - t.busy_us
    assert ps.idle_inside(t, ["dmr.pattern.default"]) is None


def test_readers_on_the_hand_trace(hand_trace):
    ctx = _ctx(hand_trace)
    read = {m: harness.load_module(f"metrics/{m}.py").read(ctx)
            for m in READERS}
    assert read["resize_idle_ms.app"] == read["resize_idle_ms.train"] == \
        pytest.approx(0.025)
    assert read["runner_idle.app"] == pytest.approx(40.0)
    assert read["step_idle_ms.train"] == pytest.approx(0.010)
    assert read["optimizer_busy_share.train"] == pytest.approx(100 * 5 / 50)


def test_innermost_takes_the_span_that_began_last():
    evs = [_ev("bench.window", 0, 10), _ev("dmr.step", 0, 10),
           _ev("chunked_ce", 2, 4), _ev("dmr.resize", 3, 6)]
    t = Trace(types.SimpleNamespace(events=lambda: evs))
    assert [(a, b, n) for a, b, n in ps.innermost(t)] == [
        (0, 2, "dmr.step"), (2, 3, "chunked_ce"), (3, 4, "dmr.resize"),
        (4, 6, "dmr.resize"), (6, 10, "dmr.step")]


@pytest.fixture(scope="module", params=["cg-32768.resize-every-5",
                                        "granite-3-2b.train-elastic"])
def tiny_traced(request):
    cell = tiny.tiny_cell(request.param)
    return cell, tiny.cpu_run(cell, 2 ** 31 + 12345, seconds=0.3,
                              trace=True)


def test_tiny_traced_runs_hold_a_resize_span_per_resize(tiny_traced):
    _, out = tiny_traced
    t = out.window.trace
    assert out.window.resizes
    assert len(ps.host_spans(t, ps.RESIZE.__eq__)) == \
        len(out.window.resizes)
    assert len(ps.host_spans(t, ps.STEP.__eq__)) == out.steps


def test_new_readers_give_none_on_a_cpu_trace(tiny_traced):
    cell, out = tiny_traced
    ctx = harness.LayerContext(cell=cell, window_s=out.window.window_s,
                               steps=out.steps, resizes=out.window.resizes,
                               trace=out.window.trace, peaks={})
    assert out.window.trace.busy_us == 0
    for m in READERS:
        assert harness.load_module(f"metrics/{m}.py").read(ctx) is None
    assert ps.idle_by_innermost(out.window.trace) == {}
