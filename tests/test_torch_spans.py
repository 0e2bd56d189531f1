"""The port's profiler spans (``repro_torch.spans``), on the CPU.

With no profiler running a span is one shared null context.  Under
``torch.profiler.profile`` the runner's and the train step's spans appear
once per call, each inside the span that calls it (by ``cpu_parent``):

    dmr.reconfig > dmr.query
    dmr.reconfig > dmr.resize > dmr.redistribute > dmr.pattern.<spec>
    dmr.step > train.batch, train.optimizer
"""
import contextlib
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench.trace_reduce import span_events
from repro_torch import dmr
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.lm_app import BATCH_SPAN, lm_train_app
from repro_torch.dmr.patterns import PATTERN_SPAN_PREFIX, REDISTRIBUTE_SPAN
from repro_torch.dmr.runner import (QUERY_SPAN, RECONFIG_SPAN, RESIZE_SPAN,
                                    STEP_SPAN)
from repro_torch.examples.cg_solver import make_app
from repro_torch.models.train import CE_SPAN, OPTIMIZER_SPAN
from repro_torch.optim import AdamW
from repro_torch.parallel.mesh import logical_workers
from repro_torch.spans import span

PATTERN_SPAN = PATTERN_SPAN_PREFIX + "default"
#: each span and the span that encloses it
PARENT = {QUERY_SPAN: RECONFIG_SPAN, RESIZE_SPAN: RECONFIG_SPAN,
          REDISTRIBUTE_SPAN: RESIZE_SPAN, PATTERN_SPAN: REDISTRIBUTE_SPAN,
          BATCH_SPAN: STEP_SPAN, OPTIMIZER_SPAN: STEP_SPAN}
SPANS = {RECONFIG_SPAN, STEP_SPAN, *PARENT}


def _enclosing(e):
    """The nearest span of ``SPANS`` above ``e``, by ``cpu_parent``."""
    p = e.cpu_parent
    while p is not None and p.name not in SPANS:
        p = p.cpu_parent
    return p and p.name


def _traced(runner, steps):
    """Run ``steps`` DMR_RECONFIG points and steps under the profiler;
    returns the profiler's events."""
    state = runner.init()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(steps):
            state = dmr.reconfig(runner, state, i)
            state, _ = runner.step(state, i)
    return prof.events()


def test_span_is_the_shared_null_context_when_no_profiler_runs():
    assert span("a") is span("b")
    assert isinstance(span("a"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("a"), torch.profiler.record_function)
    assert span("a") is span("b")


def test_runner_spans_nest_once_per_call():
    """A CG job on CPU workers, 4 -> 8 -> 2."""
    steps = 8
    runner = dmr.MalleableRunner(
        make_app(64), dmr.set_parameters(2, 8, 4), {2: 8, 5: 2},
        devices=logical_workers(8, "cpu"))
    evs = _traced(runner, steps)
    counts = Counter(e.name for e in evs if e.name in SPANS)
    assert [(e.from_procs, e.to_procs) for e in runner.events] == \
        [(4, 8), (8, 2)]
    assert counts == {RECONFIG_SPAN: steps, QUERY_SPAN: steps,
                      STEP_SPAN: steps, RESIZE_SPAN: 2,
                      REDISTRIBUTE_SPAN: 2, PATTERN_SPAN: 2}
    for e in evs:
        if e.name in SPANS:
            assert _enclosing(e) == PARENT.get(e.name), e.name


def test_a_custom_redistribution_runs_in_its_span():
    def move(state, shardings):
        return ({k: v.clone() for k, v in state.items()},
                dmr.TransferStats(bytes_moved=0, seconds=0.0, n_leaves=0))

    runner = dmr.MalleableRunner(
        make_app(64), dmr.set_parameters(2, 8, 4), {1: 8},
        devices=logical_workers(8, "cpu"), redistribute=move)
    evs = _traced(runner, 3)
    spans = [e for e in evs if e.name in SPANS]
    assert sum(e.name == REDISTRIBUTE_SPAN for e in spans) == 1
    assert not any(e.name.startswith(PATTERN_SPAN_PREFIX) for e in evs)
    assert all(_enclosing(e) == PARENT.get(e.name) for e in spans)


@pytest.fixture(scope="module")
def train_events():
    """Three granite-3-2b-smoke steps, 4 -> 8 before the second."""
    app = lm_train_app(get_config("granite-3-2b-smoke"),
                       ShapeConfig("t", "train", 64, 8),
                       AdamW(learning_rate=1e-3), seed=0)
    runner = dmr.MalleableRunner(app, dmr.MalleabilityParams(2, 8, 4),
                                 dmr.ScriptedRMS({1: 8}),
                                 devices=logical_workers(8, "cpu"))
    return _traced(runner, 3)


def test_train_step_spans_nest_once_per_step(train_events):
    spans = [e for e in train_events if e.name in SPANS]
    counts = Counter(e.name for e in spans)
    assert counts[STEP_SPAN] == counts[BATCH_SPAN] == \
        counts[OPTIMIZER_SPAN] == 3
    assert counts[RESIZE_SPAN] == counts[PATTERN_SPAN] == 1
    for e in spans:
        assert _enclosing(e) == PARENT.get(e.name), e.name


def test_ce_span_still_found_with_its_backward(train_events):
    evs = span_events(train_events, CE_SPAN)
    assert sum(e.name == CE_SPAN for e in evs) == 3
    assert any(e.name.startswith("autograd::engine::evaluate_function")
               for e in evs)
