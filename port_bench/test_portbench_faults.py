"""A run whose timed path is broken underneath comes out not correct:
each fault a cell can have, planted in the program's job, with the rest
of the run (set-up, window, reference, judgement) as the benchmark runs
it, past its look for a card.  And without a card the command prints no
result and exits non-zero."""
import functools
import subprocess
import sys

import pytest

from port_bench import harness, tiny
from port_bench.faults import FAULTS

SEED = 2 ** 31 + 99
SOUND_SEEDS = (2 ** 31 + 7, 2 ** 31 + 8)
#: a sound reading is never taken as under one float32 rounding unit
FLOOR = 2.0 ** -23
CELL_OF = {"lm_train": "granite-3-2b.train-elastic",
           "cg": "cg-32768.resize-every-5"}


@functools.lru_cache(maxsize=None)
def cell_limits_at_tiny_size(kind):
    """The cell's limits carried to the tiny size: each number's largest
    sound reading there times the ratio of the cell's limit to its
    largest sound reading at the cell's size (``limits/<cell>.json``'s
    ``sound``); an exact limit stays 0."""
    full = harness.resolve(harness.load_json(harness.ROOT /
                                             "BENCHMARK.json"),
                           CELL_OF[kind]).limits
    runs = [tiny.cpu_run(tiny.tiny_cell(CELL_OF[kind]), s)
            for s in SOUND_SEEDS]
    out = {}
    for name, _, _ in runs[0].checks:
        if full[name] == 0:
            out[name] = 0
            continue
        worst = max(max(v for n, v, _ in o.checks if n == name)
                    for o in runs)
        out[name] = max(worst, FLOOR) * full[name] / full["sound"][name]
    return out


@pytest.mark.parametrize("kind,fault", [(k, f) for k in sorted(FAULTS)
                                        for f in sorted(FAULTS[k])])
def test_a_broken_timed_path_is_not_correct(kind, fault):
    lim = cell_limits_at_tiny_size(kind)
    cell = tiny.tiny_cell(CELL_OF[kind])
    cell.limits = dict(lim)
    sound = tiny.cpu_run(cell, SEED)
    assert harness.judge(sound.checks, sound.failed), sound.checks
    out = tiny.cpu_run(cell, SEED, breaks=FAULTS[kind][fault])
    assert not harness.judge(out.checks, out.failed), (out.checks, lim)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run")
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "cg-32768.static", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "cg-32768.static", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    import json
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
