"""The port benchmark's harness: what every cell's run shares.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix.  The configuration's file (``configs/<name>.json``) names
the driver that runs its kind of job (``drivers/<driver>.py``) and its
plain reference (``refs/<file>.py``); the traffic mix is a data file of
parameters (``traffic/<name>.json``); the cell's limits on what
``correct`` compares are ``limits/<cell>.json``; each per-layer metric is
a reader of its own (``metrics/<metric>.py``, ``read(ctx)``), and each
list of kernel names a data file (``kernels/<name>.json``).  The harness
finds them all by the names in ``BENCHMARK.json``.

A driver sets the job up, runs its window through a :class:`Window`
(drains, resize timings, peak memory, the profiler) and judges what the
timed path produced against the reference; :func:`finish` prints the
result's line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke")


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(rel: str):
    """A file of the benchmark's folder as a module (names may hold
    dots and dashes, so they are not imported by name)."""
    name = "port_bench_" + re.sub(r"\W", "_", rel)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, BENCH_DIR / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> List[str]:
    """The loaded modules (or ``names``) that a run may not hold, compared
    by the first dotted component, whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def resolve(bench: dict, workload: str) -> Cell:
    """The cell ``workload`` of ``bench`` (a parsed ``BENCHMARK.json``),
    with its files read."""
    wl = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name=workload, config_name=wl["config"],
                config=load_json(ROOT / cfg["file"]),
                traffic_name=wl["traffic"],
                traffic=load_json(BENCH_DIR / "traffic" /
                                  f"{wl['traffic']}.json"),
                chips=wl["chips"],
                limits=load_json(BENCH_DIR / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=layer)


@dataclasses.dataclass
class Run:
    cell: Cell
    device: object              # torch.device
    seconds: float
    seed: int
    trace: bool
    t0: float                   # perf_counter at the process's start


# ----------------------------------------------------------------------
# the resource manager's side
# ----------------------------------------------------------------------

class ScheduleRMS:
    """The job's resource manager, as the traffic file scripts it: the
    set-up's resizes (``setup_resizes``, step -> workers), then from
    ``setup_steps`` on a resize at every step that is ``resize_offset``
    (0 by default) past a multiple of ``resize_every``, its targets
    cycling through ``targets``.  Answers
    the runner's query (``repro_torch.dmr``'s RMS connector contract)."""

    def __init__(self, traffic: dict):
        self.setup = {int(k): v for k, v in
                      traffic.get("setup_resizes", {}).items()}
        self.setup_steps = traffic["setup_steps"]
        self.every = traffic.get("resize_every", 0)
        self.offset = traffic.get("resize_offset", 0)
        self.targets = traffic.get("targets", [])
        self.k = 0

    def scheduled(self, step: int) -> bool:
        if step < self.setup_steps:
            return step in self.setup
        return bool(self.every) and step % self.every == self.offset

    def query(self, *, step: int, current: int, params):
        from repro_torch.core.policy import Action
        if not self.scheduled(step):
            return Action.none(current)
        if step < self.setup_steps:
            target = self.setup[step]
        else:
            target = self.targets[self.k % len(self.targets)]
            self.k += 1
        target = params.clamp(target)
        if target == current:
            return Action.none(current)
        return Action("expand" if target > current else "shrink", target)


# ----------------------------------------------------------------------
# the window
# ----------------------------------------------------------------------

class Window:
    """The measured window of one run: its clock, its peak memory, the
    resizes in it and, in a traced run, the profiler over it."""

    def __init__(self, run: Run):
        import torch
        self.torch = torch
        self.run = run
        self.cuda = run.device.type == "cuda"
        self.resizes: List[dict] = []
        self.setup_s = self.window_s = 0.0
        self.peak = 0
        self._prof = None
        self.trace = None
        self.trace_s = 0.0
        self._stack = contextlib.ExitStack()

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.run.device)

    def _max_allocated(self) -> int:
        return self.torch.cuda.max_memory_allocated(self.run.device) \
            if self.cuda else 0

    def start(self) -> None:
        """End of set-up: drained, set-up time read, peak reset (the
        peak is the job's in the window, not set-up's scratch)."""
        self.sync()
        now = time.perf_counter()
        self.setup_s = now - self.run.t0
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.run.device)
        if self.run.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = self._stack.enter_context(profile(activities=acts))
            self._stack.enter_context(
                self.torch.profiler.record_function("bench.window"))
        self.t_start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def span(self, name: str):
        """A ``record_function`` span of the harness (traced runs only)."""
        if self._prof is None:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(name)

    def resize(self, reconfig: Callable):
        """A scheduled resize point: drain, then time the ``dmr.reconfig``
        call that resizes, to its synchronised end, and read the peak
        memory it allocated over what was allocated before it."""
        torch = self.torch
        with self.span("bench.drain"):
            self.sync()
        before = 0
        if self.cuda:
            self.peak = max(self.peak, self._max_allocated())
            torch.cuda.reset_peak_memory_stats(self.run.device)
            before = torch.cuda.memory_allocated(self.run.device)
        t0 = time.perf_counter()
        with self.span("bench.reconfig"):
            out = reconfig()
        self.sync()
        t1 = time.perf_counter()
        over = self._max_allocated() - before if self.cuda else 0
        self.resizes.append({"ms": (t1 - t0) * 1e3, "over_bytes": over,
                             "t0": t0})
        return out

    def resumed(self) -> None:
        """The first iteration after the last resize has ended, its end
        synchronised: the stall the job saw."""
        r = self.resizes[-1]
        r["resume_ms"] = (time.perf_counter() - r["t0"]) * 1e3

    def close(self) -> None:
        self.sync()
        self.window_s = time.perf_counter() - self.t_start
        self._stack.close()
        self.peak = max(self.peak, self._max_allocated())
        if self._prof is not None:
            from port_bench.trace_reduce import Trace
            t = time.perf_counter()
            self.trace = Trace(self._prof)
            self._prof = None
            self.trace_s = time.perf_counter() - t


# ----------------------------------------------------------------------
# what a driver returns, and the result's line
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]
    checks: List[tuple]          # (name, value, limit)
    attempted: int
    failed: int
    window: Window
    steps: int                   # iterations or training steps in the window
    extra: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class LayerContext:
    """What a per-layer reader reads."""
    cell: Cell
    window_s: float
    steps: int
    resizes: List[dict]
    trace: object                # trace_reduce.Trace, or None
    peaks: dict

    def kernels(self, name: str) -> dict:
        return load_json(BENCH_DIR / "kernels" / f"{name}.json")


def p95(values: List[float]) -> Optional[float]:
    """The 95th percentile (inclusive quantiles); None under 2 values."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def judge(checks: List[tuple], failed: int) -> bool:
    return failed == 0 and all(
        isinstance(v, (int, float)) and math.isfinite(v) and v <= lim
        for _, v, lim in checks)


def result_line(run: Run, out: Outcome) -> dict:
    """The run's result: its cell's end-to-end metrics (``--trace 0``)
    or per-layer metrics (``--trace 1``), the device, the checks."""
    import torch
    cell, win = run.cell, out.window
    metrics = {}
    plimit = power_limit() if run.device.type == "cuda" else "none"
    if run.trace:
        ctx = LayerContext(cell=cell, window_s=win.window_s,
                           steps=out.steps, resizes=win.resizes,
                           trace=win.trace,
                           peaks=load_json(BENCH_DIR / "peaks.json"))
        for m in cell.per_layer:
            v = load_module(f"metrics/{m['name']}.py").read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] not in out.e2e or out.e2e[m["name"]] is None:
                raise RuntimeError(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    cuda = run.device.type == "cuda"
    device = {"platform": "gpu" if cuda else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if cuda
              else "cpu",
              "count": 1,
              "memory_peak_bytes": win.peak}
    line = {"correct": judge(out.checks, out.failed),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if run.trace and win.trace is not None:
        device["busy_s"] = win.trace.busy_us / 1e6
        device["window_s"] = win.trace.window_us / 1e6
        line["breakdown"] = win.trace.breakdown()
    line["power_limit"] = plimit
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in out.checks}
    return line


def finish(run: Run, out: Outcome) -> int:
    """Print the result's line (stdout) and the checks (the last lines of
    stderr); refuse to print one if the process holds a forbidden
    module."""
    line = result_line(run, out)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the run loaded {bad}: no result",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for k, v in out.extra.items():
        if k != "reference":
            print(f"info {k} {v}", file=sys.stderr)
    if run.trace:
        print(f"info trace_s {out.window.trace_s}", file=sys.stderr)
    for name, v, lim in out.checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr, flush=True)
    return 0


# ----------------------------------------------------------------------
# judging a state
# ----------------------------------------------------------------------

def fingerprint(t) -> object:
    """An order-sensitive digest of one tensor, equal for equal bits on
    one device: float tensors as one float64 number (a fixed-weight
    product of each 1024-element row, then a position-weighted sum of
    the rows), others as their values on the host."""
    import torch
    if not t.is_floating_point():
        return tuple(t.reshape(-1).cpu().tolist())
    flat = t.reshape(-1).float()
    n = flat.numel()
    if n % 1024 == 0 and n >= 1024:
        w = torch.linspace(1.0, 2.0, 1024, device=t.device)
        rows = (flat.view(-1, 1024) @ w).double()
    else:
        rows = flat.double()
    pos = torch.arange(1, rows.numel() + 1, dtype=torch.float64,
                       device=t.device)
    return float(rows @ pos)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             counted: List[str]) -> tuple:
    """The worst counted leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's: (gap, leaf)."""
    med = statistics.median(ref[k] for k in counted)
    worst = max(counted, key=lambda k: abs(prog[k] - ref[k]) /
                max(ref[k], med))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med), worst
