"""Driver of the paper's malleable conjugate gradient (§4.3) on the port:
``repro_torch.dmr.MalleableRunner`` over
``repro_torch.examples.cg_solver.make_app(n)``, as that example's
``main`` loops: ``dmr.reconfig``, one CG iteration, the residual read
every ``read_every`` iterations.  Full fp32, TF32 off, as ``main`` runs.

The job solves one system after another, A x = b_k for k = 0, 1, ...:
A made once from the seed, each b_k from the seed and k (the
reference's :func:`make_matrix` and :func:`rhs`).  A solve ends at the
first residual read at which |r| <= tol |b_k| (the configuration's
``tol``); the driver then puts the next b_k into the state (x = 0,
r = p = b_k), so that every iteration works on a solve that is still
open.  A solve still open after ``max_iters`` iterations is an answer
that never came: it counts as failed, and the next one starts.

Set-up runs solve 0 through each worker count and each kind of resize
of the schedule once, each resize checked to leave the state's bits as
they were.  The window iterates until ``--seconds`` have passed and the
next residual read, draining the device at each scheduled resize; a
solve still open then runs on to its end outside the window.  After it
the program's A is compared with the seed's, bit for bit, and the x of
solve 0, of the window's last solve and of a share of the others drawn
from the seed with the reference's float64 solutions.
"""
from __future__ import annotations

import gc
import math
import random
import time

from port_bench.harness import (Outcome, Run, ScheduleRMS, Window, p95,
                                fingerprint, load_module)

STATE_KEYS = ("A", "x", "r", "p", "rs")
#: the share of the window's solves whose x is judged
JUDGED_SHARE = 1 / 8


def run(run: Run, breaks=None) -> Outcome:
    """``breaks``: test hooks that break the timed path (the benchmark's
    fault tests), as ``{"app": fn(app) -> app}``."""
    import torch
    from repro_torch import dmr
    from repro_torch.examples.cg_solver import make_app
    from repro_torch.parallel.mesh import logical_workers

    cell, seed, dev = run.cell, run.seed, run.device
    cfg, tr = cell.config, cell.traffic
    ref = load_module(cfg["reference"])
    n, every, tol, max_iters = (cfg["n"], tr["read_every"], cfg["tol"],
                                cfg["max_iters"])
    torch.backends.cuda.matmul.allow_tf32 = False
    prog = make_app(n)

    def fresh(k, device):
        b = ref.rhs(n, seed, k, device)
        rs = torch.dot(b, b)
        return {"x": torch.zeros_like(b), "r": b, "p": b.clone(),
                "rs": rs}, torch.sqrt(rs)

    def init(mesh):
        return dict(A=ref.make_matrix(n, seed, mesh.device),
                    **fresh(0, mesh.device)[0])

    app = dmr.App(init=init, shardings=prog.state_shardings,
                  step=prog.make_step, name=prog.name)
    if breaks and "app" in breaks:
        app = breaks["app"](app)
    params = dmr.set_parameters(*cfg["malleability"])
    rms = ScheduleRMS(tr)
    runner = dmr.MalleableRunner(
        app, params, rms, devices=logical_workers(params.max_procs, dev))

    judged = random.Random(seed)
    kept = {}                   # solve -> its x, on the host
    now = {"k": 0, "iters": 0, "bn": None, "ended": 0, "failed": 0,
           "last": None, "next": None}

    def read(state, res):
        """The residual read after a step: the solve ends, fails, or goes
        on.  Returns the state and whether a solve ended or failed.  The
        next solve's b is drawn before the read waits, so that its
        drawing overlaps the iterations still on the device."""
        k = now["k"]
        if now["next"] is None:
            now["next"] = fresh(k + 1, dev)
        rel = float(res / now["bn"])
        if math.isfinite(rel) and rel <= tol:
            now["ended"] += 1
            now["last"] = (now["k"], state["x"])
            if now["k"] == 0 or judged.random() < JUDGED_SHARE:
                kept[now["k"]] = state["x"].cpu()
        elif not math.isfinite(rel) or now["iters"] >= max_iters:
            now["failed"] += 1
        else:
            return state, False
        vectors, bn = now["next"]
        now.update(k=k + 1, iters=0, bn=bn, next=None)
        return dict(state, **vectors), True

    def step(state, i):
        state, res = runner.step(state, i)
        now["iters"] += 1
        return state, res

    # -- set-up: solve 0, each worker count and each resize once ---------
    state = runner.init()
    now["bn"] = torch.sqrt(state["rs"])
    changed = 0
    for i in range(tr["setup_steps"]):
        if rms.scheduled(i):
            before = [fingerprint(state[k]) for k in STATE_KEYS]
            state = dmr.reconfig(runner, state, i)
            after = [fingerprint(state[k]) for k in STATE_KEYS]
            changed += sum(a != b for a, b in zip(before, after))
        else:
            state = dmr.reconfig(runner, state, i)
        state, res = step(state, i)
        if (i + 1) % every == 0:
            state, _ = read(state, res)

    # -- the window ------------------------------------------------------
    win = Window(run)
    win.start()
    i, iters = tr["setup_steps"], 0
    k0, ended0, failed0 = now["k"], now["ended"], now["failed"]
    while True:
        resized = rms.scheduled(i)
        if resized:
            state = win.resize(lambda: dmr.reconfig(runner, state, i))
        else:
            with win.span("bench.reconfig"):
                state = dmr.reconfig(runner, state, i)
        with win.span("bench.step"):
            state, res = step(state, i)
        iters += 1
        i += 1
        if i % every == 0:
            with win.span("bench.residual_read"):
                state, over = read(state, res)
            if resized:
                win.resumed()
            if win.elapsed() >= run.seconds:
                break
        elif resized:
            with win.span("bench.drain"):
                win.sync()
            win.resumed()
    win.close()
    solves = now["ended"] - ended0
    attempted = now["k"] - k0 + (not over)
    while not over:             # the last solve, late but not lost
        state, res = step(state, i)
        i += 1
        if i % every == 0:
            state, over = read(state, res)
    if now["last"] is not None and now["last"][0] not in kept:
        kept[now["last"][0]] = now["last"][1].cpu()
    failed = now["failed"] - failed0

    # -- judge: A as made, each kept x against the float64 solution ------
    t_ref = time.perf_counter()
    a_prog = state["A"]
    del state, res, runner, app, prog, now["last"]
    gc.collect()
    a_ref = ref.make_matrix(n, seed, dev)
    a_changed = sum(int((a_prog[r:r + ref.ROWS] != a_ref[r:r + ref.ROWS])
                        .sum()) for r in range(0, n, ref.ROWS))
    del a_prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ks = sorted(kept)
    x_err = math.inf
    if ks:
        x_star = ref.solve(a_ref, torch.stack(
            [ref.rhs(n, seed, k, dev) for k in ks], 1))
        x_err = max(ref.rel_err(kept[k].to(dev), x_star[:, j])
                    for j, k in enumerate(ks))
    t_ref = time.perf_counter() - t_ref
    lim = cell.limits
    checks = [("x_err", x_err, lim["x_err"]),
              ("a_changed_entries", a_changed, lim["a_changed_entries"]),
              ("resize_changed_leaves", changed,
               lim["resize_changed_leaves"])]
    e2e = {"solves_per_s": solves / win.window_s,
           "peak_mem_gb": win.peak / 1e9, "setup_s": win.setup_s,
           "resume_p95_ms": p95([r["resume_ms"] for r in win.resizes])}
    return Outcome(e2e=e2e, checks=checks, attempted=attempted,
                   failed=failed, window=win, steps=iters,
                   extra={"resizes": len(win.resizes), "iterations": iters,
                          "solves": solves, "judged": len(ks),
                          "reference_s": t_ref})
