"""Malleable Jacobi solver (paper §4.3) — x <- D^-1 (b - R x), on the port
(``examples/jacobi.py`` in the JAX package).

Same structure as CG with a different scalability personality: the
iteration is bandwidth-bound, so the paper assigns it a small preferred
size (Table 5).  :func:`main` runs in full fp32 (TF32 off for its run),
as the reference computes ``A @ x``.

    python -m repro_torch.examples.jacobi [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import dmr
from repro_torch.examples import Log, check, cli, full_fp32
from repro_torch.parallel.mesh import Placement, logical_workers

N = 512


def make_problem():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((N, N)).astype(np.float32) * 0.1
    np.fill_diagonal(a, np.abs(a).sum(axis=1) + 1.0)   # diagonally dominant
    b = rng.standard_normal(N).astype(np.float32)
    return a, b


app = dmr.App(name="jacobi")


@app.shardings
def shardings(mesh):
    row = Placement(mesh, ("data", None))
    vec = Placement(mesh)
    return {"A": row, "b": vec, "x": vec}


@app.init
def init(mesh):
    a, b = make_problem()
    dev = mesh.device
    return {"A": torch.from_numpy(a).to(dev), "b": torch.from_numpy(b).to(dev),
            "x": torch.zeros(N, device=dev)}


@app.step
def step(mesh):
    def it(state, _):
        A, b, x = state["A"], state["b"], state["x"]
        d = torch.diagonal(A)
        r = b - A @ x + d * x
        x_new = r / d
        return dict(state, x=x_new), (x_new - x).abs().max()

    return it


@full_fp32()
def main(device=None):
    """The reference's loop: 60 iterations, 4 -> 8 -> 2 at 8 and 20.
    Returns ``(runner, state, out)``."""
    say = Log()
    params = dmr.set_parameters(2, 8, 4)
    runner = dmr.MalleableRunner(
        app, params, dmr.connect({8: 8, 20: 2}),
        devices=logical_workers(params.max_procs, device))
    state = runner.init()
    deltas = []
    for i in range(60):
        state = dmr.reconfig(runner, state, i)
        state, delta = runner.step(state, i)
        if i % 10 == 0:
            deltas.append(float(delta))
            say(f"iter {i:3d} workers {runner.current} "
                f"delta {deltas[-1]:.3e}")
    a, b = make_problem()
    err = float(np.max(np.abs(state["x"].cpu().numpy() -
                              np.linalg.solve(a, b))))
    say(f"|x - x_direct|_inf = {err:.3e}; "
        f"resizes {[(e.step, e.from_procs, e.to_procs) for e in runner.events]}")
    check(err < 1e-4, f"|x - x_direct|_inf = {err}")
    say("OK — Jacobi converged across resizes")
    return runner, state, {"deltas": deltas, "err": err, "lines": say.lines}


if __name__ == "__main__":
    cli(main)
