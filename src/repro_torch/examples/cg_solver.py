"""Malleable Conjugate Gradient — the paper's flagship application (§4.3),
on the port (``examples/cg_solver.py`` in the JAX package).

The solver state (A split by rows over the job mesh's ``data`` axis; x, r,
p and rs replicated) lives on the job's workers; a resize redistributes it
with the *default* 1-D pattern (paper Fig. 2) and the iteration continues
where it left off.  The user code is three plain functions bound to a
``dmr.App``.  At the reference's size (``N``) the problem is the
reference's numpy construction and x is checked against a direct solve; at
any other size the same construction runs on the device from a seeded
``torch.Generator`` and the check is the true relative residual
``|b - A x|_2 / |b|_2`` in fp64.  :func:`main` runs in full fp32 (TF32
off for its run), as the reference computes ``A @ p``, whatever the
caller's setting.

    python -m repro_torch.examples.cg_solver [--device cpu] [--n 32768]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import dmr
from repro_torch.examples import Log, check, cli, full_fp32
from repro_torch.parallel.mesh import Placement, logical_workers

N = 512
SEED = 0
#: the fp64 relative residual a problem of another size than N must reach
REL_RESIDUAL_TOL = 1e-4
#: rows of A promoted to fp64 at a time by the residual check
CHECK_ROWS = 4096


def make_problem(n: int = N, device="cpu"):
    """SPD A = M M^T + n I and b, on ``device``: the reference's numpy
    draws at ``N``, a seeded ``torch.Generator`` on the device otherwise."""
    if n == N:
        rng = np.random.default_rng(SEED)
        m = rng.standard_normal((N, N)).astype(np.float32) * 0.1
        a = m @ m.T + N * np.eye(N, dtype=np.float32)
        b = rng.standard_normal(N).astype(np.float32)
        return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    m = torch.randn(n, n, generator=gen, device=device).mul_(0.1)
    a = m @ m.T
    del m
    a.diagonal().add_(n)
    b = torch.randn(n, generator=gen, device=device)
    return a, b


def relative_residual(a: torch.Tensor, b: torch.Tensor,
                      x: torch.Tensor) -> float:
    """``|b - A x|_2 / |b|_2`` in fp64, ``CHECK_ROWS`` rows of A at a time."""
    x64, r = x.double(), b.to(torch.float64, copy=True)
    for i in range(0, a.shape[0], CHECK_ROWS):
        r[i:i + CHECK_ROWS] -= a[i:i + CHECK_ROWS].double() @ x64
    return float(r.norm() / b.double().norm())


def make_app(n: int = N) -> dmr.App:
    """The CG job on an n x n problem: one CG iteration per step."""
    app = dmr.App(name="cg")

    @app.shardings
    def shardings(mesh):
        row = Placement(mesh, ("data", None))
        vec = Placement(mesh)
        return {"A": row, "x": vec, "r": vec, "p": vec, "rs": vec}

    @app.init
    def init(mesh):
        a, b = make_problem(n, mesh.device)
        return {"A": a, "x": torch.zeros(n, device=mesh.device), "r": b,
                "p": b, "rs": torch.dot(b, b)}

    @app.step
    def step(mesh):
        def cg_iter(state, _step):
            A, x, r, p, rs = (state["A"], state["x"], state["r"],
                              state["p"], state["rs"])
            q = A @ p                              # row-block matvec
            denom = torch.dot(p, q)
            alpha = torch.where(denom.abs() > 1e-30, rs / denom, 0.0)
            x = x + alpha * p
            r = r - alpha * q
            rs_new = torch.dot(r, r)
            beta = torch.where(rs > 1e-30, rs_new / rs, 0.0)
            p = r + beta * p
            new = {"A": A, "x": x, "r": r, "p": p, "rs": rs_new}
            return new, torch.sqrt(rs_new)

        return cg_iter

    return app


app = make_app()


@full_fp32()
def main(device=None, n: int = N):
    """The reference's loop: 40 iterations, 4 -> 8 -> 2 at 10 and 25.
    Returns ``(runner, state, out)``."""
    say = Log()
    params = dmr.set_parameters(2, 8, 4)
    rms = dmr.connect({10: 8, 25: 2})             # expand then shrink
    runner = dmr.MalleableRunner(
        app if n == N else make_app(n), params, rms,
        devices=logical_workers(params.max_procs, device))
    state = runner.init()
    res, residuals = None, []
    for i in range(40):
        state = dmr.reconfig(runner, state, i)
        state, res = runner.step(state, i)
        if i % 5 == 0:
            residuals.append(float(res))
            say(f"iter {i:3d} workers {runner.current}  "
                f"residual {residuals[-1]:.3e}")

    resizes = [(e.step, e.from_procs, e.to_procs) for e in runner.events]
    say(f"resizes: {resizes}")
    out = {"residuals": residuals, "final_residual": float(res)}
    a, b = make_problem(n, runner.mesh.device)
    if n == N:
        x_direct = np.linalg.solve(a.cpu().numpy(), b.cpu().numpy())
        err = float(np.max(np.abs(state["x"].cpu().numpy() - x_direct)))
        say(f"final residual {float(res):.3e}, "
            f"|x - x_direct|_inf = {err:.3e}")
        check(err < 1e-3, f"|x - x_direct|_inf = {err}")
        out["err"] = err
    else:
        rel = relative_residual(a, b, state["x"])
        say(f"final residual {float(res):.3e}, "
            f"|b - A x|_2 / |b|_2 = {rel:.3e} (fp64)")
        check(rel < REL_RESIDUAL_TOL,
              f"relative residual {rel} >= {REL_RESIDUAL_TOL}")
        out["rel_residual"] = rel
    del a, b
    say("OK — CG converged across 4->8->2 resizes")
    out["lines"] = say.lines
    return runner, state, out


if __name__ == "__main__":
    cli(main, n=N)
