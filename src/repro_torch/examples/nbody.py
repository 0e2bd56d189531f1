"""Malleable N-body (paper §4.3) — the "MPI_PARTICLE" state, on the port
(``examples/nbody.py`` in the JAX package).

The paper builds an MPI datatype of two 3-vectors (position, velocity) plus
mass and weight; here the particle set is a tree of tensors (pos and vel
``(N, 3)`` split by rows, mass and weight ``(N,)`` split) redistributed
with the default 1-D pattern on every resize.  Energy drift is checked
across resizes to show the state handoff is exact.  The step keeps the
reference's arithmetic order: ``diff``, ``r2 + EPS**2``, ``r2 ** -1.5``,
the sum over the second particle axis.

    python -m repro_torch.examples.nbody [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import dmr
from repro_torch.examples import Log, check, cli
from repro_torch.parallel.mesh import Placement, logical_workers

N = 2048
DT = 1e-3
EPS = 1e-2


def init_particles():
    rng = np.random.default_rng(2)
    return {
        "pos": rng.standard_normal((N, 3)).astype(np.float32),
        "vel": (rng.standard_normal((N, 3)) * 0.01).astype(np.float32),
        "mass": np.abs(rng.standard_normal(N)).astype(np.float32) + 0.5,
        "weight": np.ones(N, np.float32),
    }


def energy(p):
    """Kinetic plus potential energy of a particle set of numpy arrays."""
    ke = 0.5 * np.sum(p["mass"] * np.sum(np.asarray(p["vel"]) ** 2, -1))
    pos = np.asarray(p["pos"])
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1) + EPS
    np.fill_diagonal(d, np.inf)
    pe = -0.5 * np.sum(p["mass"][:, None] * p["mass"][None, :] / d)
    return ke + pe


def to_numpy(state):
    return {k: v.cpu().numpy() for k, v in state.items()}


app = dmr.App(name="nbody")


@app.shardings
def shardings(mesh):
    part = Placement(mesh, ("data",))
    part2 = Placement(mesh, ("data", None))
    return {"pos": part2, "vel": part2, "mass": part, "weight": part}


@app.init
def init(mesh):
    return {k: torch.from_numpy(v).to(mesh.device)
            for k, v in init_particles().items()}


@app.step
def step(mesh):
    def step_fn(state, _):
        pos, vel, mass = state["pos"], state["vel"], state["mass"]
        diff = pos[:, None, :] - pos[None, :, :]
        r2 = torch.sum(diff * diff, -1) + EPS ** 2
        inv_r3 = r2 ** -1.5
        acc = -torch.sum(diff * (mass[None, :, None] * inv_r3[..., None]),
                         dim=1)
        vel2 = vel + DT * acc
        return dict(state, pos=pos + DT * vel2, vel=vel2), pos.new_zeros(())

    return step_fn


def main(device=None):
    """The reference's loop: 20 steps, 4 -> 8 -> 1 at 5 and 12.
    Returns ``(runner, state, out)``."""
    say = Log()
    params = dmr.set_parameters(1, 8, 4)
    runner = dmr.MalleableRunner(
        app, params, dmr.connect({5: 8, 12: 1}),
        devices=logical_workers(params.max_procs, device))
    state = runner.init()
    e0 = energy(to_numpy(state))
    for i in range(20):
        state = dmr.reconfig(runner, state, i)
        state, _ = runner.step(state, i)
    e1 = energy(to_numpy(state))
    drift = abs(e1 - e0) / abs(e0)
    say(f"energy {e0:.4f} -> {e1:.4f} (drift {drift:.2%}) across resizes "
        f"{[(e.step, e.from_procs, e.to_procs) for e in runner.events]}")
    check(drift < 0.05, f"energy drift {drift}")
    say("OK — N-body stable across 4->8->1 resizes")
    return runner, state, {"e0": float(e0), "e1": float(e1),
                           "drift": float(drift), "lines": say.lines}


if __name__ == "__main__":
    cli(main)
