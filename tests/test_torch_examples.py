"""The port's §4.3 applications (``repro_torch.examples``) against the JAX
package's ``examples/``, on the CPU.

The JAX side runs in one child interpreter on 8 host devices
(``tests/util.run_devices``): it loads each of the four JAX examples with
``runpy.run_path`` under a name other than ``__main__`` (so its ``main()``
does not run) and repeats that ``main()``'s loop with the example's own
app, parameters and schedule, since the reference's ``main()`` returns
nothing.  The port side is each example's ``main(device="cpu")``.

Exact on both sides: the resize events ``(step, action, from, to,
bytes_moved, {pattern: bytes_moved})`` and the aligner's counters.  CG and
Jacobi: x within 1e-6 (measured 2.3e-9 and 2.2e-8).  N-body: one step from
the same state, velocities within 1e-4 relative; the 20-step run's energy
within 1e-5 relative (measured 4.3e-7) and positions within 5e-3
(measured 6.9e-4).  Its velocities are not compared element by element
after 20 steps: the 1e-2 softening lets close encounters amplify rounding
(0.20 of 29 between the two packages, with no fault in either).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import dmr
from repro_torch import tree as T
from repro_torch.examples import (aligner_pipeline, cg_solver, cli, jacobi,
                                  nbody, quickstart)
from repro_torch.parallel.mesh import logical_workers, make_job_mesh
from tests.util import REPO, run_devices

EXAMPLES = {"cg_solver": cg_solver, "jacobi": jacobi, "nbody": nbody,
            "aligner_pipeline": aligner_pipeline}
ALL = dict(EXAMPLES, quickstart=quickstart)
X_TOL = 1e-6
NBODY_STEP_VEL_RTOL = 1e-4
NBODY_ENERGY_RTOL = 1e-5
NBODY_POS_ATOL = 5e-3

JAX_SCRIPT = r"""
import json, runpy
import numpy as np

EX, OUT = {ex!r}, {out!r}


def load(name):
    return runpy.run_path(f"{{EX}}/{{name}}.py", run_name=f"ref_{{name}}")


def events(runner):
    return [(e.step, e.action, e.from_procs, e.to_procs,
             e.transfer.bytes_moved,
             {{k: v.bytes_moved for k, v in e.per_pattern.items()}})
            for e in runner.events]


def runner_for(g, params, schedule):
    dmr = g["dmr"]
    return dmr, dmr.MalleableRunner(g["app"], dmr.set_parameters(*params),
                                    dmr.connect(schedule))


ev, arrays, scalars = {{}}, {{}}, {{}}
g = load("cg_solver")
dmr, runner = runner_for(g, (2, 8, 4), {{10: 8, 25: 2}})
state = runner.init()
for i in range(40):
    state = dmr.reconfig(runner, state, i)
    state, res = runner.step(state, i)
ev["cg_solver"], arrays["cg_solver_x"] = events(runner), np.asarray(state["x"])

g = load("jacobi")
dmr, runner = runner_for(g, (2, 8, 4), {{8: 8, 20: 2}})
state = runner.init()
for i in range(60):
    state = dmr.reconfig(runner, state, i)
    state, delta = runner.step(state, i)
ev["jacobi"], arrays["jacobi_x"] = events(runner), np.asarray(state["x"])

g = load("nbody")
dmr, runner = runner_for(g, (1, 8, 4), {{5: 8, 12: 1}})
state = runner.init()
one, _ = g["app"].make_step(runner.mesh)(state, 0)
arrays["nbody_vel1"] = np.asarray(one["vel"])
for i in range(20):
    state = dmr.reconfig(runner, state, i)
    state, _ = runner.step(state, i)
ev["nbody"] = events(runner)
arrays["nbody_pos"] = np.asarray(state["pos"])
scalars["nbody_e1"] = float(g["energy"]({{k: np.asarray(v)
                                          for k, v in state.items()}}))

g = load("aligner_pipeline")
dmr, runner = runner_for(g, (3, 8, 6), {{2: 8, 4: 3}})
state = runner.init()
i = 0
while int(np.asarray(state["cursor"])) < g["TOTAL_CHUNKS"]:
    state = dmr.reconfig(runner, state, i)
    state, done = runner.step(state, i)
    i += 1
ev["aligner_pipeline"] = events(runner)
scalars.update({{f"aligner_{{k}}": int(np.asarray(state[k]))
                for k in ("cursor", "matched", "total")}})

np.savez(f"{{OUT}}/arrays.npz", **arrays)
with open(f"{{OUT}}/events.json", "w") as fh:
    json.dump({{"events": ev, "scalars": scalars}}, fh)
print("DONE")
"""


def _events(runner):
    """The events as the JAX side writes them (through JSON)."""
    return json.loads(json.dumps(
        [(e.step, e.action, e.from_procs, e.to_procs, e.transfer.bytes_moved,
          {k: v.bytes_moved for k, v in e.per_pattern.items()})
         for e in runner.events]))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX examples' events, final states and counters."""
    out = tmp_path_factory.mktemp("jax_examples")
    script = JAX_SCRIPT.format(ex=os.path.join(REPO, "examples"),
                               out=str(out))
    assert "DONE" in run_devices(script, n_devices=8, timeout=300)
    with open(out / "events.json") as fh:
        data = json.load(fh)
    data["arrays"] = dict(np.load(out / "arrays.npz"))
    return data


@pytest.fixture(scope="module")
def port():
    """Each port example's ``main(device="cpu")``: (runner, state, out)."""
    return {name: mod.main(device="cpu") for name, mod in ALL.items()}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_resize_events_equal_jax(ref, port, name):
    """Steps, actions, sizes and bytes moved, per pattern, exactly."""
    assert _events(port[name][0]) == ref["events"][name]
    assert port[name][0].events, name


@pytest.mark.parametrize("name", ["cg_solver", "jacobi"])
def test_solver_x_matches_jax(ref, port, name):
    x = port[name][1]["x"].numpy()
    np.testing.assert_allclose(x, ref["arrays"][f"{name}_x"], rtol=0,
                               atol=X_TOL)


def test_nbody_one_step_matches_jax(ref):
    """One step from the initial state on 4 workers: velocities within
    1e-4 of JAX's largest."""
    mesh = make_job_mesh(logical_workers(4, "cpu"))
    state = nbody.app.init_state(mesh)
    one, _ = nbody.app.make_step(mesh)(state, 0)
    want = ref["arrays"]["nbody_vel1"]
    err = np.max(np.abs(one["vel"].numpy() - want)) / np.max(np.abs(want))
    assert err < NBODY_STEP_VEL_RTOL, err


def test_nbody_run_matches_jax(ref, port):
    """The 20-step run across 4 -> 8 -> 1: energy and positions."""
    _, state, out = port["nbody"]
    e_ref = ref["scalars"]["nbody_e1"]
    assert abs(out["e1"] - e_ref) / abs(e_ref) < NBODY_ENERGY_RTOL
    np.testing.assert_allclose(state["pos"].numpy(), ref["arrays"]["nbody_pos"],
                               rtol=0, atol=NBODY_POS_ATOL)


def test_aligner_counters_equal_jax(ref, port):
    _, state, out = port["aligner_pipeline"]
    got = {k: int(state[k]) for k in ("cursor", "matched", "total")}
    want = {k: ref["scalars"][f"aligner_{k}"] for k in got}
    assert got == want
    assert state["cursor"].dtype == torch.int32 and state["cursor"].dim() == 0
    assert out["matched"] == want["matched"]


@pytest.mark.parametrize("name", sorted(ALL))
def test_example_checks_and_ok_line(port, name):
    """Each example's own check passed and it printed its ``OK`` line."""
    runner, state, out = port[name]
    assert out["lines"][-1].startswith("OK"), out["lines"][-3:]
    assert all(t.device.type == "cpu" for t in T.leaves(state))


def test_quickstart_makes_two_resizes(port):
    runner, _, out = port["quickstart"]
    assert [(e.step, e.action, e.from_procs, e.to_procs)
            for e in runner.events] == [(4, "expand", 4, 8),
                                        (10, "shrink", 8, 2)]
    assert runner.current == 2 and len(out["losses"]) == 14
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]


@pytest.mark.parametrize("name", sorted(ALL))
def test_main_without_a_device_needs_a_card(monkeypatch, name):
    """``main()`` runs on ``cuda`` unless told otherwise: with no card it
    raises, and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ALL[name].main()


def test_cg_at_another_size_meets_its_residual_check():
    """At n = 256 the problem comes from a seeded torch generator and the
    check is the fp64 relative residual."""
    runner, state, out = cg_solver.main(device="cpu", n=256)
    assert out["rel_residual"] < cg_solver.REL_RESIDUAL_TOL
    assert state["A"].shape == (256, 256)
    a, b = cg_solver.make_problem(256)
    torch.testing.assert_close(a, a.T, rtol=0, atol=1e-3)
    assert torch.equal(state["A"], a)
    assert [(e.from_procs, e.to_procs) for e in runner.events] == \
        [(4, 8), (8, 2)]


class DropLastRowBlock(dmr.DefaultPattern):
    """A faulty move: the new layout's last row block arrives as zeros."""

    def move(self, leaf, placement, ctx):
        out = leaf.clone()
        out[-(leaf.shape[0] // ctx.to_procs):] = 0
        return out


def test_cg_check_catches_a_lost_row_block(monkeypatch):
    """A resize that loses one row block of x fails the example's check.
    (CG has converged before the first resize at step 10, so p and r are
    ~0 and a lost block of A would move nothing; x keeps the loss, since
    the recurrence's residual never reads it.)  The fault is planted in
    the apps ``main()`` builds: the module's ``app`` at the reference's
    size, ``make_app(n)``'s at another."""
    faulty = {"x": DropLastRowBlock()}
    make_app = cg_solver.make_app

    def faulty_app(n):
        app = make_app(n)
        app.patterns = faulty
        return app

    monkeypatch.setattr(cg_solver.app, "patterns", faulty)
    monkeypatch.setattr(cg_solver, "make_app", faulty_app)
    with pytest.raises(AssertionError, match="x_direct"):
        cg_solver.main(device="cpu")
    with pytest.raises(AssertionError, match="relative residual"):
        cg_solver.main(device="cpu", n=256)


@pytest.mark.parametrize("name", ["cg_solver", "jacobi"])
def test_solver_main_states_full_fp32_and_restores_it(monkeypatch, name):
    """CG's and Jacobi's ``main()`` run with TF32 off (seen where they
    build their problem, inside the run) and leave the caller's setting
    as it was."""
    mod, seen = EXAMPLES[name], []
    make_problem = mod.make_problem

    def watched(*args, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return make_problem(*args, **kw)

    monkeypatch.setattr(mod, "make_problem", watched)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    mod.main(device="cpu")
    assert seen and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_cli_runs_an_example(capsys):
    cli(cg_solver.main, ["--device", "cpu", "--n", "128"], n=cg_solver.N)
    out = capsys.readouterr().out
    assert "resizes: [(10, 4, 8), (25, 8, 2)]" in out
    assert out.rstrip().endswith("OK — CG converged across 4->8->2 resizes")

