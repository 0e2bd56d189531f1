"""Elastic training across worker counts that change the computation, the
port against the JAX package, on the CPU: six ``lm_train_app`` steps
under each package's ``MalleableRunner`` on the same schedule.

* ``qwen3-moe-235b-a22b-smoke`` 1 -> 4 -> 2 workers: at 4 and 2 each shard
  routes its own tokens (EP: 4 experts over 4 and 2 ``model`` workers), so
  the losses depend on the worker count, in both packages alike;
* ``qwen2.5-32b-smoke`` 4 -> 8: at 8 its 4 heads do not split over 8
  ``model`` workers and attention takes the sequence path.

The JAX side runs in one child interpreter on 8 host devices; the port
starts from the JAX runner's initial state (``train_state_from_numpy``)
and steps on its own data pipeline (equal batches).  Losses within 1e-5
(fp32).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import dmr
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.lm_app import lm_train_app
from repro_torch.interop import train_state_from_numpy
from repro_torch.optim import AdamW
from repro_torch.parallel.mesh import logical_workers
from tests.util import run_devices

SHAPE = ShapeConfig("t", "train", 64, 8)
#: case -> (arch, MalleabilityParams, schedule)
CASES = {"qwen3moe-EP": ("qwen3-moe-235b-a22b-smoke", (1, 8, 1),
                         {2: 4, 4: 2}),
         "qwen2.5-seq": ("qwen2.5-32b-smoke", (2, 8, 4), {3: 8})}
STEPS = 6

SCRIPT = r"""
import warnings; warnings.filterwarnings("ignore")
import json
import jax, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.core.lm_app import lm_train_app
from repro.dmr import MalleabilityParams, MalleableRunner, ScriptedRMS
from repro.optim import AdamW

out = {}
for case, (arch, params, schedule) in CASES.items():
    app = lm_train_app(get_config(arch), ShapeConfig("t", "train", 64, 8),
                       AdamW(learning_rate=1e-3), seed=0)
    r = MalleableRunner(app, MalleabilityParams(*params),
                        ScriptedRMS({int(k): v for k, v in schedule.items()}))
    s = r.init()
    leaves = jax.tree.leaves(s)
    state = [np.asarray(l).tolist() for l in leaves]
    dtypes = [str(np.asarray(l).dtype) for l in leaves]
    losses = []
    for i in range(STEPS):
        s = r.maybe_reconfig(s, i)
        s, m = r.step(s, i)
        losses.append(float(m["loss"]))
    out[case] = {"losses": losses, "state": state, "dtypes": dtypes,
                 "sizes": [e.to_procs for e in r.events]}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_out():
    script = SCRIPT.replace("CASES.items()", repr(CASES) + ".items()") \
        .replace("STEPS", repr(STEPS))
    out = run_devices(script, n_devices=8, timeout=500)
    return json.loads(out.split("JSON", 1)[1])


def _jax_state(cfg, rec):
    """The JAX runner's initial state, rebuilt on the port's tree."""
    from repro_torch import tree as T
    from repro_torch.models.train import init_state
    like = init_state(cfg, AdamW(learning_rate=1e-3), 0)
    leaves = [torch.from_numpy(np.asarray(a, dtype=dt)) for a, dt in
              zip(rec["state"], rec["dtypes"])]
    assert [tuple(t.shape) for t in leaves] == \
        [tuple(t.shape) for t in T.leaves(like)]
    return T.unflatten(like, leaves)


@pytest.mark.parametrize("case", list(CASES))
def test_elastic_losses_follow_jax_across_worker_counts(jax_out, case):
    arch, params, schedule = CASES[case]
    cfg = get_config(arch)
    rec = jax_out[case]
    state0 = _jax_state(cfg, rec)
    app = lm_train_app(cfg, SHAPE, AdamW(learning_rate=1e-3), seed=0)
    app.init(lambda mesh: state0)
    runner = dmr.MalleableRunner(app, dmr.MalleabilityParams(*params),
                                 dmr.ScriptedRMS(dict(schedule)),
                                 devices=logical_workers(8, "cpu"))
    state, losses = runner.init(), []
    for i in range(STEPS):
        state = dmr.reconfig(runner, state, i)
        state, m = runner.step(state, i)
        losses.append(float(m["loss"]))
    assert [e.to_procs for e in runner.events] == rec["sizes"] == \
        list(schedule.values())
    np.testing.assert_allclose(losses, rec["losses"], atol=1e-5, rtol=0)


def test_moe_losses_depend_on_the_worker_count(jax_out):
    """The EP run's losses after its first resize differ from a static
    run's at one worker by more than the bound above, in JAX: what the
    port now follows (its global formulation alone would equal the
    static run)."""
    arch, params, _ = CASES["qwen3moe-EP"]
    cfg = get_config(arch)
    rec = jax_out["qwen3moe-EP"]
    state0 = _jax_state(cfg, rec)
    app = lm_train_app(cfg, SHAPE, AdamW(learning_rate=1e-3), seed=0)
    app.init(lambda mesh: state0)
    runner = dmr.MalleableRunner(app, dmr.MalleabilityParams(*params),
                                 dmr.ScriptedRMS({}),
                                 devices=logical_workers(8, "cpu"))
    state, static = runner.init(), []
    for i in range(STEPS):
        state, m = runner.step(state, i)
        static.append(float(m["loss"]))
    np.testing.assert_allclose(static[:2], rec["losses"][:2], atol=1e-5,
                               rtol=0)
    assert max(abs(a - b) for a, b in zip(static[2:], rec["losses"][2:])) \
        > 1e-5
