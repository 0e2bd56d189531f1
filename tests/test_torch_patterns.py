"""User-defined redistribution patterns (Table 1's custom row) and donated
resizes: the port's ``repro_torch.dmr`` against the JAX package's
``repro.dmr``, on the CPU.

Each parity case runs the same numpy state through both packages'
``redistribute_tree`` and holds the per-pattern keys, ``bytes_moved``,
``n_leaves`` and values equal (the cases of ``tests/test_dmr_api.py`` and
``tests/test_redistribute.py``).  The JAX side passes ``donate=False`` as
its own tests do; the port donates (its default), so each case also shows
that donation changes no number.  The donation cases hold the port to its
contract: a donated source is given up (a read raises, its storage is
freed), ``donate=False`` leaves it as it was, a storage that several
leaves view goes only after all of them moved, a source that a moved leaf
still is stays, no moved leaf has autograd history, and a
``torch.from_numpy`` buffer stays with numpy.  Last, a runner's elastic
losses on ``granite-3-2b-smoke`` are the same donated or not, and equal
the JAX ``MalleableRunner``'s (1e-4, the bound of
``tests/test_torch_train.py``).
"""
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dmr as jdmr
from repro.configs import live_cells as j_live_cells
from repro.core.redistribute import redistribute_state as j_redistribute_state
from repro.core.redistribute import state_bytes as j_state_bytes
from repro_torch import dmr
from repro_torch import tree as T
from repro_torch.configs import get_config, live_cells
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import redistribute as R
from repro_torch.core.lm_app import lm_train_app
from repro_torch.optim import AdamW
from repro_torch.parallel.mesh import logical_workers
from tests.util import run_devices


def _numpy_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"opt": {"mu": rng.standard_normal((16, 4), np.float32),
                    "nu": rng.standard_normal((8,), np.float32)},
            "table": rng.standard_normal((12, 3), np.float32),
            "n": np.int32(3)}


def _both(state, patterns_j, patterns_t, from_procs=4, to_procs=8):
    """The JAX and port ``redistribute_tree`` of one numpy state: each
    returns (values in flatten order, total, {key: (bytes, n_leaves)})."""
    jstate = jax.tree.map(jnp.asarray, state)
    dev = jax.devices()[0]
    sh = jax.tree.map(lambda _: jax.sharding.SingleDeviceSharding(dev),
                      jstate)
    jout, jtot, jper = jdmr.redistribute_tree(
        jstate, sh, patterns=patterns_j, from_procs=from_procs,
        to_procs=to_procs, donate=False)
    tstate = T.tree_map(lambda a: torch.tensor(np.asarray(a)), state)
    tout, ttot, tper = dmr.redistribute_tree(
        tstate, T.tree_map(lambda _: None, tstate), patterns=patterns_t,
        from_procs=from_procs, to_procs=to_procs)

    def summary(vals, tot, per):
        return ([np.asarray(v, dtype=np.float32) for v in vals],
                (tot.bytes_moved, tot.n_leaves),
                {k: (s.bytes_moved, s.n_leaves) for k, s in per.items()})
    return (summary(jax.tree.leaves(jout), jtot, jper),
            summary([t.float().numpy() for t in T.leaves(tout)], ttot,
                    tper))


def _assert_same(j, t):
    (jv, jtot, jper), (tv, ttot, tper) = j, t
    assert tper == jper and ttot == jtot
    assert len(tv) == len(jv)
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# the pattern surface against the JAX package's
# ----------------------------------------------------------------------

def test_registered_family_matches_jax():
    """A family added with ``register_pattern``: the factory gets the text
    after ``name:``, its spec keys the breakdown, and its byte model is
    used; a ``:`` in the name is refused in both packages."""
    def family(base):
        class Scaled(base.Pattern):
            name = "scaled-test"

            def __init__(self, k):
                self.k = k

            def spec(self):
                return f"{self.name}:{self.k}"

            def leaf_bytes(self, leaf, ctx):
                return int(leaf.nbytes) * self.k * ctx.to_procs
        return lambda arg: Scaled(int(arg or 1))

    jdmr.register_pattern("scaled-test", family(jdmr))
    dmr.register_pattern("scaled-test", family(dmr))
    try:
        assert dmr.get_pattern("scaled-test:3").k == 3
        assert dmr.get_pattern("scaled-test").spec() == "scaled-test:1"
        for pkg in (jdmr, dmr):
            with pytest.raises(ValueError, match="must not contain"):
                pkg.register_pattern("a:b", lambda arg: None)
        pats = {"opt/mu": "scaled-test:3", "table": "replicate"}
        j, t = _both(_numpy_state(), pats, pats)
        _assert_same(j, t)
        assert set(t[2]) == {"scaled-test:3", "replicate", "default"}
        assert t[2]["scaled-test:3"] == (16 * 4 * 4 * 3 * 8, 1)
    finally:
        jdmr.PATTERNS.pop("scaled-test", None)
        dmr.PATTERNS.pop("scaled-test", None)


def _halve(leaf, placement, ctx):
    return leaf / 2


def test_callable_names_match_jax():
    """A lambda is ``custom``, a named function ``custom:<name>``, a given
    name wins; its bytes are the resident bytes of what it returned."""
    for fn, name, want in ((lambda l, s, c: l, None, "custom"),
                           (_halve, None, "custom:_halve"),
                           (_halve, "mine", "mine")):
        assert dmr.CallablePattern(fn, name).spec() == \
            jdmr.CallablePattern(fn, name).spec() == want
    assert dmr.get_pattern(_halve).spec() == "custom:_halve"
    # a callable that changes the dtype: bytes follow what it returned
    j, t = _both(_numpy_state(),
                 {"table": lambda l, s, c: l.astype(jnp.bfloat16),
                  "opt/nu": _halve},
                 {"table": lambda l, s, c: l.to(torch.bfloat16),
                  "opt/nu": _halve})
    _assert_same(j, t)
    assert t[2]["custom"] == (12 * 3 * 2, 1)
    assert t[2]["custom:_halve"] == (8 * 4, 1)


def test_colliding_callables_stay_distinct_as_in_jax():
    """Two lambdas, both ``custom``: each moves its own subtree, and the
    breakdown keys them ``custom`` and ``custom#2``."""
    state = {"a": np.ones(4, np.float32), "b": np.ones(4, np.float32)}
    j, t = _both(state,
                 {"a": lambda l, s, c: l * 2, "b": lambda l, s, c: l * 3},
                 {"a": lambda l, s, c: l * 2, "b": lambda l, s, c: l * 3},
                 from_procs=2, to_procs=4)
    _assert_same(j, t)
    assert sorted(t[2]) == ["custom", "custom#2"]
    np.testing.assert_array_equal(t[0][0], 2 * np.ones(4))
    np.testing.assert_array_equal(t[0][1], 3 * np.ones(4))


@pytest.mark.parametrize("patterns", [
    {"opt": "replicate", "opt/nu": "blockcyclic:1", "*": "default"},
    {"opt": "replicate", "opt/mu": "blockcyclic:2", "table": "blockcyclic:3"},
    {"*": "replicate", "opt/nu": "default"},
])
def test_longest_prefix_and_star_match_jax(patterns):
    j, t = _both(_numpy_state(), patterns, patterns, from_procs=2,
                 to_procs=4)
    _assert_same(j, t)


def test_redistribute_state_and_state_bytes_match_jax():
    state = {"a": np.arange(37, dtype=np.float32),
             "b": {"c": np.ones((3, 5), jnp.bfloat16)},
             "n": np.int32(7)}
    jstate = jax.tree.map(jnp.asarray, state)
    dev = jax.devices()[0]
    jmoved, jstats = j_redistribute_state(
        jstate, jax.tree.map(
            lambda _: jax.sharding.SingleDeviceSharding(dev), jstate),
        donate=False)
    tstate = {"a": torch.arange(37, dtype=torch.float32),
              "b": {"c": torch.ones((3, 5), dtype=torch.bfloat16)},
              "n": torch.tensor(7, dtype=torch.int32)}
    want = [t.clone() for t in T.leaves(tstate)]
    assert R.state_bytes(tstate) == j_state_bytes(jstate) == 37 * 4 + 30 + 4
    moved, stats = R.redistribute_state(tstate, T.tree_map(lambda _: None,
                                                           tstate))
    assert (stats.bytes_moved, stats.n_leaves) == \
        (jstats.bytes_moved, jstats.n_leaves) == (R.state_bytes(moved), 3)
    for a, b, c in zip(T.leaves(moved), want, jax.tree.leaves(jmoved)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(c).astype(np.float32))
    assert all(t.is_meta for t in T.leaves(tstate))       # donated
    assert R.RedistributeFn is not None


def test_live_cells_match_jax():
    """The same (arch, shape, ok, why) cells; the port lists its archs in
    its own registry's order."""
    cells = live_cells()
    assert sorted(cells) == sorted(j_live_cells())
    assert len(cells) == 40 and sum(c[2] for c in cells) == 33


# ----------------------------------------------------------------------
# donation
# ----------------------------------------------------------------------

def _placements(state):
    return T.tree_map(lambda _: None, state)


def test_donated_source_is_released_and_values_are_bit_equal():
    a = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    state = {"a": a, "b": a[:8].clone()}
    want = {k: v.clone() for k, v in state.items()}
    freed = weakref.ref(a.untyped_storage())
    out, tot, per = dmr.redistribute_tree(state, _placements(state),
                                          from_procs=4, to_procs=8)
    for k in state:
        assert torch.equal(out[k], want[k])
        assert out[k].untyped_storage().data_ptr() != 0
    assert a.is_meta and state["b"].is_meta
    assert freed() is None                  # nothing holds the storage
    with pytest.raises((RuntimeError, NotImplementedError)):
        a.sum().item()
    with pytest.raises((RuntimeError, NotImplementedError)):
        a.cpu()
    assert tot.bytes_moved == (64 + 8) * 32 * 4 and set(per) == {"default"}


def test_donate_false_leaves_the_source_intact():
    a = torch.arange(12.0).reshape(3, 4)
    ptr = a.untyped_storage().data_ptr()
    out, tot, _ = dmr.redistribute_tree({"a": a}, {"a": None},
                                        donate=False)
    assert not a.is_meta and a.untyped_storage().data_ptr() == ptr
    assert torch.equal(a, torch.arange(12.0).reshape(3, 4))
    assert torch.equal(out["a"], a) and out["a"].data_ptr() != ptr
    assert tot.bytes_moved == 48


def test_a_shared_storage_goes_after_every_leaf_that_views_it():
    """Two views of one storage and its base, all leaves: the storage is
    released only once the last of them has moved (the callable that moves
    ``b`` after ``a`` still reads ``a``'s source), views before base."""
    base = torch.arange(32.0).reshape(8, 4)
    state = {"a": base[:4], "b": base[4:], "whole": base}
    want = {k: v.clone() for k, v in state.items()}
    freed = weakref.ref(base.untyped_storage())
    seen = {}

    def check(leaf, placement, ctx):
        seen["a_alive"] = not state["a"].is_meta
        seen["a_value"] = state["a"].clone()
        return leaf.clone()

    del base
    out, tot, per = dmr.redistribute_tree(
        state, _placements(state), patterns={"b": check})
    assert seen["a_alive"] and torch.equal(seen["a_value"], want["a"])
    for k in want:
        assert torch.equal(out[k], want[k])
        assert state[k].is_meta
    assert freed() is None
    assert per["custom:check"].bytes_moved == 64 and tot.n_leaves == 3


def test_replicate_and_identity_keep_the_storage_they_return():
    p, q, r = torch.ones(4), torch.full((3,), 2.0), torch.zeros(2)
    v = torch.arange(6.0)
    state = {"p": p, "q": q, "r": r, "v": v}
    out, _, per = dmr.redistribute_tree(
        state, _placements(state),
        patterns={"p": "replicate", "q": lambda l, s, c: l,
                  "v": _as_view},
        from_procs=2, to_procs=4)
    assert out["p"] is p and out["q"] is q
    assert out["v"] is not v and out["v"].data_ptr() == v.data_ptr()
    assert not p.is_meta and not q.is_meta and not v.is_meta
    assert r.is_meta
    assert torch.equal(out["p"], torch.ones(4))
    assert torch.equal(out["q"], torch.full((3,), 2.0))
    assert torch.equal(out["v"], torch.arange(6.0))
    assert per["replicate"].bytes_moved == 4 * 4 * 4
    assert per["custom"].bytes_moved == 12
    assert per["custom:_as_view"].bytes_moved == 24


def _as_view(leaf, placement, ctx):
    return leaf.view(2, 3).view(6)


@pytest.mark.parametrize("donate", [True, False])
def test_no_moved_leaf_has_autograd_history(donate):
    w = torch.randn(5, 3, requires_grad=True)
    v = w * 1.0                              # a leaf with a grad_fn
    c = torch.randn(2)
    state = {"w": w, "v": v, "c": c, "f": torch.randn(4,
                                                      requires_grad=True)}
    want = {k: t.detach().clone() for k, t in state.items()}
    out, _, _ = dmr.redistribute_tree(
        state, _placements(state),
        patterns={"f": lambda l, s, ctx: l * 2, "v": "replicate"},
        donate=donate)
    for k, t in out.items():
        assert t.grad_fn is None, k
        assert t.is_leaf, k
    assert out["w"].requires_grad and out["v"].requires_grad
    assert out["f"].requires_grad and not out["c"].requires_grad
    assert torch.equal(out["w"], want["w"]) and torch.equal(out["v"],
                                                            want["v"])
    assert torch.equal(out["f"], 2 * want["f"])
    assert w.is_meta == donate and c.is_meta == donate


def test_a_from_numpy_leaf_keeps_its_buffer():
    arr = np.arange(6, dtype=np.float32)
    t = torch.from_numpy(arr)
    out, tot, _ = dmr.redistribute_tree({"t": t}, {"t": None})
    assert t.is_meta                              # the tensor is given up
    np.testing.assert_array_equal(arr, np.arange(6, dtype=np.float32))
    arr += 1                                      # the caller's, still
    assert torch.equal(out["t"], torch.arange(6, dtype=torch.float32))
    assert tot.bytes_moved == 24


def test_a_pattern_that_cannot_move_a_leaf_raises():
    state = {"a": torch.ones(3)}
    with pytest.raises(TypeError, match="moved a"):
        dmr.redistribute_tree(state, _placements(state),
                              patterns={"a": lambda l, s, c: None})


def test_donating_a_leaf_held_elsewhere_raises():
    """A weak reference to a leaf (something outside the state watching
    it) stops the donation loudly; nothing turns it off."""
    a = torch.ones(3)
    keep = weakref.ref(a)
    with pytest.raises(RuntimeError, match="cannot donate"):
        dmr.redistribute_tree({"a": a}, {"a": None})
    assert keep() is a
    out, _, _ = dmr.redistribute_tree({"a": a}, {"a": None}, donate=False)
    assert torch.equal(out["a"], torch.ones(3))


# ----------------------------------------------------------------------
# a runner's elastic run, donated or not, against the JAX runner's
# ----------------------------------------------------------------------

ARCH = "granite-3-2b-smoke"
SHAPE = ShapeConfig("t", "train", 64, 8)
SCHEDULE = {2: 8, 4: 2}
STEPS = 6

SCRIPT = """
import json
import jax, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.core.lm_app import lm_train_app
from repro.dmr import MalleabilityParams, MalleableRunner, ScriptedRMS
from repro.optim import AdamW

app = lm_train_app(get_config(ARCH), ShapeConfig("t", "train", 64, 8),
                   AdamW(learning_rate=1e-3), seed=0)
r = MalleableRunner(app, MalleabilityParams(2, 8, 4), ScriptedRMS(SCHEDULE))
s = r.init()
leaves = jax.tree.leaves(s)
out = {"state": [np.asarray(l).tolist() for l in leaves],
       "dtypes": [str(np.asarray(l).dtype) for l in leaves]}
losses = []
for i in range(STEPS):
    s = r.maybe_reconfig(s, i)
    s, m = r.step(s, i)
    losses.append(float(m["loss"]))
out["losses"] = losses
out["events"] = [(e.action, e.from_procs, e.to_procs, e.transfer.bytes_moved)
                 for e in r.events]
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_run():
    script = SCRIPT.replace("ARCH", repr(ARCH)).replace(
        "SCHEDULE", repr(SCHEDULE)).replace("STEPS", repr(STEPS))
    return json.loads(run_devices(script, n_devices=8, timeout=500)
                      .split("JSON", 1)[1])


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def _runner_losses(state0, redistribute=None):
    """Six elastic steps from a copy of ``state0``; per resize, whether
    the state it replaced was given up."""
    cfg = get_config(ARCH)
    app = lm_train_app(cfg, SHAPE, AdamW(learning_rate=1e-3), seed=0)
    app.init(lambda mesh: T.tree_map(torch.clone, state0))
    runner = dmr.MalleableRunner(app, dmr.MalleabilityParams(2, 8, 4),
                                 dmr.ScriptedRMS(dict(SCHEDULE)),
                                 devices=logical_workers(8, "cpu"),
                                 redistribute=redistribute)
    state, losses, given_up = runner.init(), [], []
    for i in range(STEPS):
        before = state
        state = dmr.reconfig(runner, state, i)
        if state is not before:
            given_up.append(all(t.is_meta for t in T.leaves(before)))
        del before
        state, m = runner.step(state, i)
        losses.append(float(m["loss"]))
    return runner, losses, given_up


def test_runner_losses_donated_equal_undonated_and_jax(jax_run,
                                                       deterministic):
    from repro_torch.models.train import init_state
    like = init_state(get_config(ARCH), AdamW(learning_rate=1e-3), 0)
    state0 = T.unflatten(like, [
        torch.from_numpy(np.asarray(a, dtype=dt))
        for a, dt in zip(jax_run["state"], jax_run["dtypes"])])

    def undonated(state, placements):
        moved, stats, _ = dmr.redistribute_tree(state, placements,
                                                donate=False)
        return moved, stats

    runner, donated, gone = _runner_losses(state0)
    runner_k, kept, gone_k = _runner_losses(state0, undonated)
    assert gone == [True, True] and gone_k == [False, False]
    assert donated == kept
    np.testing.assert_allclose(donated, jax_run["losses"], atol=1e-4, rtol=0)
    assert [(e.action, e.from_procs, e.to_procs, e.transfer.bytes_moved)
            for e in runner.events] == \
        [tuple(e) for e in jax_run["events"]] == \
        [(e.action, e.from_procs, e.to_procs, e.transfer.bytes_moved)
         for e in runner_k.events]
    assert all(not t.is_meta for t in T.leaves(state0))
