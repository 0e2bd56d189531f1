"""The port's training slice (the paper's Listing 2) against the JAX
package's, on the CPU.

``granite-3-2b-smoke`` in fp32, its state initialised in JAX and carried
over leaf for leaf (``interop.train_state_from_numpy``), the same numpy
batches fed to both.  Bounds: the data pipeline and checkpoints are exact;
one AdamW update 1e-6 (both in fp32, elementwise); the step-0 loss 1e-6
relative and its gradients ``atol=1e-6, rtol=1e-4`` (fp32 through two
layers, summation orders differ); six training steps 1e-4 in loss, the
bound of ``tests/test_elastic.py``.  The port's elastic run must equal its
own static run exactly, under PyTorch's deterministic kernels (a resize
copies leaves; the arithmetic does not depend on the worker count).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_state as j_restore
from repro.checkpoint import save_state as j_save
from repro.configs import get_config as j_get_config
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import train as JT
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as j_cosine
from repro.parallel import sharding as JS
from repro_torch import dmr
from repro_torch import tree as T
from repro_torch.checkpoint import restore_state, save_state
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.lm_app import lm_train_app
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.models import train as TT
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel import sharding as S
from repro_torch.parallel.mesh import (Placement, factor_mesh, logical_workers,
                                       make_job_mesh)

ARCH = "granite-3-2b-smoke"
SHAPE = ShapeConfig("t", "train", 64, 8)        # tests/test_elastic.py's
STEPS = 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(seed=0):
    cfg = j_get_config(ARCH)
    return cfg, JT.init_state(cfg, JAdamW(learning_rate=1e-3), seed)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("cursor", [0, 8, 37, 1000])
def test_batch_at_matches_jax(cursor):
    cfg = get_config(ARCH)
    got = SyntheticDataset(cfg, SHAPE, seed=3).batch_at(cursor)
    exp = JDataset(j_get_config(ARCH), SHAPE, seed=3).batch_at(cursor)
    assert got.keys() == exp.keys()
    for k in exp:
        assert got[k].dtype == exp[k].dtype
        np.testing.assert_array_equal(got[k], exp[k])


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_update_matches_jax(schedule):
    """One update from a state with live moments (count 4), on the same
    gradients, clipped (their norm is above clip_norm)."""
    _, jstate = _jax_state()
    rng = np.random.default_rng(0)
    params = _np(jstate.params)
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    mu = jax.tree.map(lambda p: 0.01 * rng.standard_normal(p.shape).astype(
        np.float32), params)
    nu = jax.tree.map(lambda p: 0.01 * np.abs(rng.standard_normal(
        p.shape)).astype(np.float32), params)
    lr_j = j_cosine(1e-3, 3, 10) if schedule else 1e-3
    lr_t = cosine_schedule(1e-3, 3, 10) if schedule else 1e-3
    jopt = JAdamW(learning_rate=lr_j)
    jp, jo, jn = jopt.update(
        jax.tree.map(jnp.asarray, grads),
        jstate.opt._replace(mu=jax.tree.map(jnp.asarray, mu),
                            nu=jax.tree.map(jnp.asarray, nu),
                            count=jnp.asarray(4, jnp.int32)),
        jax.tree.map(jnp.asarray, params))
    topt = AdamW(learning_rate=lr_t)
    tstate = topt.init(params_from_numpy(params))._replace(
        mu=params_from_numpy(mu), nu=params_from_numpy(nu),
        count=torch.tensor(4, dtype=torch.int32))
    tp, to, tn = topt.update(params_from_numpy(grads), tstate,
                             params_from_numpy(params))
    assert float(jn) > 1.0                       # the clip is exercised
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert int(to.count) == int(jo.count) == 5
    for a, b in zip(T.leaves(tp) + T.leaves(to.mu) + T.leaves(to.nu),
                    jax.tree.leaves((jp, jo.mu, jo.nu))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


def test_step0_loss_and_grads_match_jax():
    jcfg, jstate = _jax_state()
    cfg = get_config(ARCH)
    batch = JDataset(jcfg, SHAPE).batch_at(0)
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jbatch), has_aux=True)(jstate.params)
    state = train_state_from_numpy(_np(jstate))
    loss, _, grads = TT._value_and_grad(state.params, cfg,
                                        _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    for (path, g), e in zip(T.flatten(T.unflatten(state.params, list(grads))),
                            jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-6,
                                   rtol=1e-4, err_msg=path)


def test_training_steps_match_jax():
    """Six AdamW steps from JAX's initial state on the same batches."""
    jcfg, jstate = _jax_state()
    cfg = get_config(ARCH)
    ds = JDataset(jcfg, SHAPE)
    jstep = jax.jit(JT.make_train_step(jcfg, JAdamW(learning_rate=1e-3)))
    tstep = TT.make_train_step(cfg, AdamW(learning_rate=1e-3))
    state = train_state_from_numpy(_np(jstate))
    jl, tl = [], []
    for i in range(STEPS):
        batch = ds.batch_at(i * ds.global_batch)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = tstep(state, _torch_batch(batch))
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert tl[-1] < tl[0]
    assert int(state.step) == STEPS
    assert int(state.data_cursor) == STEPS * SHAPE.global_batch
    np.testing.assert_array_equal(state.rng.numpy(), np.asarray(jstate.rng))


def test_microbatch_accumulation_matches_jax():
    """train_microbatches = 2: gradients summed over two half batches in
    opt_moment_dtype and averaged, losses averaged, as the reference."""
    import dataclasses
    jcfg0, jstate = _jax_state()
    jcfg = dataclasses.replace(jcfg0, train_microbatches=2)
    cfg = dataclasses.replace(get_config(ARCH), train_microbatches=2)
    ds = JDataset(jcfg, SHAPE)
    jstep = jax.jit(JT.make_train_step(jcfg, JAdamW(learning_rate=1e-3)))
    tstep = TT.make_train_step(cfg, AdamW(learning_rate=1e-3))
    state = train_state_from_numpy(_np(jstate))
    for i in range(3):
        batch = ds.batch_at(i * ds.global_batch)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = tstep(state, _torch_batch(batch))
        for k in ("loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-4,
                                       rtol=0, err_msg=f"step {i} {k}")
    assert int(state.data_cursor) == 3 * SHAPE.global_batch


def test_remat_changes_no_number(deterministic):
    """Activation checkpointing of every layer (``cfg.remat``, which
    granite-3-2b sets) recomputes the same operations: loss and gradients
    equal the plain run's bit for bit."""
    import dataclasses
    _, jstate = _jax_state()
    batch = _torch_batch(JDataset(j_get_config(ARCH), SHAPE).batch_at(0))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(get_config(ARCH), remat=remat)
        state = train_state_from_numpy(_np(jstate))
        out.append(TT._value_and_grad(state.params, cfg, batch))
    (l0, _, g0), (l1, _, g1) = out
    assert float(l0) == float(l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_chunked_ce_matches_jax():
    """Four checkpointed CE chunks of 16 positions: the sum and its
    gradients (hidden states and the tied embedding) against the JAX
    package's ``chunked_ce`` at the same chunk; logz over the padded
    vocab in both."""
    jcfg, jstate = _jax_state()
    cfg = get_config(ARCH)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    mask = (rng.random((2, 64)) < 0.8).astype(np.float32)
    emb = _np(jstate.params["embed"])
    (jv, jg) = jax.value_and_grad(
        lambda e, x_: JT.chunked_ce(e, x_, jnp.asarray(labels),
                                    jnp.asarray(mask), jcfg, chunk=16),
        argnums=(0, 1))(jax.tree.map(jnp.asarray, emb), jnp.asarray(x))
    te = params_from_numpy(emb)
    te["embedding"].requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    tv = TT.chunked_ce(te, tx, torch.from_numpy(labels),
                       torch.from_numpy(mask), cfg, chunk=16)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(te["embedding"].grad.numpy(),
                               np.asarray(jg[0]["embedding"]), atol=1e-6,
                               rtol=1e-4)


def _run(app, schedule, steps=STEPS, workers=None):
    workers = workers or logical_workers(8, "cpu")
    runner = dmr.MalleableRunner(app, dmr.MalleabilityParams(2, 8, 4),
                                 dmr.ScriptedRMS(schedule), devices=workers)
    state = runner.init()
    losses = []
    for i in range(steps):
        state = dmr.reconfig(runner, state, i)
        state, m = runner.step(state, i)
        losses.append(float(m["loss"]))
    return runner, state, losses


@pytest.fixture
def deterministic():
    """PyTorch's deterministic CPU kernels for the test: the embedding's
    gradient (an accumulating index_put) otherwise sums in an order that
    varies from run to run, by ~1e-7 in these losses."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def test_elastic_run_equals_static_and_survives_a_failure(deterministic):
    cfg = get_config(ARCH)
    app = lm_train_app(cfg, SHAPE, AdamW(learning_rate=1e-3), seed=0)
    _, _, static = _run(app, {})
    runner, state, elastic = _run(app, {2: 8, 4: 2})
    assert elastic == static
    assert [(e.action, e.from_procs, e.to_procs) for e in runner.events] == \
        [("expand", 4, 8), ("shrink", 8, 2)]
    _, jstate = _jax_state()
    nbytes = sum(np.asarray(l).nbytes for l in jax.tree.leaves(jstate))
    assert [e.transfer.bytes_moved for e in runner.events] == [nbytes] * 2
    assert set(runner.events[0].per_pattern) == {"default"}
    # six of eight workers fail: shrink onto the two survivors, train on
    runner, state, _ = _run(app, {1: 8}, steps=3)
    state = runner.handle_failure(state, 3, runner.devices[2:])
    assert runner.current == 2 and runner.events[-1].to_procs == 2
    for i in range(3, 6):
        state, m = runner.step(state, i)
        assert np.isfinite(float(m["loss"]))
    assert int(state.step) == 6


def test_checkpoint_crosses_packages(tmp_path):
    """A checkpoint written by either package restores in the other, leaf
    for leaf, bit for bit."""
    _, jstate = _jax_state()
    jnp_state = _np(jstate)
    j_save(str(tmp_path / "j"), jstate, 7)
    like = train_state_from_numpy(jax.tree.map(np.zeros_like, jnp_state))
    got, step = restore_state(str(tmp_path / "j"), like)
    assert step == 7
    for a, b in zip(T.leaves(got), jax.tree.leaves(jnp_state)):
        assert a.dtype == torch.from_numpy(b.copy()).dtype
        np.testing.assert_array_equal(a.numpy(), b)
    # the port's state after two steps, back into JAX
    cfg = get_config(ARCH)
    state = train_state_from_numpy(jnp_state)
    step_fn = TT.make_train_step(cfg, AdamW(learning_rate=1e-3))
    ds = SyntheticDataset(cfg, SHAPE)
    for i in range(2):
        state, _ = step_fn(state, _torch_batch(ds.batch_at(i * 8)))
    save_state(str(tmp_path / "t"), state, 2)
    back, step = j_restore(str(tmp_path / "t"), jstate)
    assert step == 2
    for a, b in zip(jax.tree.leaves(back), T.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_quickstart_loop_makes_two_resizes():
    """``examples/quickstart.py``'s loop, in the port."""
    cfg = get_config(ARCH)
    app = lm_train_app(cfg, ShapeConfig("quickstart", "train", 64, 8))
    runner, state, losses = _run(app, {4: 8, 10: 2}, steps=14)
    assert len(runner.events) == 2
    assert runner.current == 2
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_train_cli_on_cpu(capsys, tmp_path):
    from repro_torch.launch.train import main
    main(["--arch", ARCH, "--steps", "6", "--resize-at", "2:8",
          "--resize-at", "4:2", "--workers", "8", "--device", "cpu",
          "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"])
    out = capsys.readouterr().out
    # steps 0, 2, 4 saved, the last two kept (CheckpointManager's keep=2)
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == \
        ["ckpt_00000002.npz", "ckpt_00000004.npz"]
    assert out.count("\nstep ") == 6
    assert "# resize @step 2: expand 4->8" in out
    assert "# resize @step 4: shrink 8->2" in out
    assert out.rstrip().endswith("# done")


class _Mesh:
    """What JAX's ``spec_for_axes`` reads of a mesh (``AbstractMesh``'s
    constructor raises under JAX 0.9.0)."""

    def __init__(self, n):
        data, model = factor_mesh(n)
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-3-2b-smoke",
                                  "mixtral-8x7b", "mixtral-8x7b-smoke",
                                  "qwen3-moe-235b-a22b-smoke",
                                  "seamless-m4t-medium", "pixtral-12b"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_state_placements_match_jax_specs(arch, n):
    """Every parameter's mesh-axis entries equal the JAX package's
    PartitionSpec on the same (data, model) mesh, and the state's placement
    tree holds them for params and both moments."""
    from repro.models import model as JM
    from repro.models import params as JP
    cfg, jcfg = get_config(arch), j_get_config(arch)
    jschema = JM.model_schema(jcfg)
    jrules = JS.rules_for(jcfg)
    mesh = make_job_mesh(logical_workers(n, "cpu"))
    assert mesh.shape == _Mesh(n).shape
    exp = [tuple(JS.spec_for_axes(d.axes, jrules, _Mesh(n), d.shape))
           for d in jax.tree.leaves(jschema, is_leaf=JP.is_def)]
    got = [S.spec_for_axes(d.axes, S.rules_for(cfg), mesh, d.shape)
           for d in T.leaves(TT.M.model_schema(cfg))]
    assert got == exp
    placements = S.state_shardings(cfg, mesh)
    want = [Placement(mesh, e) for e in exp]
    assert T.leaves(placements.params) == want
    assert T.leaves(placements.opt.mu) == want == T.leaves(placements.opt.nu)
    assert placements.step == Placement(mesh)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("gb", [1, 4, 8, 12])
def test_batch_placements_match_jax(n, gb):
    mesh = make_job_mesh(logical_workers(n, "cpu"))
    exp = JS._batch_axes(_Mesh(n), gb)
    assert S._batch_axes(mesh, gb) == exp
    batch = SyntheticDataset(get_config(ARCH), ShapeConfig("t", "train", 8,
                                                           gb)).batch_at(0)
    spec = exp if len(exp) > 1 else (exp[0] if exp else None)
    assert S.batch_shardings(get_config(ARCH), ShapeConfig(
        "t", "train", 8, gb), mesh, batch) == \
        {k: Placement(mesh, (spec,)) for k in batch}


def test_placement_has_one_form_per_layout():
    mesh = make_job_mesh(logical_workers(8, "cpu"))
    assert Placement(mesh, 1) == Placement(mesh, (None, ("data", "model")))
    assert Placement(mesh) == Placement(mesh, None) == \
        Placement(mesh, (None, None))
    assert Placement(mesh, ("model",)).spec == ("model",)


def test_state_paths_follow_jax_order():
    """TrainState leaves flatten in jax.tree order, with JAX's paths."""
    _, jstate = _jax_state()
    state = train_state_from_numpy(_np(jstate))
    from repro.dmr.patterns import _path_str
    jpaths = [_path_str(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert [p for p, _ in T.flatten(state)] == jpaths
    assert jpaths[-3:] == ["step", "rng", "data_cursor"]
