"""The port's hybrid family (zamba2: Mamba2 layers in groups, each group
followed by ONE shared-weight attention block) against the JAX package's,
on the CPU.

Two configurations: ``zamba2-2.7b-smoke`` (2 layers, one group) and the
same at 4 layers (two groups, so the shared block is applied twice and
its gradient is a sum over the groups).  Parameters and training states
are made in JAX from a seed and carried over (``interop``); inputs come
from numpy seeds.  Both sides compute in float32, so the bounds are those
of ``tests/test_torch_ssm.py``: 1e-5 absolute and relative on logits and
caches (the same operations, other summation orders); gradients
``atol=1e-6, rtol=1e-4`` as the dense and SSM families' step-0 tests; six
AdamW steps within 1e-4 in loss (``tests/test_elastic.py``'s bound).  The
port's elastic run must equal its static one exactly, under PyTorch's
deterministic kernels.  K1 and K3 take their plain versions here (CPU
tensors); ``tests/test_torch_gpu.py`` holds the kernels on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_state as j_restore
from repro.checkpoint import save_state as j_save
from repro.configs import get_config as j_get_config
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import model as JM
from repro.models import params as JP
from repro.models import train as JT
from repro.optim import AdamW as JAdamW
from repro.parallel import sharding as JS
from repro_torch import dmr
from repro_torch import tree as T
from repro_torch.checkpoint import restore_state, save_state
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.lm_app import lm_train_app
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.models import train as TT
from repro_torch.models.layers import embed, rmsnorm
from repro_torch.optim import AdamW
from repro_torch.parallel import sharding as S
from repro_torch.parallel.mesh import (Placement, factor_mesh,
                                       logical_workers, make_job_mesh)

ARCH = "zamba2-2.7b-smoke"
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
SHAPE = ShapeConfig("t", "train", 64, 8)
STEPS = 6
#: the smoke config (one group) and the same at 4 layers (two groups)
LAYERS = [2, 4]


def _cfgs(layers):
    return (dataclasses.replace(j_get_config(ARCH), num_layers=layers),
            dataclasses.replace(get_config(ARCH), num_layers=layers))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


@pytest.fixture(scope="module", params=LAYERS, ids=lambda n: f"{n}layers")
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(_np(jp))


@pytest.fixture
def deterministic():
    """PyTorch's deterministic CPU kernels (the embedding gradient's
    accumulating index_put otherwise sums in a varying order)."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


# -- config and schema -----------------------------------------------------

def test_config_copy_matches_reference():
    for name in ("zamba2-2.7b", ARCH):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(j_get_config(name))
    cfg = get_config("zamba2-2.7b")
    assert cfg.is_hybrid and not cfg.is_ssm and not cfg.tie_embeddings
    assert cfg.num_layers // cfg.shared_attention_every == 9


@pytest.mark.parametrize("name", ["zamba2-2.7b", ARCH, "4layers"])
def test_schema_matches_reference(name):
    """Paths, shapes, logical axes, dtypes and initialisers of every leaf
    equal ``repro.models.model.model_schema``'s; ``shared_attn`` is one
    set of leaves with no layer axis."""
    jcfg, tcfg = _cfgs(4) if name == "4layers" else \
        (j_get_config(name), get_config(name))
    jflat = jax.tree_util.tree_flatten_with_path(JM.model_schema(jcfg),
                                                 is_leaf=JP.is_def)[0]
    tflat = T.flatten(TM.model_schema(tcfg))
    assert [p for p, _ in tflat] == [
        "/".join(str(k.key) for k in path) for path, _ in jflat]
    for (path, t), (_, j) in zip(tflat, jflat):
        assert (t.shape, t.axes, t.dtype, t.init, t.scale) == \
            (j.shape, j.axes, j.dtype, j.init, j.scale), path
    shared = [(p, d) for p, d in tflat if p.startswith("shared_attn/")]
    assert len(shared) == 9 and all("layers" not in d.axes
                                    for _, d in shared)
    assert TP.param_count(TM.model_schema(tcfg)) == \
        JP.param_count(JM.model_schema(jcfg))


def test_full_width_sizes():
    """zamba2-2.7b's 2.422 B parameters: 54 SSM layers, the untied
    embedding and unembedding, one shared block (attention + MLP)."""
    s = TM.model_schema(get_config("zamba2-2.7b"))
    n = lambda tree: TP.param_count(tree)
    assert n(s) == 2_422_386_848
    assert n(s["shared_attn"]) == 104_862_720
    assert s["embed"]["unembed"].shape == (2560, 32000)
    meta = TM.init_cache(get_config("zamba2-2.7b"), 16, 512, device="meta")
    assert tuple(meta["shared_kv"]["k"].shape) == (9, 16, 512, 32, 80)
    assert tuple(meta["layers"]["state"].shape) == (54, 16, 80, 64, 64)


def test_other_families_still_raise():
    from repro_torch.configs.base import MoEConfig
    cfg = dataclasses.replace(get_config(ARCH), moe=MoEConfig(4, 2, 64))
    with pytest.raises(NotImplementedError):
        TM.model_schema(cfg)
    with pytest.raises(ValueError, match="groups of 2"):
        TM.model_schema(dataclasses.replace(get_config(ARCH), num_layers=3))


# -- forward and decode ----------------------------------------------------

def test_forward_matches_jax(setup):
    """Full-sequence logits at S = 64 (two SSM chunks of 32)."""
    jcfg, tcfg, jp, tp = setup
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 64),
                                             dtype=np.int32)
    jl, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, _ = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == jl.shape
    _close(tl, jl)


def test_decode_steps_match_jax(setup):
    """Ten ``decode_step``s: logits at each, then both caches -- the SSM
    states and conv tails (``layers``) and each group's KV cache
    (``shared_kv``) -- against the JAX package's."""
    jcfg, tcfg, jp, tp = setup
    B, S = 3, 16
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, 10),
                                             dtype=np.int32)
    jc, tc = JM.init_cache(jcfg, B, S), TM.init_cache(tcfg, B, S)
    shapes = lambda c: {g: {n: tuple(t.shape) for n, t in c[g].items()}
                        for g in c}
    assert shapes(tc) == shapes(jc)
    assert set(tc) == {"layers", "shared_kv"}
    jdec = jax.jit(lambda p, t, c, i: JM.decode_step(p, jcfg, t, c, i))
    for i in range(10):
        jd, jc = jdec(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.int32(i))
        td, tc2 = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                                 tc, torch.tensor(i, dtype=torch.int32))
        assert tc2 is tc                       # updated in place
        _close(td, jd)
    for g in ("layers", "shared_kv"):
        for n in jc[g]:
            _close(tc[g][n], jc[g][n])
    assert float(tc["shared_kv"]["k"][:, :, 10:].abs().sum()) == 0.0
    assert all(float(tc["shared_kv"]["k"][g].abs().sum()) > 0
               for g in range(tcfg.num_layers // tcfg.shared_attention_every))


def test_prefill_step_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (4, 64),
                                             dtype=np.int32)
    np.testing.assert_array_equal(
        TT.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
        .numpy(),
        np.asarray(JT.make_prefill_step(jcfg)(
            jp, {"tokens": jnp.asarray(toks)})))


def test_prefill_matches_decode_in_the_port(setup):
    """The port's own consistency: ``make_prefill_step``'s logits (chunked
    scan, causal attention over the whole prompt) equal the token-by-token
    decode's after the same 96 tokens (three chunks), to summation order;
    and the greedy token is the same."""
    _, tcfg, _, tp = setup
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (3, 96), dtype=np.int32))
    with torch.no_grad():
        lp = TT.prefill_logits(tp, tcfg, {"tokens": toks})
        cache = TM.init_cache(tcfg, 3, 96)
        for i in range(96):
            ld, cache = TM.decode_step(tp, tcfg, toks[:, i:i + 1], cache,
                                       torch.tensor(i, dtype=torch.int32))
    _close(lp, ld[:, -1].numpy())
    np.testing.assert_array_equal(
        TT.make_prefill_step(tcfg)(tp, {"tokens": toks}).numpy(),
        ld[:, -1, :tcfg.vocab_size].argmax(-1).numpy())


# -- training --------------------------------------------------------------

def _per_group_loss(params, copies, cfg, batch):
    """``loss_fn`` with group g's shared block reading ``copies[g]``: the
    trunk of ``forward_hidden`` written out, so each application's own
    gradient can be taken."""
    x = embed(params["embed"], batch["tokens"], cfg)
    positions = torch.arange(x.shape[1])[None, :]
    every = cfg.shared_attention_every
    for i in range(cfg.num_layers):
        x = TB.ssm_block_apply(TM.layer(params["layers"], i), x, cfg)
        if (i + 1) % every == 0:
            x, _ = TB.decoder_block_apply(copies[i // every], x, cfg,
                                          positions=positions, causal=True)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    labels, mask = batch["labels"], batch["mask"]
    return TT.chunked_ce(params["embed"], x, labels, mask, cfg) / \
        torch.clamp(mask.sum(), min=1.0)


def test_train_step_gradients_match_jax(setup):
    """One training step's loss and gradients: every leaf equals
    ``jax.grad``'s of the JAX package's loss, ``shared_attn`` included.
    Each shared leaf's gradient is non-zero and is the sum of its
    applications' gradients, each non-zero (taken with one copy of the
    shared leaves per group)."""
    jcfg, tcfg, jp, tp = setup
    batch = JDataset(jcfg, ShapeConfig("t", "train", 64, 2)).batch_at(0)
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jbatch), has_aux=True)(jp)
    tbatch = _torch_batch(batch)
    loss, _, grads = TT._value_and_grad(tp, tcfg, tbatch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    got = dict(T.flatten(T.unflatten(tp, list(grads))))
    for (path, g), e in zip(got.items(), jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **GRAD_TOL,
                                   err_msg=path)
    groups = tcfg.num_layers // tcfg.shared_attention_every
    copies = [T.tree_map(lambda t: t.detach().clone().requires_grad_(),
                         tp["shared_attn"]) for _ in range(groups)]
    l2 = _per_group_loss(tp, copies, tcfg, tbatch)
    assert float(l2.detach()) == float(loss)
    per = [torch.autograd.grad(l2, T.leaves(c), retain_graph=True)
           for c in copies]
    for j, (path, _) in enumerate(T.flatten(tp["shared_attn"])):
        g = got[f"shared_attn/{path}"]
        assert float(g.abs().sum()) > 0, path
        assert all(float(p[j].abs().sum()) > 0 for p in per), path
        torch.testing.assert_close(sum(p[j] for p in per), g, atol=1e-7,
                                   rtol=1e-5, msg=path)


def _jax_state(jcfg):
    return JT.init_state(jcfg, JAdamW(learning_rate=1e-3), 0)


@pytest.mark.parametrize("layers", LAYERS)
def test_training_steps_match_jax(layers):
    """Six AdamW steps from JAX's initial state on the same batches: losses
    within 1e-4 of JAX's, as the other families'."""
    jcfg, tcfg = _cfgs(layers)
    jstate = _jax_state(jcfg)
    ds = JDataset(jcfg, SHAPE)
    jstep = jax.jit(JT.make_train_step(jcfg, JAdamW(learning_rate=1e-3)))
    tstep = TT.make_train_step(tcfg, AdamW(learning_rate=1e-3))
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


def test_remat_changes_no_number(deterministic):
    """Each SSM block and each application of the shared block as its own
    checkpoint unit (``cfg.remat``, which zamba2-2.7b sets) recomputes the
    same operations: loss and gradients equal the plain run's bit for bit,
    at two groups."""
    jcfg, _ = _cfgs(4)
    jstate = _jax_state(jcfg)
    batch = _torch_batch(JDataset(jcfg, SHAPE).batch_at(0))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(_cfgs(4)[1], remat=remat)
        state = train_state_from_numpy(_np(jstate))
        out.append(TT._value_and_grad(state.params, cfg, batch))
    (l0, _, g0), (l1, _, g1) = out
    assert float(l0) == float(l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _run(app, schedule, steps=STEPS):
    runner = dmr.MalleableRunner(app, dmr.MalleabilityParams(2, 8, 4),
                                 dmr.ScriptedRMS(schedule),
                                 devices=logical_workers(8, "cpu"))
    state = runner.init()
    losses = []
    for i in range(steps):
        state = dmr.reconfig(runner, state, i)
        state, m = runner.step(state, i)
        losses.append(float(m["loss"]))
    return runner, state, losses


def test_elastic_run_equals_static(deterministic):
    """Listing 2 on the hybrid family, at two groups: the elastic run
    (4 -> 8 -> 2 workers) gives the static run's losses exactly; each
    resize moves the whole state, as many bytes as JAX's state holds."""
    jcfg, cfg = _cfgs(4)
    app = lm_train_app(cfg, SHAPE, AdamW(learning_rate=1e-3), seed=0)
    _, _, static = _run(app, {})
    runner, _, elastic = _run(app, {2: 8, 4: 2})
    assert elastic == static
    assert all(np.isfinite(static)) and static[-1] < static[0]
    assert [(e.action, e.from_procs, e.to_procs) for e in runner.events] == \
        [("expand", 4, 8), ("shrink", 8, 2)]
    nbytes = sum(np.asarray(l).nbytes
                 for l in jax.tree.leaves(_jax_state(jcfg)))
    assert [e.transfer.bytes_moved for e in runner.events] == [nbytes] * 2


def test_checkpoint_crosses_packages(tmp_path):
    """A hybrid training state written by either package restores in the
    other, leaf for leaf, bit for bit (the ``shared_attn`` leaves and the
    untied ``unembed`` among them)."""
    jcfg, cfg = _cfgs(4)
    jstate = _jax_state(jcfg)
    j_save(str(tmp_path / "j"), jstate, 3)
    like = train_state_from_numpy(jax.tree.map(np.zeros_like, _np(jstate)))
    got, step = restore_state(str(tmp_path / "j"), like)
    assert step == 3
    paths = [p for p, _ in T.flatten(got)]
    assert "params/shared_attn/attn/wq" in paths and \
        "opt/mu/embed/unembed" in paths
    for a, b in zip(T.leaves(got), jax.tree.leaves(_np(jstate))):
        np.testing.assert_array_equal(a.numpy(), b)
    state, _ = TT.make_train_step(cfg, AdamW(learning_rate=1e-3))(
        got, _torch_batch(JDataset(jcfg, SHAPE).batch_at(0)))
    save_state(str(tmp_path / "t"), state, 4)
    back, step = j_restore(str(tmp_path / "t"), jstate)
    assert step == 4
    for a, b in zip(jax.tree.leaves(back), T.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


class _Mesh:
    """What JAX's ``spec_for_axes`` reads of a mesh."""

    def __init__(self, n):
        data, model = factor_mesh(n)
        self.axis_names = ("data", "model")
        self.shape = {"data": data, "model": model}


@pytest.mark.parametrize("n", [1, 4, 8])
def test_state_placements_match_jax_specs(n):
    """Every leaf of zamba2-2.7b, ``shared_attn`` (no layer axis) among
    them, resolves to the JAX package's PartitionSpec on the same mesh."""
    cfg, jcfg = get_config("zamba2-2.7b"), j_get_config("zamba2-2.7b")
    exp = [tuple(JS.spec_for_axes(d.axes, JS.rules_for(jcfg), _Mesh(n),
                                  d.shape))
           for d in jax.tree.leaves(JM.model_schema(jcfg), is_leaf=JP.is_def)]
    mesh = make_job_mesh(logical_workers(n, "cpu"))
    placements = S.state_shardings(cfg, mesh)
    assert T.leaves(placements.params) == [Placement(mesh, e) for e in exp]
    assert placements.params["shared_attn"]["mlp"]["wi_gate"] == \
        Placement(mesh, S.spec_for_axes(("embed", "mlp"), S.rules_for(cfg),
                                        mesh, (2560, 10240)))


def test_train_cli_on_cpu(capsys, tmp_path):
    from repro_torch.launch.train import main
    main(["--arch", ARCH, "--steps", "6", "--resize-at", "2:8",
          "--resize-at", "4:2", "--workers", "8", "--device", "cpu",
          "--checkpoint-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("\nstep ") == 6
    assert "# resize @step 2: expand 4->8" in out
    assert "# resize @step 4: shrink 8->2" in out
    assert out.rstrip().endswith("# done")
