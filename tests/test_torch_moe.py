"""The port's mixture-of-experts family against the JAX package's, on the
CPU: the MoE layer (``models/moe.py``) against ``moe_apply_reference``,
its gradients against ``jax.grad``, and ``mixtral-8x7b-smoke`` (sliding
window 16, 4 experts top-2) and ``qwen3-moe-235b-a22b-smoke`` (q/k norm)
in logits, decode caches and six training steps.

Parameters are JAX's, carried over with ``params_from_numpy``; inputs come
from numpy seeds.  The JAX side runs with no sharding context: its
``moe_apply`` then takes the global formulation, which the port computes
at every worker count.  Bounds: the layer's output and aux loss 1e-5 in
fp32 (summation orders differ over at most 128 terms), its kept slots
exactly; bf16 2e-2, the kernel tests' bf16 bound (one bf16 step is 2^-8
relative); gradients ``atol=1e-6, rtol=1e-4``; logits and caches 1e-5;
training losses 1e-4 (``tests/test_elastic.py``'s bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import train as JT
from repro.optim import AdamW as JAdamW
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.lm_app import lm_train_app
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.models import train as TT
from repro_torch.optim import AdamW

MIXTRAL, QWEN = "mixtral-8x7b-smoke", "qwen3-moe-235b-a22b-smoke"
SHAPE = ShapeConfig("t", "train", 64, 8)
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(name, **moe):
    """The JAX and the port's config, the MoE block's fields replaced."""
    jc, tc = jget_config(name), get_config(name)
    if moe:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _layer_params(jc, seed=1):
    """Layer 0's MoE leaves of a JAX-initialised model, as numpy."""
    jp = JM.init_params(jc, jax.random.PRNGKey(seed))
    return {k: v[0] for k, v in _np(jp["layers"]["moe"]).items()}


def _jax_slots(params, x, cfg):
    """The reference's routing (``moe_apply_reference``'s own lines, from
    the router to the bucket slots), for the kept-slot comparison."""
    m = cfg.moe
    T_, k, E = x.shape[0] * x.shape[1], m.experts_per_token, m.num_experts
    xf = x.reshape(T_, -1)
    probs = jax.nn.softmax(jnp.einsum(
        "td,de->te", xf.astype(jnp.float32),
        params["router"].astype(jnp.float32)), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    flat_e = expert_idx.reshape(T_ * k)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    starts = jnp.searchsorted(sorted_e, jnp.arange(E))
    pos = jnp.zeros((T_ * k,), jnp.int32).at[order].set(
        (jnp.arange(T_ * k) - starts[sorted_e]).astype(jnp.int32))
    keep = pos < JMoE.capacity(T_, cfg)
    return [np.asarray(a) for a in (keep, jnp.where(keep, flat_e, E),
                                    jnp.where(keep, pos, 0))]


def _torch_slots(params, x, cfg):
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xf.float() @ params["router"].float(), dim=-1)
    _, slots = TMoE.route(probs, cfg.moe.experts_per_token,
                          TMoE.capacity(xf.shape[0], cfg))
    return [t.numpy() for t in slots]


@pytest.mark.parametrize("name", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_configs_equal_the_references(name):
    """The full configs and their smoke reductions (4 experts top-2 of
    d_ff 64, capacity factor 2.0, mixtral's window 16), field by field."""
    for n in (name, f"{name}-smoke"):
        assert dataclasses.asdict(get_config(n)) == \
            dataclasses.asdict(jget_config(n))
    m = get_config(f"{name}-smoke").moe
    assert (m.num_experts, m.experts_per_token, m.d_ff,
            m.capacity_factor) == (4, 2, 64, 2.0)


# -- the MoE layer ---------------------------------------------------------

@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_layer_matches_reference(cf):
    """fp32 output and aux loss, and the kept slots exactly, at the smoke
    config's capacity factor and at one that drops assignments."""
    jc, tc = _cfgs(MIXTRAL, capacity_factor=cf)
    mp = _layer_params(jc)
    x = np.random.default_rng(1).standard_normal((4, 16, 64)).astype(
        np.float32)
    jy, jaux = JMoE.moe_apply_reference(jax.tree.map(jnp.asarray, mp),
                                        jnp.asarray(x), jc)
    tp, tx = params_from_numpy(mp), torch.from_numpy(x)
    with TMoE.count_drops() as drops:
        ty, taux = TMoE.moe_apply(tp, tx, tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    jkeep, *jslots = _jax_slots(jax.tree.map(jnp.asarray, mp),
                                jnp.asarray(x), jc)
    tkeep, *tslots = _torch_slots(tp, tx, tc)
    np.testing.assert_array_equal(tkeep, jkeep)
    for a, b in zip(tslots, jslots):
        np.testing.assert_array_equal(a, b)
    assert drops["routed"] == 128
    assert drops["dropped"] == int((~jkeep).sum())
    assert (drops["dropped"] > 0) == (cf < 1.0)
    assert TMoE.capacity(64, tc) == JMoE.capacity(64, jc)


def test_moe_layer_bf16():
    """cfg.dtype bfloat16 (the full configs'): the dispatch and the expert
    products in bf16, the router in fp32, against the reference in bf16."""
    jc, tc = _cfgs(MIXTRAL, capacity_factor=0.5)
    jc, tc = (dataclasses.replace(c, dtype="bfloat16") for c in (jc, tc))
    mp = _layer_params(jc, seed=2)
    x = np.random.default_rng(2).standard_normal((4, 16, 64)).astype(
        np.float32)
    jy, jaux = JMoE.moe_apply_reference(
        jax.tree.map(jnp.asarray, mp), jnp.asarray(x, jnp.bfloat16), jc)
    ty, taux = TMoE.moe_apply(params_from_numpy(mp),
                              torch.from_numpy(x).bfloat16(), tc)
    assert ty.dtype == torch.bfloat16 and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-2)


def test_moe_layer_ties_take_the_lower_expert():
    """A zero router gives every expert the same probability: the top k
    are experts 0..k-1, as ``jax.lax.top_k`` orders ties."""
    jc, tc = _cfgs(MIXTRAL)
    mp = dict(_layer_params(jc), router=np.zeros((64, 4), np.float32))
    x = np.random.default_rng(3).standard_normal((2, 8, 64)).astype(
        np.float32)
    jy, jaux = JMoE.moe_apply_reference(jax.tree.map(jnp.asarray, mp),
                                        jnp.asarray(x), jc)
    tp = params_from_numpy(mp)
    ty, taux = TMoE.moe_apply(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    probs = torch.full((16, 4), 0.25)
    (_, idx), _ = TMoE.route(probs, 2, 8)
    assert idx.tolist() == [[0, 1]] * 16


def test_moe_layer_gradients_match_jax():
    """d/dx, d/drouter and the three expert tensors of a weighted sum of
    the output plus the aux loss, at a capacity that drops, against
    ``jax.grad`` of the reference."""
    jc, tc = _cfgs(MIXTRAL, capacity_factor=0.5)
    mp = _layer_params(jc, seed=4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    w = rng.standard_normal((4, 16, 64)).astype(np.float32)

    def jloss(p, x_):
        y, aux = JMoE.moe_apply_reference(p, x_, jc)
        return jnp.sum(y * w) + aux

    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, mp),
                                         jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(mp).items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TMoE.moe_apply(tp, tx, tc)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               atol=1e-6, rtol=1e-4)
    for k in ("router", "wi_gate", "wi_up", "wo"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[0][k]),
                                   atol=1e-6, rtol=1e-4, err_msg=k)
    assert float(tp["router"].grad.abs().max()) > 0


# -- the models ------------------------------------------------------------

@pytest.fixture(scope="module", params=[MIXTRAL, QWEN])
def model(request):
    jc, tc = _cfgs(request.param)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_numpy(_np(jp))


def test_schema_follows_the_reference(model):
    """Every leaf's path, shape and dtype, ``layers/moe/{router, wi_gate,
    wi_up, wo}`` among them, and no dense MLP."""
    jc, tc, jp, tp = model
    flat = T.flatten(tp)
    assert [k for k, _ in flat] == \
        ["/".join(str(getattr(e, "key", e)) for e in path)
         for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    got = {k: (tuple(v.shape), str(v.dtype)) for k, v in flat}
    assert got["layers/moe/wi_gate"] == ((2, 4, 64, 64), "torch.float32")
    assert got["layers/moe/router"] == ((2, 64, 4), "torch.float32")
    assert not any("/mlp/" in k for k in got)
    schema = T.flatten(TM.model_schema(tc))
    assert [(k, d.shape) for k, d in schema] == \
        [(k, tuple(v.shape)) for k, v in flat]


def test_logits_and_aux_match_jax(model):
    jc, tc, jp, tp = model
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 24),
                                             dtype=np.int32)
    jl, jaux = JM.forward(jp, jc, {"tokens": jnp.asarray(toks)})
    tl, taux = TM.forward(tp, tc, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert float(taux) > 0


def test_decode_steps_and_caches_match_jax(model):
    """20 decode steps over a 32-slot cache: mixtral's rolling buffer of
    its window (16 slots) turns over; qwen3-moe's full cache fills to 20.
    Each step routes the batch's 4 tokens through the experts."""
    jc, tc, jp, tp = model
    toks = np.random.default_rng(6).integers(0, jc.vocab_size, (4, 20),
                                             dtype=np.int32)
    jcache, tcache = JM.init_cache(jc, 4, 32), TM.init_cache(tc, 4, 32)
    jdecode = jax.jit(JM.decode_step, static_argnums=1)
    slots = 16 if jc.attention == "swa" else 32
    assert tuple(tcache["layers"]["k"].shape)[2] == slots
    for i in range(20):
        jd, jcache = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]), jcache,
                             jnp.int32(i))
        td, tcache = TM.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                    tcache, torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL,
                                   err_msg=f"step {i}")
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache["layers"][k].numpy(),
                                   np.asarray(jcache["layers"][k]), **TOL)


def _steps(name, steps=6, **over):
    """Training steps of JAX's jitted step (no sharding context) and the
    port's, from JAX's initial state on the same batches: per step the
    losses of both, as (loss, ce_loss, aux_loss)."""
    jc, tc = (dataclasses.replace(c, **over) for c in _cfgs(name))
    jstate = JT.init_state(jc, JAdamW(learning_rate=1e-3), 0)
    ds = JDataset(jc, SHAPE)
    jstep = jax.jit(JT.make_train_step(jc, JAdamW(learning_rate=1e-3)))
    tstep = TT.make_train_step(tc, AdamW(learning_rate=1e-3))
    state = train_state_from_numpy(_np(jstate))
    keys = ("loss", "ce_loss", "aux_loss")
    jl, tl = [], []
    for i in range(steps):
        batch = ds.batch_at(i * ds.global_batch)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = tstep(state, {k: torch.from_numpy(np.asarray(v))
                                 for k, v in batch.items()})
        jl.append([float(jm[k]) for k in keys])
        tl.append([float(m[k]) for k in keys])
    return np.array(tl), np.array(jl)


@pytest.mark.parametrize("name", [MIXTRAL, QWEN])
def test_training_steps_match_jax(name):
    """Six AdamW steps: loss, ce_loss and aux_loss each within 1e-4."""
    tl, jl = _steps(name)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert tl[-1, 0] < tl[0, 0] and (tl[:, 2] > 0).all()


def test_microbatched_steps_match_jax():
    """mixtral's ``train_microbatches`` = 2 at smoke size: gradients summed
    over two half batches and averaged, ce_loss and aux_loss averaged."""
    tl, jl = _steps(MIXTRAL, steps=3, train_microbatches=2)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def test_bf16_master_weights_take_the_reference_adamw():
    """qwen3-moe's bf16 master weights and moments (``param_dtype`` and
    ``opt_moment_dtype`` bfloat16): one update of the MoE leaves from live
    moments equals JAX's AdamW, bit for bit in bf16."""
    rng = np.random.default_rng(9)
    params = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32),
                             jnp.bfloat16)
              for k, s in (("router", (64, 4)), ("wo", (4, 64, 64)))}
    # small enough that the clip scale is exactly 1 in both
    grads = jax.tree.map(lambda p: jnp.asarray(
        0.002 * rng.standard_normal(p.shape), jnp.bfloat16), params)
    mom = lambda: jax.tree.map(lambda p: jnp.asarray(
        0.01 * np.abs(rng.standard_normal(p.shape)), jnp.bfloat16), params)
    mu, nu = mom(), mom()
    jopt = JAdamW(learning_rate=1e-3, moment_dtype="bfloat16")
    jp, jo, jn = jopt.update(grads, jopt.init(params)._replace(
        mu=mu, nu=nu, count=jnp.asarray(4, jnp.int32)), params)
    topt = AdamW(learning_rate=1e-3, moment_dtype="bfloat16")
    conv = lambda t: params_from_numpy(_np(t))
    tp = conv(params)
    assert tp["wo"].dtype == torch.bfloat16
    _, to, tn = topt.update(conv(grads), topt.init(tp)._replace(
        mu=conv(mu), nu=conv(nu), count=torch.tensor(4, dtype=torch.int32)),
        tp)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    assert float(jn) < 1.0
    for a, b in zip(T.leaves(tp) + T.leaves(to.mu) + T.leaves(to.nu),
                    jax.tree.leaves((jp, jo.mu, jo.nu))):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))


# -- the port alone --------------------------------------------------------

def test_elastic_training_equals_static():
    """mixtral-smoke under the runner, 4 -> 8 -> 2 workers: the losses
    (and so every MoE routing) equal the static run's, bit for bit."""
    from repro_torch import dmr
    from repro_torch.parallel.mesh import logical_workers

    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for schedule in ({}, {2: 8, 4: 2}):
            app = lm_train_app(get_config(MIXTRAL), SHAPE,
                               AdamW(learning_rate=1e-3), seed=0)
            runner = dmr.MalleableRunner(
                app, dmr.MalleabilityParams(2, 8, 4),
                dmr.ScriptedRMS(schedule),
                devices=logical_workers(8, "cpu"))
            state, losses = runner.init(), []
            for i in range(6):
                state = dmr.reconfig(runner, state, i)
                state, m = runner.step(state, i)
                losses.append((float(m["loss"]), float(m["aux_loss"])))
            runs.append((losses, [e.action for e in runner.events]))
    finally:
        torch.use_deterministic_algorithms(before)
    assert runs[0][0] == runs[1][0]
    assert runs[1][1] == ["expand", "shrink"]


def test_clis_run_mixtral_smoke(capsys):
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as train
    serve(["--arch", MIXTRAL, "--batch", "8", "--prompt-len", "4",
           "--decode-steps", "4", "--cache-len", "16", "--workers", "8",
           "--device", "cpu", "--resize-at", "6", "--resize-to", "8"])
    out = capsys.readouterr().out
    assert "resize @ step 6: expand 4->8" in out and out.count("seq[") == 4
    train(["--arch", MIXTRAL, "--steps", "4", "--resize-at", "2:8",
           "--workers", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("\nstep ") == 4 and out.rstrip().endswith("# done")
    assert "# resize @step 2: expand 4->8" in out
