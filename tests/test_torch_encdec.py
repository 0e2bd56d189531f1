"""The port's encoder-decoder family against the JAX package's, on the CPU:
``seamless-m4t-medium-smoke`` (2 encoder and 2 decoder layers, 4 heads
over 2 KV heads of 16, frames of 32 dims) in its schema, encoder output,
logits, decode steps against a cross cache, every gradient (with and
without remat) and six training steps.

Parameters are JAX's, carried over with ``params_from_numpy``; tokens,
frames and cross caches come from numpy seeds.  The JAX package's serving
path never fills the cross cache (its ``decode_demo`` decodes against the
zeros ``init_cache`` makes), so the decode test fills both packages' with
the same seeded values.  Bounds: logits, encoder output and caches 1e-5;
gradients ``atol=1e-6, rtol=1e-4``; training losses 1e-4
(``tests/test_elastic.py``'s bound).
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
from repro.models import train as JT
from repro.optim import AdamW as JAdamW
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.lm_app import lm_train_app
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.models import model as TM
from repro_torch.models import train as TT
from repro_torch.optim import AdamW
from repro_torch.parallel.mesh import logical_workers, make_job_mesh

ARCH = "seamless-m4t-medium-smoke"
SHAPE = ShapeConfig("t", "train", 64, 8)
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, **kw):
    return ["/".join(str(getattr(e, "key", e)) for e in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree, **kw)[0]]


@pytest.fixture(scope="module")
def setup():
    jc, tc = jget_config(ARCH), get_config(ARCH)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_numpy(_np(jp))


def _batch(jc, B, S, S_enc, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, jc.vocab_size, (B, S), dtype=np.int32),
            "frames": rng.standard_normal(
                (B, S_enc, jc.frontend.embed_dim)).astype(np.float32)}


def test_configs_equal_the_references():
    """The full config and its smoke reduction, field by field: 12 + 12
    layers of 16 heads of 64 at full size, 2 + 2 at smoke size."""
    for n in ("seamless-m4t-medium", ARCH):
        assert dataclasses.asdict(get_config(n)) == \
            dataclasses.asdict(jget_config(n))
    full = get_config("seamless-m4t-medium")
    assert full.is_encdec and (full.encoder_layers, full.num_layers,
                               full.frontend.kind) == (12, 12, "audio")
    TM._require_supported(full)


def test_schema_follows_the_reference(setup):
    """Every leaf's path, shape and dtype: the decoder stack's ``ln_x`` and
    ``cross`` leaves, the encoder stack, ``ln_enc`` and ``frontend_proj``."""
    jc, tc, jp, tp = setup
    from repro.models import params as JP
    schema = T.flatten(TM.model_schema(tc))
    jschema = jax.tree_util.tree_flatten_with_path(
        JM.model_schema(jc), is_leaf=JP.is_def)[0]
    assert [(k, d.shape, d.axes) for k, d in schema] == \
        [(p, d.shape, d.axes) for p, (_, d) in
         zip(_paths(JM.model_schema(jc), is_leaf=JP.is_def), jschema)]
    flat = dict(T.flatten(tp))
    assert list(flat) == _paths(jp)
    assert tuple(flat["frontend_proj"].shape) == (32, 64)
    assert tuple(flat["enc_layers/attn/wq"].shape) == (2, 64, 4, 16)
    assert tuple(flat["layers/cross/wk"].shape) == (2, 64, 2, 16)
    assert tuple(flat["layers/ln_x/scale"].shape) == (2, 64)
    assert "ln_enc/scale" in flat and "enc_layers/ln_x/scale" not in flat


def test_encoder_matches_jax(setup):
    """``_encode``: the projected frames through the bidirectional stack."""
    jc, tc, jp, tp = setup
    frames = _batch(jc, 2, 4, 24, 1)["frames"]
    je = JM._encode(jp, jnp.asarray(frames), jc)
    te = TM._encode(tp, torch.from_numpy(frames), tc)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)


@pytest.mark.parametrize("S_enc", [24, 8], ids=["Sq<Sk", "Sq>Sk"])
def test_logits_match_jax(setup, S_enc):
    """Full-sequence logits with the encoder's output read by each decoder
    block's cross-attention, against more frames than tokens and fewer."""
    jc, tc, jp, tp = setup
    batch = _batch(jc, 2, 16, S_enc, 2)
    jl, _ = JM.forward(jp, jc, jax.tree.map(jnp.asarray, batch))
    tl, _ = TM.forward(tp, tc, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)
    # the frames matter: other frames, other logits
    other = dict(batch, frames=batch["frames"][::-1].copy())
    tl2, _ = TM.forward(tp, tc, {k: torch.from_numpy(v)
                                 for k, v in other.items()})
    assert float((tl2 - tl).abs().max()) > 1e-3


def test_decode_steps_and_caches_match_jax(setup):
    """Four decode steps against a seeded cross cache of 12 slots: logits
    and self-attention caches within 1e-5 of JAX's, the cross cache
    unchanged."""
    jc, tc, jp, tp = setup
    B, S, S_enc = 3, 16, 12
    jcache = JM.init_cache(jc, B, S, enc_len=S_enc)
    tcache = TM.init_cache(tc, B, S, enc_len=S_enc)
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in tcache.items()} == \
        {k: {n: t.shape for n, t in v.items()} for k, v in jcache.items()}
    rng = np.random.default_rng(3)
    cross = {n: rng.standard_normal(jcache["cross"][n].shape).astype(
        np.float32) for n in ("k", "v")}
    jcache["cross"] = jax.tree.map(jnp.asarray, cross)
    tcache["cross"] = {n: torch.from_numpy(v.copy()) for n, v in cross.items()}
    toks = rng.integers(0, jc.vocab_size, (B, 4), dtype=np.int32)
    jdecode = jax.jit(JM.decode_step, static_argnums=1)
    for i in range(4):
        jd, jcache = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]), jcache,
                             jnp.int32(i))
        td, tcache = TM.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                    tcache, torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL,
                                   err_msg=f"step {i}")
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache["layers"][k].numpy(),
                                   np.asarray(jcache["layers"][k]), **TOL)
        np.testing.assert_array_equal(tcache["cross"][k].numpy(), cross[k])
        np.testing.assert_array_equal(np.asarray(jcache["cross"][k]),
                                      cross[k])


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax(setup, remat):
    """One training batch's loss and every leaf's gradient against
    ``jax.grad`` of the JAX package's loss: the encoder's leaves take
    theirs through all the decoder layers' cross-attention (under remat
    the encoder's output is an input of each checkpointed layer)."""
    jc, tc, jp, tp = setup
    jc, tc = (dataclasses.replace(c, remat=remat) for c in (jc, tc))
    batch = JDataset(jc, ShapeConfig("t", "train", 32, 2)).batch_at(0)
    assert batch["frames"].shape == (2, 32, 32)
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, jbatch), has_aux=True)(jp)
    loss, _, grads = TT._value_and_grad(
        tp, tc, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    got = T.flatten(T.unflatten(tp, list(grads)))
    for (path, g), e in zip(got, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **GRAD_TOL,
                                   err_msg=path)
    got = dict(got)
    for path in ("frontend_proj", "enc_layers/attn/wq", "ln_enc/scale",
                 "layers/cross/wk", "layers/cross/wq"):
        assert float(got[path].abs().max()) > 0, path


def test_training_steps_match_jax():
    """Six AdamW steps of ``lm_train_app``'s step (the port's own data
    pipeline, frames included) from JAX's initial state, against JAX's
    jitted ``make_train_step`` on JAX's batches: losses within 1e-4."""
    jc, tc = jget_config(ARCH), get_config(ARCH)
    opt = JAdamW(learning_rate=1e-3)
    jstate = JT.init_state(jc, opt, 0)
    ds = JDataset(jc, SHAPE)
    jstep = jax.jit(JT.make_train_step(jc, opt))
    app = lm_train_app(tc, SHAPE, AdamW(learning_rate=1e-3), seed=0)
    step = app.make_step(make_job_mesh(logical_workers(1, "cpu")))
    state = train_state_from_numpy(_np(jstate))
    jl, tl = [], []
    for i in range(6):
        jstate, jm = jstep(jstate, jax.tree.map(
            jnp.asarray, ds.batch_at(i * ds.global_batch)))
        state, m = step(state, i)
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    assert tl[-1] < tl[0]
    assert int(state.data_cursor) == 6 * SHAPE.global_batch


def test_prefill_step_takes_the_frames(setup):
    """``make_prefill_step`` and ``prefill_logits`` on tokens and frames:
    the last position's logits and greedy tokens equal JAX's."""
    jc, tc, jp, tp = setup
    batch = _batch(jc, 2, 12, 20, 4)
    jl, _ = JM.forward(jp, jc, jax.tree.map(jnp.asarray, batch))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        np.testing.assert_allclose(TT.prefill_logits(tp, tc, tb).numpy(),
                                   np.asarray(jl[:, -1]), **TOL)
        np.testing.assert_array_equal(
            TT.make_prefill_step(tc)(tp, tb).numpy(),
            np.asarray(JT.make_prefill_step(jc)(
                jp, jax.tree.map(jnp.asarray, batch))))


def test_train_cli_runs_seamless_smoke(capsys):
    from repro_torch.launch.train import main as train
    train(["--arch", ARCH, "--steps", "4", "--resize-at", "2:8",
           "--workers", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("\nstep ") == 4 and out.rstrip().endswith("# done")
    assert "# resize @step 2: expand 4->8" in out
