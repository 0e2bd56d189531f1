"""The port's vision-prefix family against the JAX package's, on the CPU:
``pixtral-12b-smoke`` (2 layers, 4 heads over 2 KV heads of 16, a prefix
of 8 patch embeddings of 32 dims) in its schema, logits over the prefix
and the text, text-only decode steps, every gradient (``frontend_proj``
among them), the loss on the text span alone and six training steps.

Parameters are JAX's, carried over with ``params_from_numpy``; tokens and
patch embeddings come from numpy seeds.  Bounds: logits and caches 1e-5;
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
from repro_torch.models.layers import unembed
from repro_torch.optim import AdamW
from repro_torch.parallel.mesh import logical_workers, make_job_mesh

ARCH = "pixtral-12b-smoke"
SHAPE = ShapeConfig("t", "train", 64, 8)
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jc, tc = jget_config(ARCH), get_config(ARCH)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_numpy(_np(jp))


def _batch(jc, B, S, seed):
    rng = np.random.default_rng(seed)
    P, E = jc.frontend.tokens_per_sample, jc.frontend.embed_dim
    return {"tokens": rng.integers(0, jc.vocab_size, (B, S), dtype=np.int32),
            "patch_embeds": rng.standard_normal((B, P, E)).astype(
                np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_configs_equal_the_references():
    """The full config (40 layers, 32 heads over 8 of 128, 256 patches of
    1024) and its smoke reduction, field by field."""
    for n in ("pixtral-12b", ARCH):
        assert dataclasses.asdict(get_config(n)) == \
            dataclasses.asdict(jget_config(n))
    full = get_config("pixtral-12b")
    assert (full.frontend.kind, full.frontend.tokens_per_sample,
            full.frontend.embed_dim) == ("vision", 256, 1024)
    TM._require_supported(full)


def test_schema_follows_the_reference(setup):
    """Every leaf's path, shape and dtype: the decoder stack as a dense
    model's, and ``frontend_proj`` (E, d_model)."""
    jc, tc, jp, tp = setup
    flat = T.flatten(tp)
    assert [k for k, _ in flat] == \
        ["/".join(str(getattr(e, "key", e)) for e in path)
         for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [(k, d.shape) for k, d in T.flatten(TM.model_schema(tc))] == \
        [(k, tuple(v.shape)) for k, v in flat]
    got = dict(flat)
    assert tuple(got["frontend_proj"].shape) == (32, 64)
    assert not any(k.startswith(("enc_layers", "layers/cross")) for k in got)


def test_logits_match_jax(setup):
    """Logits over the 8-patch prefix and 16 text tokens (24 positions,
    causal over both)."""
    jc, tc, jp, tp = setup
    batch = _batch(jc, 2, 16, 1)
    jl, _ = JM.forward(jp, jc, jax.tree.map(jnp.asarray, batch))
    tl, _ = TM.forward(tp, tc, _torch(batch))
    assert tuple(tl.shape) == (2, 24, tc.vocab_size)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)


def test_decode_steps_and_caches_match_jax(setup):
    """Text-only decode, as the reference's serving path: four steps,
    logits and KV caches within 1e-5."""
    jc, tc, jp, tp = setup
    B, S = 3, 16
    jcache, tcache = JM.init_cache(jc, B, S), TM.init_cache(tc, B, S)
    assert set(tcache) == set(jcache) == {"layers"}
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (B, 4),
                                             dtype=np.int32)
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


def test_gradients_match_jax(setup):
    """One batch of the data pipeline (8 patches + 24 text tokens): the
    loss and every leaf's gradient against ``jax.grad``'s."""
    jc, tc, jp, tp = setup
    batch = JDataset(jc, ShapeConfig("t", "train", 32, 2)).batch_at(0)
    assert batch["tokens"].shape == (2, 24)
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, jbatch), has_aux=True)(jp)
    loss, _, grads = TT._value_and_grad(tp, tc, _torch(batch))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    got = T.flatten(T.unflatten(tp, list(grads)))
    for (path, g), e in zip(got, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **GRAD_TOL,
                                   err_msg=path)
    assert float(dict(got)["frontend_proj"].abs().max()) > 0


def test_loss_is_taken_on_the_text_span(setup):
    """``loss_fn`` drops the prefix's hidden states: its CE equals the mean
    CE of the full logits' text positions against the labels, and JAX's."""
    jc, tc, jp, tp = setup
    batch = JDataset(jc, ShapeConfig("t", "train", 32, 2)).batch_at(0)
    P = tc.frontend.tokens_per_sample
    tb = _torch(batch)
    with torch.no_grad():
        loss, m = TT.loss_fn(tp, tc, tb)
        x, _ = TM.forward_hidden(tp, tc, tb)
        logits = unembed(tp["embed"], x, tc)[:, P:].float()
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tb["labels"].reshape(-1).long())
    np.testing.assert_allclose(float(m["ce_loss"]), float(ce), rtol=1e-6)
    jloss, _ = JT.loss_fn(jp, jc, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)


def test_chunked_ce_takes_a_divisor_chunk(setup):
    """A text span that the chunk does not divide (pixtral's 3840 of 4096
    at 1024; here 56 at 16): the port's CE runs four chunks of 14, the
    reference's the whole span at once; the sum and its gradients agree."""
    jc, tc, jp, tp = setup
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 56, tc.d_model)).astype(np.float32)
    labels = rng.integers(0, tc.vocab_size, (2, 56)).astype(np.int32)
    mask = np.ones((2, 56), np.float32)
    emb = _np(jp["embed"])
    jv, jg = jax.value_and_grad(
        lambda e, x_: JT.chunked_ce(e, x_, jnp.asarray(labels),
                                    jnp.asarray(mask), jc, chunk=16),
        argnums=(0, 1))(jax.tree.map(jnp.asarray, emb), jnp.asarray(x))
    te = {k: v.requires_grad_() for k, v in params_from_numpy(emb).items()}
    tx = torch.from_numpy(x).requires_grad_()
    calls = []
    orig = TT._ce_chunk
    try:
        TT._ce_chunk = lambda *a: calls.append(a[1].shape[1]) or orig(*a)
        tv = TT.chunked_ce(te, tx, torch.from_numpy(labels),
                           torch.from_numpy(mask), tc, chunk=16)
        tv.backward()
    finally:
        TT._ce_chunk = orig
    assert calls[:4] == [14] * 4
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               atol=1e-6, rtol=1e-4)
    for k in te:       # the input embedding takes no CE gradient (untied)
        g = te[k].grad if te[k].grad is not None else torch.zeros_like(te[k])
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][k]),
                                   atol=1e-6, rtol=1e-4, err_msg=k)
    assert float(te["unembed"].grad.abs().max()) > 0


def test_training_steps_match_jax():
    """Six AdamW steps of ``lm_train_app``'s step (the port's own data
    pipeline, patch embeddings included) from JAX's initial state, against
    JAX's jitted ``make_train_step``: losses within 1e-4."""
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


def test_prefill_step_takes_the_patches(setup):
    """``make_prefill_step`` over the prefix and the text: the greedy
    tokens after the last text token equal JAX's."""
    jc, tc, jp, tp = setup
    batch = _batch(jc, 2, 12, 3)
    with torch.no_grad():
        got = TT.make_prefill_step(tc)(tp, _torch(batch))
    want = JT.make_prefill_step(jc)(jp, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_cli_runs_pixtral_smoke(capsys):
    from repro_torch.launch.train import main as train
    train(["--arch", ARCH, "--steps", "4", "--resize-at", "2:8",
           "--workers", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("\nstep ") == 4 and out.rstrip().endswith("# done")
    assert "# resize @step 2: expand 4->8" in out
