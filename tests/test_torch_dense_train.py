"""Training of the dense configs beside granite against the JAX package's,
on the CPU: ``phi4-mini-3.8b``, ``qwen2.5-32b`` (with its QKV bias) and
``internlm2-20b``, each at smoke size with head dim 128 and its full
config's GQA ratio (G = 3, 5, 6: ``tests/test_torch_serving.py``'s
``DENSE_CASES``) and its full config's ``train_microbatches`` (1, 4, 2).

Parameters are JAX's, carried over with ``params_from_numpy``
(``train_state_from_numpy`` for the whole state); the batches are the data
pipeline's (equal in both packages).  Bounds: the step-0 loss 1e-6
relative and every gradient, ``bq``/``bk``/``bv`` included, ``atol=1e-6,
rtol=1e-4`` (``tests/test_torch_train.py``'s: fp32 through two layers,
summation orders differ); one microbatched step's first moments (0.1 of
the clipped gradient summed over the microbatches) ``atol=1e-7,
rtol=1e-4``; six ``lm_train_app`` losses 1e-4 (``tests/test_elastic.py``'s
bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import train as JT
from repro.optim import AdamW as JAdamW
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.lm_app import lm_train_app
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.models import train as TT
from repro_torch.optim import AdamW
from repro_torch.parallel.mesh import logical_workers, make_job_mesh

SHAPE = ShapeConfig("t", "train", 64, 8)        # tests/test_elastic.py's
#: (smoke config, its full config, the heads that give the full config's
#: GQA ratio at head dim 128)
CASES = {"phi4-G3": ("phi4-mini-3.8b", dict(num_heads=6, num_kv_heads=2)),
         "qwen2.5-G5": ("qwen2.5-32b", dict(num_heads=10, num_kv_heads=2)),
         "internlm2-G6": ("internlm2-20b", dict(num_heads=12,
                                                num_kv_heads=2))}
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(case):
    """(JAX config, port config): the smoke config at head dim 128, the
    full config's G and microbatches; equal field for field."""
    full, heads = CASES[case]
    mb = get_config(full).train_microbatches
    cut = dict(heads, head_dim=128, train_microbatches=mb)
    jc = dataclasses.replace(jget_config(f"{full}-smoke"), **cut)
    tc = dataclasses.replace(get_config(f"{full}-smoke"), **cut)
    assert jc.__dict__ == tc.__dict__
    return jc, tc


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(JAX config, port config, JAX's initial state, JAX's jitted train
    step: compiled once a case)."""
    jc, tc = _configs(request.param)
    opt = JAdamW(learning_rate=1e-3)
    return jc, tc, JT.init_state(jc, opt, 0), \
        jax.jit(JT.make_train_step(jc, opt))


def test_the_cases_are_the_full_configs_ratios(case):
    jc, tc, _, _ = case
    full = get_config(tc.name[:-len("-smoke")])
    assert tc.num_heads // tc.num_kv_heads == \
        full.num_heads // full.num_kv_heads
    assert tc.head_dim == full.head_dim == 128
    assert tc.train_microbatches == full.train_microbatches
    assert tc.qkv_bias == (full.name == "qwen2.5-32b")


def test_step0_loss_and_every_gradient_match_jax(case):
    """The loss and every leaf's gradient from JAX's parameters on one
    batch (the bias leaves' too, for qwen2.5)."""
    jc, tc, jstate, _ = case
    batch = JDataset(jc, SHAPE).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jc, b), has_aux=True))(
        jstate.params, jax.tree.map(jnp.asarray, batch))
    params = params_from_numpy(_np(jstate.params))
    loss, _, grads = TT._value_and_grad(
        params, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    got = T.flatten(T.unflatten(params, list(grads)))
    exp = jax.tree.leaves(jg)
    assert len(got) == len(exp)
    for (path, g), e in zip(got, exp):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), err_msg=path,
                                   **GRAD_TOL)
    biases = [p for p, _ in got if p.split("/")[-1] in ("bq", "bk", "bv")]
    assert len(biases) == (3 if tc.qkv_bias else 0)
    for p, g in got:
        if p in biases:
            assert float(g.abs().max()) > 0, p


def test_microbatched_step_sums_gradients_as_jax(case):
    """One step of ``make_train_step`` (its microbatches' gradients summed
    in the moments' dtype and averaged): the first moments, 0.1 of the
    clipped gradient, equal JAX's leaf for leaf, the biases' included."""
    jc, tc, jstate, jstep = case
    batch = JDataset(jc, SHAPE).batch_at(0)
    jnew, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    new, m = TT.make_train_step(tc, AdamW(learning_rate=1e-3))(
        train_state_from_numpy(_np(jstate)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for (path, a), b in zip(T.flatten(new.opt.mu),
                            jax.tree.leaves(jnew.opt.mu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                   rtol=1e-4, err_msg=path)


def test_lm_train_app_steps_match_jax(case):
    """Six AdamW steps of ``lm_train_app``'s step (the port's own data
    pipeline) from JAX's initial state, against JAX's jitted
    ``make_train_step`` on JAX's batches: losses within 1e-4."""
    jc, tc, jstate, jstep = case
    ds = JDataset(jc, SHAPE)
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
