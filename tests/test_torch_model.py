"""The port's dense model against the JAX package's, from the same weights.

Parameters come from ``repro.models.model.init_params`` and are converted
with ``repro_torch.interop.params_from_numpy``; inputs come from numpy
seeds.  ``granite-3-2b-smoke`` computes in float32 on both sides, so the
only differences are summation orders (matmuls over at most 128 terms of
O(1) values, and the online softmax against the naive one): 1e-5 absolute
and relative leaves about two orders of magnitude of margin over the
observed ~1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import params as jparams
from repro.models.train import make_prefill_step as j_prefill
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import params as tparams
from repro_torch.models.train import make_prefill_step, prefill_logits

ARCH = "granite-3-2b-smoke"
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_config_copy_matches_reference():
    for name in ("granite-3-2b", "granite-3-2b-smoke"):
        assert get_config(name).__dict__ == jget_config(name).__dict__


def test_schema_and_init_follow_the_reference(setup):
    jcfg, tcfg, jp, _ = setup
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    from repro_torch import tree as T
    tflat = T.flatten(tp)
    assert [p for p, _ in tflat] == [
        "/".join(str(k.key) for k in path) for path, _ in jflat]
    for (_, t), (_, j) in zip(tflat, jflat):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
    assert tparams.param_count(TM.model_schema(tcfg)) == \
        jparams.param_count(JM.model_schema(jcfg))
    assert tparams.param_bytes(TM.model_schema(tcfg)) == \
        jparams.param_bytes(JM.model_schema(jcfg))
    layers = tp["layers"]
    assert torch.equal(layers["ln1"]["scale"], torch.ones_like(
        layers["ln1"]["scale"]))
    std = tp["embed"]["embedding"].std().item()
    assert abs(std - 0.02) < 0.002, std


def test_rmsnorm_rope_mlp(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    lj = jax.tree.map(lambda a: a[0], jp["layers"])
    lt = TM.layer(tp["layers"], 0)
    _close(tlayers.rmsnorm(lt["ln1"], torch.from_numpy(x), 1e-5),
           jlayers.rmsnorm(lj["ln1"], jnp.asarray(x), 1e-5))
    _close(tlayers.mlp(lt["mlp"], torch.from_numpy(x), tcfg),
           jlayers.mlp(lj["mlp"], jnp.asarray(x), jcfg))
    h = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    pos = np.arange(16)[None, :] + 5
    _close(tlayers.apply_rope(torch.from_numpy(h), torch.from_numpy(pos),
                              1e4),
           jlayers.apply_rope(jnp.asarray(h), jnp.asarray(pos), 1e4))


def test_attn_apply(setup):
    jcfg, tcfg, jp, tp = setup
    x = np.random.default_rng(1).standard_normal((2, 64, 64)).astype(
        np.float32)
    lj = jax.tree.map(lambda a: a[1], jp["layers"])["attn"]
    lt = TM.layer(tp["layers"], 1)["attn"]
    pos = np.arange(64)[None, :]
    _close(tattn.attn_apply(lt, torch.from_numpy(x), tcfg,
                            positions=torch.from_numpy(pos)),
           jattn.attn_apply(lj, jnp.asarray(x), jcfg,
                            positions=jnp.asarray(pos)))


def test_decode_attn_apply_output_and_cache(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(2)
    B, S = 3, 32
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    k = rng.standard_normal((B, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((B, S, 2, 16)).astype(np.float32)
    lj = jax.tree.map(lambda a: a[0], jp["layers"])["attn"]
    lt = TM.layer(tp["layers"], 0)["attn"]
    jo, jc = jattn.decode_attn_apply(
        lj, jnp.asarray(x), jcfg, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        cache_index=jnp.int32(11))
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    to, tc = tattn.decode_attn_apply(lt, torch.from_numpy(x), tcfg, tc,
                                     cache_index=torch.tensor(11))
    _close(to, jo)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_decode_step_and_forward(setup):
    jcfg, tcfg, jp, tp = setup
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    jl, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, _ = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    jc, tc = JM.init_cache(jcfg, 2, 16), TM.init_cache(tcfg, 2, 16)
    for i in range(12):
        jd, jc = JM.decode_step(jp, jcfg, jnp.asarray(toks[:, i:i + 1]), jc,
                                jnp.int32(i))
        td, tc = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                                tc, torch.tensor(i, dtype=torch.int32))
        _close(td, jd)
    _close(tc["layers"]["k"], jc["layers"]["k"])
    _close(tc["layers"]["v"], jc["layers"]["v"])
    # the last decode step's logits are the forward pass's last position
    _close(td[:, -1], jl[:, -1])


def test_prefill_step(setup):
    jcfg, tcfg, jp, tp = setup
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (4, 16),
                                             dtype=np.int32)
    batch_t = {"tokens": torch.from_numpy(toks)}
    np.testing.assert_array_equal(
        make_prefill_step(tcfg)(tp, batch_t).numpy(),
        np.asarray(j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)})))
    jl, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _close(prefill_logits(tp, tcfg, batch_t), jl[:, -1])


def test_other_families_raise():
    from dataclasses import replace
    from repro_torch.configs.base import MoEConfig
    cfg = replace(get_config(ARCH), moe=MoEConfig(4, 2, 64))
    with pytest.raises(NotImplementedError):
        TM.model_schema(cfg)


@pytest.mark.parametrize("variant", [
    {"qkv_bias": True}, {"qk_norm": True},
    {"attention": "swa", "window": 6}])
def test_dense_variants_match_reference(variant):
    """The dense family's attention options (biases, q/k norm, sliding
    window with a rolling decode cache) follow the reference too."""
    from dataclasses import replace
    jcfg = replace(jget_config(ARCH), **variant)
    tcfg = replace(get_config(ARCH), **variant)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    # zero-initialised biases would hide a missing add: perturb every leaf
    rng = np.random.default_rng(5)
    jp = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype), jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    toks = rng.integers(0, jcfg.vocab_size, (2, 10), dtype=np.int32)
    jl, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, _ = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    jc, tc = JM.init_cache(jcfg, 2, 16), TM.init_cache(tcfg, 2, 16)
    for i in range(10):
        jd, jc = JM.decode_step(jp, jcfg, jnp.asarray(toks[:, i:i + 1]), jc,
                                jnp.int32(i))
        td, tc = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                                tc, torch.tensor(i, dtype=torch.int32))
        _close(td, jd)
    _close(tc["layers"]["k"], jc["layers"]["k"])
