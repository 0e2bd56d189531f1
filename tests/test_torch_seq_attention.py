"""Sequence-parallel attention of the port against the JAX package's, on
the CPU: K1's plain version with a causal query offset (``q_offset``)
against ``chunked_attention(q_offset=)``, and ``attn_apply`` under a
sharding context, whose sequence path (``_attn_apply_seq_shardmap``: 4
heads do not split over 8 ``model`` workers) shards the queries, gathers
K/V over ``model`` and, on ``(2, 8)``, gathers the weights over ``data``.

The JAX side of the layer runs in one child interpreter on 16 host
devices, on meshes from ``make_job_mesh``.  Parameters and inputs come
from numpy seeds, equal in both.  Bounds: fp32 outputs 1e-5, K1's
gradients 1e-5, the layer's gradients 2e-3 (``tests/test_seq_attention.py``'s
bound for the same path against the unsharded one).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import meta as kmeta
from repro_torch.models import attention as TA
from repro_torch.parallel.context import sharding_context
from repro_torch.parallel.mesh import logical_workers, make_job_mesh
from repro_torch.parallel.sharding import rules_for
from tests.util import run_devices

ARCHS = ["qwen2.5-32b-smoke", "phi4-mini-3.8b-smoke"]
#: mesh name -> (workers, max_model)
MESHES = {"1x8": (8, 8), "2x8": (16, 8)}
B, S = 2, 64

SCRIPT = r"""
import warnings; warnings.filterwarnings("ignore")
import json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models import attention as A
from repro.parallel.context import sharding_context
from repro.parallel.mesh import make_job_mesh
from repro.parallel.sharding import rules_for

def inputs(cfg):
    rng = np.random.default_rng(7)
    schema = A.attention_schema(cfg)
    p = {n: (0.1 * rng.standard_normal(schema[n].shape)).astype(np.float32)
         for n in sorted(schema)}
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    return p, x, r

out = {}
pos = jnp.arange(64)[None, :]
for arch in ARCHS:
    cfg = get_config(arch)
    p, x, r = inputs(cfg)
    for name, (n, mm) in MESHES.items():
        mesh = make_job_mesh(jax.devices()[:n], max_model=mm)
        def loss(pp, xx):
            with sharding_context(mesh, rules_for(cfg)):
                y = A.attn_apply(pp, xx, cfg, positions=pos, causal=True)
            return jnp.sum(y * r), y
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        out[f"{arch}/{name}"] = {
            "y": np.asarray(y).tolist(), "gx": np.asarray(gx).tolist(),
            "gp": {k: np.asarray(v).tolist() for k, v in gp.items()}}
print("JSON" + json.dumps(out))
"""


def _inputs(cfg):
    """The child's parameters and inputs (the same numpy draws)."""
    rng = np.random.default_rng(7)
    schema = TA.attention_schema(cfg)
    p = {n: (0.1 * rng.standard_normal(schema[n].shape)).astype(np.float32)
         for n in sorted(schema)}
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return p, x, r


@pytest.fixture(scope="module")
def jax_out():
    script = SCRIPT.replace("ARCHS", repr(ARCHS)).replace(
        "MESHES.items()", repr(MESHES) + ".items()")
    out = run_devices(script, n_devices=16, timeout=400)
    return json.loads(out.split("JSON", 1)[1])


# -- K1 with a query offset ---------------------------------------------------

def _qkv(seed=0, sq=16, sk=64, h=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, sq, h, d), (B, sk, hkv, d), (B, sk, hkv, d),
                      (B, sq, h, d))]


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("q_offset", [0, 16, 40, 48])
def test_k1_plain_with_offset_matches_chunked_attention(q_offset, window):
    """K1's plain version (the CPU path of ``flash_attention``) with a
    query offset, forward and the gradients of <out, r> by autograd and by
    the plain backward (``flash_attention_bwd``'s CPU path), against
    ``chunked_attention(q_offset=)`` and ``jax.grad``."""
    q, k, v, r = _qkv()

    def jf(q_, k_, v_):
        o = JA.chunked_attention(q_, k_, v_, causal=True, window=window,
                                 chunk_q=16, chunk_k=16, q_offset=q_offset)
        return jnp.sum(o * r), o

    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).requires_grad_()
                  for a in (q, k, v))
    to = fa.flash_attention(tq, tk, tv, causal=True, window=window,
                            q_offset=q_offset)
    np.testing.assert_allclose(to.detach().transpose(1, 2).numpy(),
                               np.asarray(jo), atol=1e-5, rtol=1e-5)
    do = torch.from_numpy(r).transpose(1, 2)
    auto = torch.autograd.grad(to, (tq, tk, tv), do)
    o, lse = fa.flash_attention_lse(tq.detach(), tk.detach(), tv.detach(),
                                    causal=True, window=window,
                                    q_offset=q_offset)
    plain = fa.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), o,
                                   do, lse, causal=True, window=window,
                                   q_offset=q_offset)
    for a, b, want in zip(auto, plain, jg):
        want = np.asarray(want)
        np.testing.assert_allclose(a.transpose(1, 2).numpy(), want,
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(b.transpose(1, 2).numpy(), want,
                                   atol=1e-5, rtol=1e-5)


def test_offset_shards_tile_the_full_causal_call():
    """Four query shards with offsets 0, 16, 32, 48 over the whole
    sequence's keys give the full causal call's rows, and their pairs
    (``meta.attention_pairs``, which the dry run counts) sum to its."""
    q, k, v, _ = _qkv(sq=64)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    full = fa.flash_attention(tq, tk, tv, causal=True)
    parts = [fa.flash_attention(tq[:, :, i:i + 16], tk, tv, causal=True,
                                q_offset=i) for i in range(0, 64, 16)]
    torch.testing.assert_close(torch.cat(parts, dim=2), full, atol=1e-6,
                               rtol=1e-6)
    for window in (0, 24):
        assert sum(kmeta.attention_pairs(16, 64, True, window, q_offset=i)
                   for i in range(0, 64, 16)) == \
            kmeta.attention_pairs(64, 64, True, window)
    with pytest.raises(ValueError):
        fa.flash_attention(tq, tk, tv, q_offset=-1)


@pytest.mark.parametrize("q_offset", [None, 0, 48])
def test_offset_calls_count_under_their_own_mask(q_offset):
    """On meta, a call given an offset is counted by its offset pairs and
    the mask it is counted under is ``offset``."""
    assert fa.mask_of(True, None, 16, 64, q_offset) == \
        ("causal" if q_offset is None else "offset")
    q = torch.empty((B, 4, 16, 16), device="meta")
    k = torch.empty((B, 2, 64, 16), device="meta")
    with kmeta.recording() as calls:
        fa.flash_attention(q, k, k, causal=True, q_offset=q_offset)
    pairs = kmeta.attention_pairs(16, 64, True, q_offset=q_offset or 0)
    assert calls[0].flops == 4 * 16 * B * 4 * pairs


# -- the layer under a sharding context ------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_attn_apply_sequence_path_matches_jax(jax_out, arch, mesh_name):
    cfg = get_config(arch)
    p, x, r = _inputs(cfg)
    n, mm = MESHES[mesh_name]
    mesh = make_job_mesh(logical_workers(n, "cpu"), max_model=mm)
    assert cfg.num_heads % mesh.shape["model"] != 0
    tp = {k_: t.requires_grad_() for k_, t in params_from_numpy(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    before = dict(fa.flash_attention.mask_launches)
    with sharding_context(mesh, rules_for(cfg)):
        y = TA.attn_apply(tp, tx, cfg, positions=torch.arange(S)[None, :],
                          causal=True)
    assert fa.flash_attention.mask_launches == before   # CPU: no launch
    (y * torch.from_numpy(r)).sum().backward()
    want = jax_out[f"{arch}/{mesh_name}"]
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want["y"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want["gx"]),
                               atol=2e-3, rtol=0)
    assert set(want["gp"]) == set(tp)
    for k_, t in tp.items():
        np.testing.assert_allclose(t.grad.numpy(),
                                   np.asarray(want["gp"][k_]), atol=2e-3,
                                   rtol=0, err_msg=k_)
    # and the port's unsharded path gives the same numbers
    with torch.no_grad():
        plain = TA.attn_apply(params_from_numpy(p), torch.from_numpy(x), cfg,
                              positions=torch.arange(S)[None, :])
    torch.testing.assert_close(y.detach(), plain, atol=1e-5, rtol=1e-5)


def test_sequence_path_is_taken_only_where_the_reference_takes_it():
    """phi4-smoke's 4 heads: on (1, 4) head-TP is possible and the path is
    the plain one (one K1 call over the sequence); on (1, 8) each worker
    runs K1 with its offset (eight calls counted on meta)."""
    cfg = get_config("phi4-mini-3.8b-smoke")
    p = {k_: torch.empty(d.shape, device="meta")
         for k_, d in TA.attention_schema(cfg).items()}
    x = torch.empty((B, S, cfg.d_model), device="meta")
    for n, calls_want in ((4, 1), (8, 8)):
        mesh = make_job_mesh(logical_workers(n, "meta"))
        with kmeta.recording() as calls, \
                sharding_context(mesh, rules_for(cfg)):
            TA.attn_apply(p, x, cfg, positions=torch.arange(
                S, device="meta")[None, :])
        assert len(calls) == calls_want
        assert sum(c.flops for c in calls) == \
            4 * 16 * B * 4 * kmeta.attention_pairs(S, S, True)


def test_dry_run_on_the_production_mesh_counts_the_shards():
    """The dry run on the (16, 16) mesh enters the sharding context, as
    the reference's lowering does: granite-smoke's 4 heads do not split
    over 16 "model" workers, so each layer runs 16 sequence shards (the
    batch of 4 does not split over 16 "data" workers: each shard is one
    call for its column), whose offset pairs and products add up to the
    unsharded step's on the card mesh."""
    from repro_torch.launch import dryrun
    single, card = (dryrun.run_cell("granite-3-2b-smoke", "smoke", m,
                                    verbose=False)["count"]
                    for m in ("single", "card"))
    L = get_config("granite-3-2b-smoke").num_layers
    assert single["kernel_calls"] == {"flash_attention": 16 * L,
                                      "flash_attention_bwd": 16 * L}
    assert card["kernel_calls"] == {"flash_attention": L,
                                    "flash_attention_bwd": L}
    assert single["kernel_flops"] == card["kernel_flops"]
    assert single["product_flops"] == card["product_flops"]
