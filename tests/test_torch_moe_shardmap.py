"""The port's sharded MoE dispatch (``models/moe.py::_moe_apply_shardmap``)
against the JAX package's, on the CPU.

``_local_dispatch`` and ``_local_combine`` are compared in this process
with a capacity that binds.  ``moe_apply`` under a sharding context runs
on the JAX side in one child interpreter on 8 host devices (meshes from
``make_job_mesh``): EP on ``(1, 4)`` and ``(2, 4)`` at capacity factor 1.0
(each shard drops its own assignments: not the global formulation's), and
TP with the expert MLP split over ``model`` on ``(1, 8)``.  Outputs, aux
loss and every gradient within 1e-5 (fp32; products summed in other
orders).

The reference's TP branch at ``(1, 8)`` with the default rules (4 experts
do not split over 8 workers, and nothing splits the expert MLP) psums 8
whole products: its output is 8x ``moe_apply_reference``'s.  The port
sums only F-slices, so its output equals the global formulation.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as JMoE
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import moe as TMoE
from repro_torch.parallel.context import sharding_context
from repro_torch.parallel.mesh import logical_workers, make_job_mesh
from repro_torch.parallel.sharding import rules_for
from tests.util import run_devices

QWEN, MIXTRAL = "qwen3-moe-235b-a22b-smoke", "mixtral-8x7b-smoke"
TP_RULES = {"experts": None, "expert_mlp": ("model",)}
#: case -> (arch, workers, max_model, rule overrides, capacity factor)
CASES = {"EP-1x4": (QWEN, 4, 4, None, 1.0),
         "EP-2x4": (QWEN, 8, 4, None, 1.0),
         "EP-2x4-mixtral": (MIXTRAL, 8, 4, None, 1.0),
         "TP-1x8": (MIXTRAL, 8, 8, TP_RULES, 1.0),
         "TP-1x8-qwen": (QWEN, 8, 8, TP_RULES, 2.0),
         "defect-1x8": (QWEN, 8, 8, None, 2.0),
         "defect-1x8-mixtral": (MIXTRAL, 8, 8, None, 2.0)}
XSHAPE = (4, 32, 64)
TOL = dict(atol=1e-5, rtol=1e-5)

SCRIPT = r"""
import warnings; warnings.filterwarnings("ignore")
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models import moe as M
from repro.parallel.context import sharding_context
from repro.parallel.mesh import make_job_mesh
from repro.parallel.sharding import rules_for

def inputs(arch, cf):
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    rng = np.random.default_rng(3)
    schema = M.moe_schema(cfg)
    p = {n: (0.1 * rng.standard_normal(schema[n].shape)).astype(np.float32)
         for n in sorted(schema)}
    x = rng.standard_normal(XSHAPE).astype(np.float32)
    r = rng.standard_normal(XSHAPE).astype(np.float32)
    return cfg, p, x, r

out = {}
for case, (arch, n, mm, ov, cf) in CASES.items():
    cfg, p, x, r = inputs(arch, cf)
    mesh = make_job_mesh(jax.devices()[:n], max_model=mm)
    def loss(pp, xx):
        with sharding_context(mesh, rules_for(cfg, ov)):
            y, aux = M.moe_apply(pp, xx, cfg)
        return jnp.sum(y * r) + aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    yr, _ = M.moe_apply_reference(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), cfg)
    out[case] = {"y": np.asarray(y).tolist(), "aux": float(aux),
                 "gx": np.asarray(gx).tolist(), "y_ref": np.asarray(yr).tolist(),
                 "gp": {k: np.asarray(v).tolist() for k, v in gp.items()}}
print("JSON" + json.dumps(out))
"""


def _inputs(arch, cf):
    """The child's config, parameters and inputs (the same numpy draws)."""
    jc, tc = jget_config(arch), get_config(arch)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, capacity_factor=cf))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, capacity_factor=cf))
    rng = np.random.default_rng(3)
    schema = TMoE.moe_schema(tc)
    p = {n: (0.1 * rng.standard_normal(schema[n].shape)).astype(np.float32)
         for n in sorted(schema)}
    x = rng.standard_normal(XSHAPE).astype(np.float32)
    r = rng.standard_normal(XSHAPE).astype(np.float32)
    return jc, tc, p, x, r


@pytest.fixture(scope="module")
def jax_out():
    script = SCRIPT.replace("CASES.items()", repr(CASES) + ".items()") \
        .replace("XSHAPE", repr(XSHAPE))
    out = run_devices(script, n_devices=8, timeout=400)
    return json.loads(out.split("JSON", 1)[1])


def _mesh(n, mm):
    return make_job_mesh(logical_workers(n, "cpu"), max_model=mm)


# -- a shard's dispatch and combine ---------------------------------------

@pytest.mark.parametrize("C", [8, 16, 64])
def test_local_dispatch_and_combine_match_jax(C):
    """One shard's 64 tokens, 128 assignments over 4 experts: at C = 8 and
    16 the capacity binds (cumulative-sum ranks drop the later tokens), at
    64 it does not.  Buckets, slots, keep, gates and aux exactly (the same
    fp32 operations), the combine within 1e-6."""
    jc, tc, p, x, _ = _inputs(QWEN, 1.0)
    xf = x.reshape(-1, x.shape[-1])[:64]
    logits = xf @ p["router"]
    want = JMoE._local_dispatch(jnp.asarray(xf), jnp.asarray(logits), jc, C)
    got = TMoE._local_dispatch(torch.from_numpy(xf),
                               torch.from_numpy(logits), tc, C)
    names = ("buckets", "slot_e", "slot_c", "keep", "gate_vals", "aux")
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7,
                                   rtol=1e-6, err_msg=name)
    keep = got[3]
    assert (not keep.all()) == (C < 64)
    y = np.random.default_rng(5).standard_normal(
        (4, C, x.shape[-1])).astype(np.float32)
    jy = JMoE._local_combine(jnp.asarray(y), *want[1:5], 64)
    ty = TMoE._local_combine(torch.from_numpy(y), *got[1:5], 64)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6,
                               rtol=1e-6)


# -- the layer under a sharding context -----------------------------------

@pytest.mark.parametrize("case", [c for c in CASES
                                  if not c.startswith("defect")])
def test_moe_apply_under_a_context_matches_jax(jax_out, case):
    arch, n, mm, ov, cf = CASES[case]
    _, tc, p, x, r = _inputs(arch, cf)
    tp = {k_: t.requires_grad_() for k_, t in params_from_numpy(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    with sharding_context(_mesh(n, mm), rules_for(tc, ov)):
        y, aux = TMoE.moe_apply(tp, tx, tc)
    ((y * torch.from_numpy(r)).sum() + aux).backward()
    want = jax_out[case]
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want["y"]),
                               **TOL)
    np.testing.assert_allclose(float(aux.detach()), want["aux"], **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want["gx"]),
                               **TOL)
    for k_, t in tp.items():
        np.testing.assert_allclose(t.grad.numpy(),
                                   np.asarray(want["gp"][k_]), **TOL,
                                   err_msg=k_)
    if case.startswith("EP"):
        # per-shard capacity: some assignments dropped that the global
        # formulation keeps, so the layer is not the global one
        y_ref, _ = TMoE.moe_apply_reference(params_from_numpy(p),
                                            torch.from_numpy(x), tc)
        assert (y.detach() - y_ref).abs().max() > 1e-3


@pytest.mark.parametrize("case", ["defect-1x8", "defect-1x8-mixtral"])
def test_tp_without_an_f_split_sums_nothing(jax_out, case):
    """(1, 8) with the default rules: 4 experts do not split over 8
    workers, so both packages take TP mode, and nothing splits F.  The
    reference psums 8 whole products: 8x its global formulation.  The
    port's output equals the global formulation."""
    arch, n, mm, ov, cf = CASES[case]
    _, tc, p, x, _ = _inputs(arch, cf)
    want = jax_out[case]
    y_j, y_ref_j = np.asarray(want["y"]), np.asarray(want["y_ref"])
    np.testing.assert_allclose(y_j, 8 * y_ref_j, atol=1e-5, rtol=1e-5)
    assert np.abs(y_j - y_ref_j).max() > 1e-2
    with torch.no_grad(), sharding_context(_mesh(n, mm), rules_for(tc, ov)):
        y, _ = TMoE.moe_apply(params_from_numpy(p), torch.from_numpy(x), tc)
        y_ref, _ = TMoE.moe_apply_reference(params_from_numpy(p),
                                            torch.from_numpy(x), tc)
    np.testing.assert_allclose(y_ref.numpy(), y_ref_j, **TOL)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-6,
                               rtol=1e-6)


def test_count_drops_counts_each_shards_drops():
    """EP on (1, 4): ``count_drops`` adds each shard's drops at its own
    capacity ``C_loc`` (the reference's formula), which JAX's
    ``_local_dispatch`` gives shard by shard."""
    jc, tc, p, x, _ = _inputs(QWEN, 1.0)
    with torch.no_grad(), TMoE.count_drops() as drops, \
            sharding_context(_mesh(4, 4), rules_for(tc)):
        TMoE.moe_apply(params_from_numpy(p), torch.from_numpy(x), tc)
    B, S, D = x.shape
    T_loc = B * S // 4
    C_loc = max(8, -(-int(T_loc * 2 * 1.0 / 4) // 8) * 8)
    dropped = 0
    for i in range(4):                   # shard i: sequence slice i
        xf = x[:, i * S // 4:(i + 1) * S // 4].reshape(-1, D)
        keep = JMoE._local_dispatch(jnp.asarray(xf),
                                    jnp.asarray(xf @ p["router"]), jc,
                                    C_loc)[3]
        dropped += int((~np.asarray(keep)).sum())
    assert drops == {"dropped": dropped, "routed": B * S * 2,
                     "capacities": [C_loc]}
    assert dropped > 0
