"""The port's lockstep SPMD (``repro_torch.parallel.spmd``), its sharding
context (``parallel/context.py``) and int8 gradient compression
(``optim/compression.py``) against the JAX package's, on the CPU.

The JAX side runs in one child interpreter on 8 host devices
(``tests/util.run_devices``), on meshes from ``make_job_mesh`` (Auto
axes): ``(1, 8)`` and ``(2, 4)``.  Every body ends with a leading worker
axis split over ``("data", "model")``, so each worker's own value is
compared, not only an assembled one.  Collectives move or add values in
the same order: bounds are exact, but for ``pmean``'s division (1e-7)
and the compressed psum (1e-6 after two rounds of error feedback).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as JC
from repro_torch import tree as T
from repro_torch.optim import compression as TC
from repro_torch.parallel import context as ctx
from repro_torch.parallel import spmd
from repro_torch.parallel.mesh import logical_workers, make_job_mesh
from repro_torch.parallel.sharding import rules_for
from tests.util import run_devices

MESHES = {"1x8": 8, "2x4": 4}           # name -> max_model over 8 workers
SHAPE = (8, 8, 6)
#: the bodies, each a (JAX, port) pair of expressions over the worker's
#: value ``v`` and its indices ``i_d``, ``i_m`` (``w`` = v scaled by them)
CASES = ["axis_index", "all_gather_tiled", "all_gather_stacked", "psum",
         "psum_both", "pmean", "all_to_all_tiled", "all_to_all_untiled"]

SCRIPT = r"""
import warnings; warnings.filterwarnings("ignore")
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.parallel.compat import shard_map
from repro.parallel.mesh import make_job_mesh
from repro.optim.compression import compressed_psum_tree

out = {}
x = np.random.default_rng(0).standard_normal((8, 8, 6)).astype(np.float32)
BOTH = ("data", "model")
for name, mm in {"1x8": 8, "2x4": 4}.items():
    mesh = make_job_mesh(jax.devices()[:8], max_model=mm)
    nm = mesh.shape["model"]

    def body(case, v):
        i_d = jax.lax.axis_index("data")
        i_m = jax.lax.axis_index("model")
        w = v * (1.0 + i_m + 10.0 * i_d)
        if case == "axis_index":
            r = jnp.stack([i_d, i_m, jax.lax.axis_index(BOTH)]).astype(
                jnp.float32)
        elif case == "all_gather_tiled":
            r = jax.lax.all_gather(w, "model", axis=1, tiled=True)
        elif case == "all_gather_stacked":
            r = jax.lax.all_gather(w, "data", axis=0, tiled=False)
        elif case == "psum":
            r = jax.lax.psum(w, "model")
        elif case == "psum_both":
            r = jax.lax.psum(w, BOTH)
        elif case == "pmean":
            r = jax.lax.pmean(w, "data")
        elif case == "all_to_all_tiled":
            r = jax.lax.all_to_all(w, "model", 0, 1, tiled=True)
        else:
            r = jax.lax.all_to_all(w[:nm], "model", 0, 1, tiled=False)
        return r[None]

    for case in sys.argv[1:]:
        f = shard_map(lambda v, c=case: body(c, v), mesh=mesh,
                      in_specs=(P(None, "model"),), out_specs=P(BOTH),
                      check_vma=False)
        out[f"{name}/{case}"] = np.asarray(f(jnp.asarray(x))).tolist()

# two rounds of compressed_psum_tree over "data" of the (2, 4) mesh
mesh = make_job_mesh(jax.devices()[:8], max_model=4)
rng = np.random.default_rng(1)
g = {"a": rng.standard_normal((2, 6, 5)).astype(np.float32),
     "b": {"c": rng.standard_normal((2, 7)).astype(np.float32)}}

def cpt(grads, err):
    red, e = compressed_psum_tree(grads, "data", err)
    return red, e

f = shard_map(cpt, mesh=mesh, in_specs=(P("data"), P("data")),
              out_specs=(P(), P("data")), check_vma=False)
err = jax.tree.map(jnp.zeros_like, g)
for r in range(2):
    red, err = f(jax.tree.map(jnp.asarray, g), err)
    out[f"cpt/{r}"] = jax.tree.map(lambda a: np.asarray(a).tolist(),
                                   (red, err))
    g = jax.tree.map(lambda a: a * 0.5 + 0.25, g)
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_out():
    out = run_devices(SCRIPT.replace("sys.argv[1:]", repr(CASES)),
                      n_devices=8, timeout=300)
    return json.loads(out.split("JSON", 1)[1])


def _mesh(name):
    return make_job_mesh(logical_workers(8, "cpu"), max_model=MESHES[name])


def _port_body(case, mesh):
    BOTH = ("data", "model")
    nm = mesh.shape["model"]

    def body(vs):
        i_d, i_m = spmd.axis_index("data"), spmd.axis_index("model")
        w = spmd.each(lambda v, d, m: v * (1.0 + m + 10.0 * d), vs, i_d, i_m)
        if case == "axis_index":
            r = spmd.each(lambda d, m, b: torch.tensor(
                [d, m, b], dtype=torch.float32), i_d, i_m,
                spmd.axis_index(BOTH))
        elif case == "all_gather_tiled":
            r = spmd.all_gather(w, "model", axis=1, tiled=True)
        elif case == "all_gather_stacked":
            r = spmd.all_gather(w, "data", axis=0, tiled=False)
        elif case == "psum":
            r = spmd.psum(w, "model")
        elif case == "psum_both":
            r = spmd.psum(w, BOTH)
        elif case == "pmean":
            r = spmd.pmean(w, "data")
        elif case == "all_to_all_tiled":
            r = spmd.all_to_all(w, "model", 0, 1, tiled=True)
        else:
            r = spmd.all_to_all([t[:nm] for t in w], "model", 0, 1,
                                tiled=False)
        return [t[None] for t in r]

    return spmd.shard_map(body, mesh, [(None, "model")], (BOTH,))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_collective_matches_jax(jax_out, mesh_name, case):
    x = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    got = _port_body(case, _mesh(mesh_name))(torch.from_numpy(x))
    want = np.asarray(jax_out[f"{mesh_name}/{case}"], np.float32)
    assert got.shape == want.shape
    tol = 1e-7 if case == "pmean" else 0.0
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_gradients_flow_through_the_collectives():
    """A gathered, all-to-all'd, summed value's gradient reaches each
    worker's part: the same as the gradient of the plain formula."""
    mesh = _mesh("2x4")
    x = torch.randn(SHAPE, dtype=torch.float64, requires_grad=True)

    def body(vs):
        g = spmd.all_gather(vs, "model", axis=1, tiled=True)
        a = spmd.all_to_all(g, "model", 0, 1, tiled=True)
        s = spmd.psum(spmd.each(lambda t: (t ** 2).sum(), a), "data")
        return [t[None] for t in s]

    out = spmd.shard_map(body, mesh, [(None, "model")],
                         (("data", "model"),))(x)
    out.sum().backward()
    # worker (d, m) holds 4 copies of x's rows 2m, 2m + 1 after the
    # all-to-all, and the psum over data adds its two groups' sums: 8 S_m;
    # summed over the 8 workers, 16 sum(x^2)
    torch.testing.assert_close(x.grad, 32 * x.detach())


def test_a_gathered_value_is_one_tensor_per_group():
    """K/V gathered over model: the workers of a group share one tensor;
    a replicated input is one view for every worker, and ``each`` calls
    its function once for it."""
    mesh = _mesh("2x4")
    calls = []

    def body(xs, ws):
        g = spmd.all_gather(xs, "model", axis=1, tiled=True)
        assert len({id(t) for t in g}) == 2          # one per data group
        assert len({id(t) for t in ws}) == 1
        spmd.each(lambda w: calls.append(w) or w, ws)
        return g

    spmd.shard_map(body, mesh, [("data", "model"), ()], (("data",),))(
        torch.randn(4, 8), torch.randn(3))
    assert len(calls) == 1


def test_split_and_assemble_invert_each_other():
    mesh = _mesh("2x4")
    x = torch.arange(8 * 16 * 3.0).reshape(8, 16, 3)
    for spec in [(), ("data",), (None, "model"), (("data", "model"),),
                 ("model", "data"), (None, ("model", "data"))]:
        parts = spmd.split(x, spec, mesh)
        assert len(parts) == 8
        assert torch.equal(spmd.assemble(parts, spec, mesh), x)
    with pytest.raises(ValueError):
        spmd.split(torch.zeros(6, 2), ("model",), mesh)
    with pytest.raises(RuntimeError):
        spmd.psum([torch.zeros(1)], "model")


# -- the sharding context --------------------------------------------------

def test_context_nests_and_suspends():
    from repro_torch.configs import get_config
    cfg = get_config("phi4-mini-3.8b-smoke")
    a, b = _mesh("1x8"), _mesh("2x4")
    assert ctx.get_context() is None
    with ctx.sharding_context(a, rules_for(cfg)):
        mesh, rules = ctx.get_context()
        assert mesh is a and rules["act_seq_blk"] == ("model",)
        assert rules["embed"] == ("data",)
        with ctx.sharding_context(b, {"embed": None}):
            assert ctx.get_context()[0] is b
            assert ctx.get_context()[1]["embed"] is None
            with ctx.suspend_sharding_context():
                assert ctx.get_context() is None
            assert ctx.get_context()[0] is b
        assert ctx.get_context()[0] is a
        seen = ctx.bind(ctx.get_context)
    assert ctx.get_context() is None
    assert seen()[0] is a                 # bound: the context it was made in


def test_constrain_returns_its_input():
    x = torch.randn(2, 8, 4)
    assert ctx.constrain(x, "act_batch", "act_seq", "act_embed") is x
    with ctx.sharding_context(_mesh("2x4"), {}):
        assert ctx.constrain(x, "act_batch", "act_seq_blk", "act_embed") \
            is x
        with pytest.raises(ValueError):
            ctx.constrain(x, "act_batch", None, None, None)


# -- int8 compression -------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_compress_int8_is_bit_equal_to_jax(scale):
    x = (np.random.default_rng(3).standard_normal((33, 17)) * scale
         ).astype(np.float32)
    jq, js = JC.compress_int8(jnp.asarray(x))
    tq, ts = TC.compress_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(
        TC.decompress_int8(tq, ts).numpy(),
        np.asarray(JC.decompress_int8(jq, js)))


def test_compressed_psum_tree_matches_jax(jax_out):
    """Two rounds over ``data`` of the (2, 4) mesh, the error of the first
    fed to the second: the reduced gradients and the new errors."""
    mesh = _mesh("2x4")
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((2, 6, 5)).astype(np.float32),
         "b": {"c": rng.standard_normal((2, 7)).astype(np.float32)}}
    g = T.tree_map(torch.from_numpy, g)
    def body(*ls):
        red, new = TC.compressed_psum_tree(T.unflatten(g, list(ls[:2])),
                                           "data",
                                           T.unflatten(g, list(ls[2:])))
        return tuple(T.leaves(red) + T.leaves(new))

    f = lambda grads, err: spmd.shard_map(
        body, mesh, [("data",)] * 4, [(), (), ("data",), ("data",)])(
        *T.leaves(grads), *T.leaves(err))
    err = T.tree_map(torch.zeros_like, g)
    for r in range(2):
        red_a, red_c, err_a, err_c = f(g, err)
        (jred, jerr) = jax_out[f"cpt/{r}"]
        np.testing.assert_allclose(red_a.numpy(), np.asarray(jred["a"]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(red_c.numpy(), np.asarray(jred["b"]["c"]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(err_a.numpy(), np.asarray(jerr["a"]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(err_c.numpy(),
                                   np.asarray(jerr["b"]["c"]),
                                   atol=1e-6, rtol=0)
        err = {"a": err_a, "b": {"c": err_c}}
        g = T.tree_map(lambda a: a * 0.5 + 0.25, g)
