"""The port's SSM family (Mamba2) against the JAX package's.

Kernel K3's CPU path (the chunked plain version) is held against the JAX
Pallas kernel (interpret mode, as ``tests/test_kernels.py`` runs it) and
the JAX sequential oracle at that test's tolerances: 5e-4 for float32 and
3e-2 for bfloat16 (the chunked and the sequential algorithms sum in
different orders through exp-decays; bf16 rounds outputs to 8 bits).  The
model is ``mamba2-370m-smoke`` from JAX-initialised weights
(``params_from_numpy``), in float32 on both sides, held to 1e-5 absolute
and relative: the same operations in the same precision, differing only in
summation order (~1e-7 observed).  Inputs come from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.models import train as JT
from repro.models.train import make_prefill_step as j_prefill
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_rounding
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ref import ssd_chunked_reference, ssd_reference
from repro_torch.models import model as TM
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.models import train as TT
from repro_torch.models.train import make_prefill_step, prefill_logits

ARCH = "mamba2-370m-smoke"
TOL = dict(atol=1e-5, rtol=1e-5)
SSD_TOL = {"float32": 5e-4, "bfloat16": 3e-2}

SSD_CASES = [
    # (B, H, S, P, N, Q, dtype) — tests/test_kernels.py
    (2, 4, 256, 32, 16, 64, "float32"),
    (1, 2, 128, 64, 128, 32, "float32"),
    (1, 2, 128, 32, 16, 128, "float32"),     # single chunk
    (2, 2, 64, 16, 16, 16, "bfloat16"),
]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def _ssd_inputs(rng, B, H, S, P, N):
    """xdt (B,S,H,P), a (B,S,H), bm, cm (B,S,N) as in tests/test_kernels."""
    xdt = rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.3
    a = -np.abs(rng.standard_normal((B, S, H))).astype(np.float32) * 0.4
    bm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.3
    cm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.3
    return xdt, a, bm, cm


# -- kernel K3 ------------------------------------------------------------

@pytest.mark.parametrize("B,H,S,P,N,Q,dtype", SSD_CASES)
def test_ssd_scan_matches_jax_kernel(B, H, S, P, N, Q, dtype):
    """Port layout (B,S,H,P); the JAX kernel's is (B,H,S,P)."""
    xdt, a, bm, cm = _ssd_inputs(np.random.default_rng(0), B, H, S, P, N)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = ops.ssd_scan(torch.from_numpy(xdt).to(tdt), torch.from_numpy(a),
                       torch.from_numpy(bm).to(tdt),
                       torch.from_numpy(cm).to(tdt), chunk=Q)
    assert out.shape == (B, S, H, P) and out.dtype == tdt
    jargs = (jnp.asarray(xdt.transpose(0, 2, 1, 3), jdt),
             jnp.asarray(a.transpose(0, 2, 1)), jnp.asarray(bm, jdt),
             jnp.asarray(cm, jdt))
    kern = jops.ssd_scan(*jargs, chunk=Q)
    oracle = jref.ssd_reference(*jargs)
    tol = dict(atol=SSD_TOL[dtype], rtol=SSD_TOL[dtype])
    got = out.float().numpy().transpose(0, 2, 1, 3)
    _close(torch.from_numpy(got), kern, **tol)
    _close(torch.from_numpy(got), oracle, **tol)


@pytest.mark.parametrize("B,H,S,P,N,Q,dtype", SSD_CASES)
def test_ssd_sequential_reference_matches_jax_oracle(B, H, S, P, N, Q, dtype):
    """The port's oracle is the JAX oracle (the same recurrence in the same
    order): 1e-5 in float32; in bf16 both read the same bf16 inputs and
    round the same fp32 recurrence, so one bf16 step (2^-7 relative)."""
    xdt, a, bm, cm = _ssd_inputs(np.random.default_rng(1), B, H, S, P, N)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = ssd_reference(torch.from_numpy(xdt).to(tdt), torch.from_numpy(a),
                        torch.from_numpy(bm).to(tdt),
                        torch.from_numpy(cm).to(tdt))
    exp = jref.ssd_reference(jnp.asarray(xdt.transpose(0, 2, 1, 3), jdt),
                             jnp.asarray(a.transpose(0, 2, 1)),
                             jnp.asarray(bm, jdt), jnp.asarray(cm, jdt))
    tol = TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    _close(out.transpose(1, 2), exp, **tol)


def test_ssd_matches_model_chunked():
    """``ssd_chunked`` (port: through ``ops.ssd_scan``) against the JAX
    package's pure-jnp ``ssd_chunked``, at the shape of
    ``tests/test_kernels.py::test_ssd_matches_model_chunked``: the same
    chunked algorithm in float32, so 1e-5."""
    rng = np.random.default_rng(2)
    B, H, S, P, N = 2, 4, 128, 16, 32
    x = rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.3
    dt = np.abs(rng.standard_normal((B, S, H))).astype(np.float32) * 0.5 + 0.1
    A = -np.abs(rng.standard_normal((H,))).astype(np.float32) - 0.5
    bm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.3
    cm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.3
    y, _ = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, bm, cm)), chunk=32)
    out = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, bm, cm)),
                           chunk=32)
    _close(out, y)
    # and the chunked plain version against the sequential one, directly
    xdt, a = torch.from_numpy(x * dt[..., None]), torch.from_numpy(dt * A)
    _close(ssd_chunked_reference(xdt, a, torch.from_numpy(bm),
                                 torch.from_numpy(cm), 32),
           ssd_reference(xdt, a, torch.from_numpy(bm), torch.from_numpy(cm)),
           atol=5e-4, rtol=5e-4)


def test_ssd_scan_rejects_what_the_reference_rejects():
    xdt, a, bm, cm = map(torch.from_numpy, _ssd_inputs(
        np.random.default_rng(3), 1, 2, 48, 16, 16))
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ops.ssd_scan(xdt, a, bm, cm, chunk=32)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        tssm.ssd_chunked(xdt, a.abs(), torch.ones(2), bm, cm, chunk=32)
    with pytest.raises(TypeError, match="float32 a"):
        ops.ssd_scan(xdt, a.double(), bm, cm, chunk=16)
    with pytest.raises(ValueError, match="shapes"):
        ops.ssd_scan(xdt, a[:, :, :1], bm, cm, chunk=16)


@pytest.mark.parametrize("dtype,P,N,Q,path", [
    (torch.bfloat16, 64, 128, 256, "wgmma"),     # mamba2-370m's call
    (torch.bfloat16, 64, 64, 256, "wgmma"),      # zamba2-2.7b's call
    (torch.bfloat16, 16, 16, 64, "wgmma"),
    (torch.bfloat16, 32, 64, 128, "wgmma"),
    (torch.bfloat16, 48, 80, 192, "wgmma"),      # padded to 64 and 128
    (torch.bfloat16, 16, 16, 16, "fma"),         # the kernel tests' bf16 Q
    (torch.bfloat16, 64, 128, 96, "fma"),        # not whole 64-row blocks
    (torch.bfloat16, 8, 128, 256, "fma"),        # P not a multiple of 16
    (torch.bfloat16, 64, 144, 256, "fma"),       # N past 128
    (torch.float32, 64, 128, 256, "fma"),        # fp32 never takes TF32
    (torch.float32, 16, 16, 64, "fma"),
])
def test_ssd_path_choice(dtype, P, N, Q, path):
    """K3's path is a pure function of the dtype, P, N and the chunk: the
    tensor cores for bf16 chunks of whole 64-row sub-chunks, fp32 FMAs
    for everything else."""
    assert ss.select_path(dtype, P, N, Q) == path


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_the_models_ssd_call_takes_the_tensor_cores(arch):
    """The SSM and hybrid families' bf16 prefill (every layer's
    ssd_chunked) selects the wgmma path; their fp32 smoke configs stay on
    fp32 FMAs."""
    cfg = get_config(arch)
    shape = (cfg.ssm.head_dim, cfg.ssm.state_size, cfg.ssm.chunk_size)
    assert cfg.dtype == "bfloat16"
    assert ss.select_path(torch.bfloat16, *shape) == "wgmma"
    smoke = get_config(f"{arch}-smoke")
    assert ss.select_path(tparams.torch_dtype(smoke.dtype), smoke.ssm.head_dim,
                          smoke.ssm.state_size, smoke.ssm.chunk_size) == "fma"


def test_ssd_wgmma_rounding_model_holds_the_tolerance():
    """The wgmma path's roundings (every operand that is not an input split
    into bf16 hi + lo) keep y within SSD_CHUNKED_TOL of the chunked plain
    version and within SSD_TOL of the sequential oracle, through several
    sub-chunks and a chunk edge."""
    args = ssd_rounding.inputs(0, 1, 4, 512, 64, 128)
    y = ssd_rounding.model_y(*args, p=True, state=True, update=True)
    ref = ssd_chunked_reference(*args, 256)
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert ssd_rounding.worst_ratio(y, ref, 1e-2) < 1.0
    assert ssd_rounding.worst_ratio(y, ssd_reference(*args), 3e-2) < 1.0


def test_ssd_cpu_calls_are_not_launches():
    """CPU tensors take the plain chunked version: no launch, on any
    path, whatever path the shape would select on a card."""
    ops.reset_counts()
    for dt in (torch.float32, torch.bfloat16):
        xdt, a, bm, cm = map(torch.from_numpy, _ssd_inputs(
            np.random.default_rng(4), 1, 2, 128, 64, 128))
        out = ops.ssd_scan(xdt.to(dt), a, bm.to(dt), cm.to(dt), chunk=64)
        assert out.dtype == dt
    assert ops.launch_counts()["ssd_scan"] == 0
    assert ss.ssd_scan.path_launches == {"fma": 0, "wgmma": 0}


# -- the Mamba2 block ------------------------------------------------------

def test_config_schema_and_init_follow_the_reference(setup):
    jcfg, tcfg, jp, tp = setup
    for name in ("mamba2-370m", "mamba2-370m-smoke"):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jget_config(name))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0))
    tflat = T.flatten(own)
    assert [p for p, _ in tflat] == [
        "/".join(str(k.key) for k in path) for path, _ in jflat]
    for (_, t), (_, j) in zip(tflat, jflat):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
    for name in ("mamba2-370m", ARCH):
        assert tparams.param_count(TM.model_schema(get_config(name))) == \
            jparams.param_count(JM.model_schema(jget_config(name)))
    a_log = own["layers"]["ssm"]["A_log"]
    assert float(a_log.min()) >= 0.0 and float(a_log.max()) <= np.log(16.0)
    # interop carries every SSM leaf across unchanged
    for (path, t), (_, j) in zip(T.flatten(tp), jflat):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=path)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    jo, js = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               None if st is None else jnp.asarray(st))
    to, ts = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               None if st is None else torch.from_numpy(st))
    _close(to, jo)
    _close(ts, js)


def test_ssm_apply(setup):
    """The full block over S = 64 (two chunks of 32)."""
    jcfg, tcfg, jp, tp = setup
    x = np.random.default_rng(5).standard_normal((2, 64, 64)).astype(
        np.float32)
    lj = jax.tree.map(lambda a: a[1], jp["layers"])["ssm"]
    lt = TM.layer(tp["layers"], 1)["ssm"]
    _close(tssm.ssm_apply(lt, torch.from_numpy(x), tcfg),
           jssm.ssm_apply(lj, jnp.asarray(x), jcfg))


def test_ssm_decode_step_output_and_cache(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(6)
    B = 3
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    shapes = {n: tuple(t.shape) for n, t in
              tssm.init_ssm_cache(tcfg, B).items()}
    cache = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in shapes.items()}
    lj = jax.tree.map(lambda a: a[0], jp["layers"])["ssm"]
    lt = TM.layer(tp["layers"], 0)["ssm"]
    jo, jc = jssm.ssm_decode_step(lj, jnp.asarray(x), jcfg,
                                  jax.tree.map(jnp.asarray, cache))
    tc = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    to, tc2 = tssm.ssm_decode_step(lt, torch.from_numpy(x), tcfg, tc)
    assert tc2 is tc                         # updated in place
    _close(to, jo)
    for n in cache:
        _close(tc[n], jc[n])


# -- the model ------------------------------------------------------------

def test_forward_and_decode_steps(setup):
    """Forward logits at S = 64 (two chunks), then per-token decode logits
    and the stacked caches, step by step."""
    jcfg, tcfg, jp, tp = setup
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 64),
                                             dtype=np.int32)
    jl, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, _ = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    jdec = jax.jit(lambda p, t, c, i: JM.decode_step(p, jcfg, t, c, i))
    jc, tc = JM.init_cache(jcfg, 2, 64), TM.init_cache(tcfg, 2, 64)
    assert {n: tuple(t.shape) for n, t in tc["layers"].items()} == \
        {n: t.shape for n, t in jc["layers"].items()}
    for i in range(64):
        jd, jc = jdec(jp, jnp.asarray(toks[:, i:i + 1]), jc, jnp.int32(i))
        td, tc = TM.decode_step(tp, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                                tc, torch.tensor(i, dtype=torch.int32))
        _close(td, jd)
    for n in jc["layers"]:
        _close(tc["layers"][n], jc["layers"][n])
    # the last decode step's logits are the forward pass's last position
    _close(td[:, -1], jl[:, -1])


def test_prefill_step(setup):
    jcfg, tcfg, jp, tp = setup
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (4, 64),
                                             dtype=np.int32)
    batch_t = {"tokens": torch.from_numpy(toks)}
    np.testing.assert_array_equal(
        make_prefill_step(tcfg)(tp, batch_t).numpy(),
        np.asarray(j_prefill(jcfg)(jp, {"tokens": jnp.asarray(toks)})))
    jl, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _close(prefill_logits(tp, tcfg, batch_t), jl[:, -1])


def test_prefill_matches_decode_in_the_port(setup):
    """The port's own consistency, in float32: the chunked full-sequence
    prefill and the token-by-token recurrence give the same last logits
    after the same 96 tokens (three chunks), to summation order."""
    _, tcfg, _, tp = setup
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (3, 96), dtype=np.int32))
    with torch.no_grad():
        lp = prefill_logits(tp, tcfg, {"tokens": toks})
        cache = TM.init_cache(tcfg, 3, 96)
        for i in range(96):
            ld, cache = TM.decode_step(tp, tcfg, toks[:, i:i + 1], cache,
                                       torch.tensor(i, dtype=torch.int32))
    _close(lp, ld[:, -1].numpy())


#: the parameters that reach the loss only through the SSD scan (w_x and
#: conv_x reach it through the D_skip term too)
SCAN_ONLY = ("w_B", "w_C", "w_dt", "conv_B", "conv_C", "dt_bias", "A_log")


def test_ssm_train_step_gradients_on_the_cpu_match_jax(setup):
    """A mamba2-370m-smoke training step on the CPU, where the scan is its
    plain version and autograd sees through it: every parameter that
    reaches the loss only through the scan gets a gradient, non-zero in
    every layer, and every gradient equals ``jax.grad`` of the JAX
    package's loss at the bounds of the dense family's step-0 test (on a
    card the scan refuses a gradient instead: tests/test_torch_gpu.py)."""
    jcfg, tcfg, jp, tp = setup
    batch = JDataset(jcfg, JShapeConfig("t", "train", 64, 2)).batch_at(0)
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, jbatch), has_aux=True)(jp)
    loss, _, grads = TT._value_and_grad(
        tp, tcfg, {k: torch.from_numpy(np.asarray(v))
                   for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    got = dict(T.flatten(T.unflatten(tp, list(grads))))
    for name in SCAN_ONLY:
        g = got[f"layers/ssm/{name}"]
        assert all(float(g[i].abs().sum()) > 0 for i in range(g.shape[0])), \
            name
    for (path, g), e in zip(got.items(), jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=1e-6,
                                   rtol=1e-4, err_msg=path)
