"""The SSM family's training slice against the JAX package's, on the CPU.

K3's gradient: the plain backward ``ssd_chunked_backward_reference`` (the
CPU branch of ``ssd_scan_bwd`` and the ground truth the CUDA kernel is
held to on the card) against autograd of ``ssd_chunked_reference`` and
against ``jax.vjp`` of the JAX package's sequential oracle and of its
model-level ``ssd_chunked``.  Each output is held to a bound relative to
its largest entry (``max |got - ref| <= tol * max |ref|``): da is a row
sum minus a column sum that cancel, so an elementwise bound would measure
the cancellation, not the gradient.  Bounds, fixed from an fp32 against
fp64 run of the same formulas:

* against autograd of the chunked plain version (the same algorithm in
  fp32, another summation order): 1e-5 (4e-7 seen); bf16 inputs round
  both to bf16 once, so one bf16 step, 1e-2;
* against the JAX sequential oracle and the JAX ``ssd_chunked``: 1e-4.
  In fp32 the chunked algorithm is up to 5.2e-5 from the fp64 gradient in
  da at mamba2's decays (in-chunk cumsums reach ~-3e3), the oracle ~1e-6.

Then ``mamba2-370m-smoke`` training, its state initialised in JAX and
carried over (``interop``): six fp32 steps within 1e-4 of the JAX losses
(``tests/test_torch_train.py``'s bound), elastic equal to static, remat
changing no number, and the train CLI.  Inputs come from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import SyntheticDataset as JDataset
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro.models import train as JT
from repro.optim import AdamW as JAdamW
from repro_torch import dmr
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.lm_app import lm_train_app
from repro_torch.interop import train_state_from_numpy
from repro_torch.kernels import ops, ssd_rounding
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ref import (ssd_chunked_backward_reference,
                                     ssd_chunked_reference)
from repro_torch.models import ssm as tssm
from repro_torch.models import train as TT
from repro_torch.optim import AdamW
from repro_torch.parallel.mesh import logical_workers

ARCH = "mamba2-370m-smoke"
SHAPE = ShapeConfig("t", "train", 64, 8)
STEPS = 6
#: max |got - ref| / max |ref|, per output (see the module docstring)
AUTOGRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JAX_TOL = 1e-4

BWD_CASES = [
    # (B, H, S, P, N, Q, decay, dtype): tests/test_kernels.py's SSD cases,
    # the smoke config's scan (H=8, P=16, N=16, Q=32), several chunks with
    # a state that lives across them (decay 0.02), a chunk that is not a
    # multiple of 64, and mamba2's decays ("model": in-chunk cumsums reach
    # ~-3e3 at Q=256)
    (2, 4, 256, 32, 16, 64, 0.4, "float32"),
    (1, 2, 128, 64, 128, 32, 0.4, "float32"),
    (1, 2, 128, 32, 16, 128, 0.4, "float32"),
    (2, 2, 64, 16, 16, 16, 0.4, "bfloat16"),
    (2, 8, 64, 16, 16, 32, 0.4, "float32"),
    (2, 8, 64, 16, 16, 32, 0.4, "bfloat16"),
    (2, 3, 240, 16, 32, 48, 0.02, "float32"),
    (1, 4, 1024, 64, 128, 256, "model", "float32"),
    (1, 2, 512, 64, 128, 256, "model", "bfloat16"),
]


def _inputs(seed, B, H, S, P, N, decay):
    """xdt, a, bm, cm (model layout) and a cotangent dy, numpy fp32."""
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((B, S, H, P)) * 0.3
    if decay == "model":        # dt = softplus(N(0, 0.64)), A in [-16, -1]
        a = -np.log1p(np.exp(0.64 * rng.standard_normal((B, S, H)))) * \
            rng.uniform(1.0, 16.0, H)
    else:
        a = -np.abs(rng.standard_normal((B, S, H))) * decay
    bm = rng.standard_normal((B, S, N)) * 0.3
    cm = rng.standard_normal((B, S, N)) * 0.3
    dy = rng.standard_normal((B, S, H, P))
    return [t.astype(np.float32) for t in (xdt, a, bm, cm, dy)]


def _torch(arrays, dtype):
    xdt, a, bm, cm, dy = (torch.from_numpy(t) for t in arrays)
    return xdt.to(dtype), a, bm.to(dtype), cm.to(dtype), dy.to(dtype)


def _rel_err(got, ref) -> float:
    got = torch.as_tensor(np.array(got, np.float32)) \
        if not isinstance(got, torch.Tensor) else got.detach().float()
    ref = torch.as_tensor(np.array(ref, np.float32)) \
        if not isinstance(ref, torch.Tensor) else ref.detach().float()
    assert got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    return ((got - ref).abs().max() / ref.abs().max()).item()


# -- K3's plain backward ---------------------------------------------------

@pytest.mark.parametrize("B,H,S,P,N,Q,decay,dtype", BWD_CASES)
def test_ssd_bwd_reference_matches_autograd(B, H, S, P, N, Q, decay, dtype):
    xdt, a, bm, cm, dy = _torch(_inputs(0, B, H, S, P, N, decay),
                                getattr(torch, dtype))
    leaves = [t.clone().requires_grad_() for t in (xdt, a, bm, cm)]
    exp = torch.autograd.grad(ssd_chunked_reference(*leaves, Q), leaves, dy)
    got = ssd_chunked_backward_reference(xdt, a, bm, cm, dy, Q)
    for name, g, e, t in zip(("dx", "da", "dB", "dC"), got, exp,
                             (xdt, a, bm, cm)):
        assert g.shape == t.shape and g.dtype == t.dtype, name
        tol = AUTOGRAD_TOL["float32" if name == "da" else dtype]
        assert _rel_err(g, e) <= tol, name


@pytest.mark.parametrize("decay", [0.02, "model"])
def test_ssd_bwd_reference_fp32_is_near_its_fp64_run(decay):
    """Where the card's fp32 bound (kernel against plain, 1e-4 of the
    largest entry) comes from: the plain backward in fp32 is within it of
    the same formulas in fp64, at the training path's P, N and Q over four
    chunks (5.2e-5 seen, in da at mamba2's decays; ~1e-6 at mild decays).
    Each fp32 version sums in its own order; the bound is the size of the
    fp32 error, not of a difference between two versions."""
    args = _torch(_inputs(5, 1, 4, 1024, 64, 128, decay), torch.float32)
    got = ssd_chunked_backward_reference(*args, 256)
    exp = ssd_chunked_backward_reference(*(t.double() for t in args), 256)
    for name, g, e in zip(("dx", "da", "dB", "dC"), got, exp):
        assert g.dtype == torch.float32 and e.dtype == torch.float64, name
        assert _rel_err(g, e) <= 1e-4, name


@pytest.mark.parametrize("B,H,S,P,N,Q,decay,dtype",
                         [c for c in BWD_CASES if c[-1] == "float32"])
def test_ssd_bwd_reference_matches_jax_oracle_vjp(B, H, S, P, N, Q, decay,
                                                  dtype):
    """Against ``jax.vjp`` of the JAX package's sequential oracle, in its
    (B, H, S, P) layout."""
    xdt, a, bm, cm, dy = _inputs(1, B, H, S, P, N, decay)
    _, vjp = jax.vjp(jref.ssd_reference,
                     jnp.asarray(xdt.transpose(0, 2, 1, 3)),
                     jnp.asarray(a.transpose(0, 2, 1)), jnp.asarray(bm),
                     jnp.asarray(cm))
    jdx, jda, jdb, jdc = vjp(jnp.asarray(dy.transpose(0, 2, 1, 3)))
    got = ssd_chunked_backward_reference(*_torch((xdt, a, bm, cm, dy),
                                                 torch.float32), Q)
    exp = (np.asarray(jdx).transpose(0, 2, 1, 3),
           np.asarray(jda).transpose(0, 2, 1), jdb, jdc)
    for name, g, e in zip(("dx", "da", "dB", "dC"), got, exp):
        assert _rel_err(g, e) <= JAX_TOL, name


@pytest.mark.parametrize("decay", [0.5, "model"])
def test_model_ssd_chunked_gradients_match_jax(decay):
    """The model-level ``ssd_chunked`` (port: through ``ops.ssd_scan``) at
    (x, dt, A, Bm, Cm) against ``jax.vjp`` of the JAX package's, whose
    final state gets a zero cotangent (the model discards it)."""
    rng = np.random.default_rng(2)
    B, H, S, P, N, Q = 2, 4, 128, 16, 32, 32
    x = (rng.standard_normal((B, S, H, P)) * 0.3).astype(np.float32)
    if decay == "model":
        dt = np.log1p(np.exp(0.64 * rng.standard_normal((B, S, H))))
        A = -rng.uniform(1.0, 16.0, H)
    else:
        dt = np.abs(rng.standard_normal((B, S, H))) * decay + 0.1
        A = -np.abs(rng.standard_normal((H,))) - 0.5
    dt, A = dt.astype(np.float32), A.astype(np.float32)
    bm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    (jy, jstate), vjp = jax.vjp(
        lambda *t: jssm.ssd_chunked(*t, chunk=Q),
        *map(jnp.asarray, (x, dt, A, bm, cm)))
    jgrads = vjp((jnp.asarray(dy), jnp.zeros_like(jstate)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, dt, A, bm,
                                                              cm)]
    y = tssm.ssd_chunked(*leaves, chunk=Q)
    assert _rel_err(y, jy) <= 1e-5
    tgrads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for name, g, e in zip(("dx", "ddt", "dA", "dB", "dC"), tgrads, jgrads):
        assert _rel_err(g, e) <= JAX_TOL, name


def test_ssd_scan_fn_backward_takes_the_bwd_wrapper_on_the_cpu():
    """``SSDScanFn`` on CPU tensors (the card's autograd function, its
    backward through ``ssd_scan_bwd``'s CPU branch) gives autograd's
    gradients of the plain version; CPU calls are no launches."""
    xdt, a, bm, cm, dy = _torch(_inputs(3, 2, 4, 128, 16, 32, 0.02),
                                torch.float32)
    leaves = [t.clone().requires_grad_() for t in (xdt, a, bm, cm)]
    exp = torch.autograd.grad(ssd_chunked_reference(*leaves, 64), leaves,
                              dy)
    ops.reset_counts()
    leaves = [t.clone().requires_grad_() for t in (xdt, a, bm, cm)]
    y = ss.SSDScanFn.apply(*leaves, 64)
    torch.testing.assert_close(y, ssd_chunked_reference(xdt, a, bm, cm, 64),
                               atol=0, rtol=0)
    got = torch.autograd.grad(y, leaves, dy)
    for name, g, e in zip(("dx", "da", "dB", "dC"), got, exp):
        assert _rel_err(g, e) <= AUTOGRAD_TOL["float32"], name
    assert ops.launch_counts()["ssd_scan_bwd"] == 0
    assert ss.ssd_scan_bwd.path_launches == {"fma": 0, "wgmma": 0}
    assert ops.launch_counts()["ssd_scan"] == 0


def test_ssd_scan_bwd_checks_its_inputs():
    xdt, a, bm, cm, dy = _torch(_inputs(4, 1, 2, 64, 16, 16, 0.4),
                                torch.float32)
    dx, da, db, dc = ops.ssd_scan_bwd(xdt, a, bm, cm, dy, chunk=32)
    assert (dx.shape, da.shape, db.shape, dc.shape) == (
        xdt.shape, a.shape, bm.shape, cm.shape)
    assert da.dtype == torch.float32
    with pytest.raises(ValueError, match="dy"):
        ops.ssd_scan_bwd(xdt, a, bm, cm, dy[:, :, :1], chunk=32)
    with pytest.raises(ValueError, match="dy"):
        ops.ssd_scan_bwd(xdt, a, bm, cm, dy.double(), chunk=32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan_bwd(xdt, a, bm, cm, dy, chunk=48)
    # a tensor on a device with no kernel raises; a meta one (a dry run's)
    # gives the gradients' shapes and dtypes, computing nothing
    elsewhere = [t.as_subclass(_Elsewhere) for t in (xdt, a, bm, cm, dy)]
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.ssd_scan_bwd(*elsewhere, chunk=32)
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in (xdt, a, bm, cm, dy)]
    got = ops.ssd_scan_bwd(*meta, chunk=32)
    assert [(g.shape, g.dtype, g.is_meta) for g in got] == \
        [(t.shape, t.dtype, True) for t in (dx, da, db, dc)]


class _Elsewhere(torch.Tensor):
    """A tensor that reports a device with no kernel (neither the CPU, a
    card, nor meta)."""

    @property
    def device(self):
        return torch.device("xpu")


def test_ssd_scan_bwd_reads_strided_inputs_on_the_cpu():
    """The CPU branch takes the model's views as they are: (B, S, H, P)
    transposes of xdt, a and dy, and B and C cut from one wider projection
    give the contiguous inputs' gradients bit for bit."""
    args = _torch(_inputs(5, 2, 3, 128, 16, 32, 0.02), torch.float32)
    tview = lambda t: t.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.cat([args[2], args[3], args[2]], dim=-1)
    views = (tview(args[0]), tview(args[1]), wide[..., :32],
             wide[..., 32:64], tview(args[4]))
    assert not views[0].is_contiguous() and not views[2].is_contiguous()
    for g, e in zip(ops.ssd_scan_bwd(*views, chunk=32),
                    ops.ssd_scan_bwd(*args, chunk=32)):
        assert torch.equal(g, e)


# -- K3's backward on the card: its path, and its bf16 roundings ----------

@pytest.mark.parametrize("dtype,P,N,Q,path", [
    (torch.bfloat16, 64, 128, 256, "wgmma"),     # mamba2-370m's training
    (torch.bfloat16, 64, 64, 256, "wgmma"),      # zamba2-2.7b's training
    (torch.bfloat16, 16, 16, 64, "wgmma"),
    (torch.bfloat16, 48, 96, 192, "wgmma"),
    (torch.bfloat16, 64, 128, 320, "fma"),       # five 64-row tiles a chunk
    (torch.bfloat16, 64, 128, 512, "fma"),
    (torch.bfloat16, 16, 16, 32, "fma"),         # the smoke config's chunk
    (torch.bfloat16, 32, 64, 100, "fma"),        # not whole 64-row tiles
    (torch.bfloat16, 72, 128, 256, "fma"),       # P past 64 (the card refuses)
    (torch.bfloat16, 64, 136, 256, "fma"),       # N past 128
    (torch.bfloat16, 40, 128, 256, "fma"),       # P not a multiple of 16
    (torch.float32, 64, 128, 256, "fma"),        # fp32 never takes TF32
])
def test_ssd_bwd_path_choice(dtype, P, N, Q, path):
    """K3's backward path is a pure function of the dtype and the shapes:
    the tensor cores for bfloat16 with P and N multiples of 16 up to 64
    and 128 and a chunk of one to four whole 64-row tiles, fp32 FMAs
    otherwise."""
    assert ss.select_bwd_path(dtype, P, N, Q) == path
    assert path in ss.BWD_PATHS


def test_ssd_bwd_path_of_the_training_configs():
    """mamba2-370m's and zamba2-2.7b's bf16 training scans take the
    backward's wgmma path (and the forward's), the fp32 smoke configs' the
    fma path."""
    from repro_torch.models import params as tparams
    for arch, path in (("mamba2-370m", "wgmma"), (ARCH, "fma"),
                       ("zamba2-2.7b", "wgmma"), ("zamba2-2.7b-smoke", "fma")):
        cfg = get_config(arch)
        assert ss.select_path(tparams.torch_dtype(cfg.dtype),
                              cfg.ssm.head_dim, cfg.ssm.state_size,
                              cfg.ssm.chunk_size) == path, arch
        assert ss.select_bwd_path(tparams.torch_dtype(cfg.dtype),
                                  cfg.ssm.head_dim, cfg.ssm.state_size,
                                  cfg.ssm.chunk_size) == path, arch


def test_bwd_rounding_model_with_exact_operands_is_the_plain_backward():
    """``ssd_rounding.model_grads`` with every operand exact is the plain
    backward in fp64 (its 64-row sub-chunk states, M = sum_h D o L and the
    state terms as row scales are the same function), up to the final
    rounding of each output: bf16 for dx, dB, dC, fp32 for da."""
    args = ssd_rounding.grad_inputs(1, 2, 3, 512, 32, 64, 0.02)
    got = ssd_rounding.model_grads(*args, 128, states=None, rows=None,
                                   gl=None, m=None)
    exp = ssd_chunked_backward_reference(*(t.double() for t in args), 128)
    for name, g, e, tol in zip(("dx", "da", "dB", "dC"), got, exp,
                               (2 ** -8, 1e-7, 2 ** -8, 2 ** -8)):
        assert g.dtype == (torch.float32 if name == "da" else torch.bfloat16)
        assert _rel_err(g.double(), e) <= tol, name


def test_bwd_wgmma_rounding_model_holds_the_tolerance():
    """The backward's wgmma path rounds as ``model_grads`` does by default:
    the carried states, their chunk sums' decayed rows and M split into
    bf16 hi + lo, G o L rounded once, outputs rounded once.  At S = 4096
    (16 chunks of 256, the training path's P, N, Q) and mamba2's decays
    that keeps every output within SSD_BWD_TOL of the fp32 plain version,
    with room (at the full training shape, B=8 and H=32, it is 0.34 of the
    bound at worst: ``python -m repro_torch.kernels.ssd_rounding bwd``)."""
    args = ssd_rounding.grad_inputs(0, 1, 4, 4096, 64, 128)
    ref = ssd_chunked_backward_reference(*args, 256)
    got = ssd_rounding.model_grads(*args, 256)
    for a_, r_ in zip(got, ref):
        assert a_.shape == r_.shape and a_.dtype == r_.dtype
    ratios = ssd_rounding.bwd_ratios(got, ref)
    assert max(ratios) < 0.7, ratios


def test_bwd_wgmma_rounding_model_at_zamba2s_shape():
    """zamba2-2.7b's scan: 80 heads (dB and dC sum 2.5x mamba2's 32) of
    P = 64 at N = 64, over 16 chunks of 256, at mamba2's decays, B cut to
    1.  The same roundings keep every output within SSD_BWD_TOL, with
    room: 0.45 of the bound at worst (dx) at the full training shape,
    B = 8 (``python -m repro_torch.kernels.ssd_rounding bwd 80 64 8``), so
    no operand needs another split."""
    args = ssd_rounding.grad_inputs(0, 1, 80, 4096, 64, 64)
    ref = ssd_chunked_backward_reference(*args, 256)
    ratios = ssd_rounding.bwd_ratios(ssd_rounding.model_grads(*args, 256),
                                     ref)
    assert max(ratios) < 0.7, ratios


def test_bwd_rounding_the_states_once_misses_da():
    """Why the states go in split: rounding S_in and dS_out once to bf16
    where they enter their products puts da past its 1e-4 bound (da sums
    row and column sums of W that cancel, and the state terms' share of it
    is not small), while the split keeps it inside."""
    args = ssd_rounding.grad_inputs(0, 1, 4, 4096, 64, 128)
    ref = ssd_chunked_backward_reference(*args, 256)
    once = ssd_rounding.bwd_ratios(
        ssd_rounding.model_grads(*args, 256, states=False), ref)
    assert once[1] > 1.0, once
    split = ssd_rounding.bwd_ratios(ssd_rounding.model_grads(*args, 256), ref)
    assert split[1] < 1.0, split


# -- mamba2-370m-smoke training --------------------------------------------

def _jax_state(seed=0):
    cfg = j_get_config(ARCH)
    return cfg, JT.init_state(cfg, JAdamW(learning_rate=1e-3), seed)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


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


def test_training_steps_match_jax():
    """Six AdamW steps of mamba2-370m-smoke from JAX's initial state on the
    same batches: losses within 1e-4, as the dense family's."""
    jcfg, jstate = _jax_state()
    cfg = get_config(ARCH)
    ds = JDataset(jcfg, SHAPE)
    jstep = jax.jit(JT.make_train_step(jcfg, JAdamW(learning_rate=1e-3)))
    tstep = TT.make_train_step(cfg, AdamW(learning_rate=1e-3))
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
    """Activation checkpointing of every layer (``cfg.remat``, which
    mamba2-370m sets) recomputes the same operations: loss and gradients
    equal the plain run's bit for bit."""
    _, jstate = _jax_state()
    batch = _torch_batch(JDataset(j_get_config(ARCH), SHAPE).batch_at(0))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(get_config(ARCH), remat=remat)
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
    return runner, losses


def test_elastic_run_equals_static(deterministic):
    """Listing 2 on the SSM family: the elastic run (4 -> 8 -> 2 workers)
    gives the static run's losses exactly; each resize moves the whole
    state."""
    cfg = get_config(ARCH)
    app = lm_train_app(cfg, SHAPE, AdamW(learning_rate=1e-3), seed=0)
    _, static = _run(app, {})
    runner, elastic = _run(app, {2: 8, 4: 2})
    assert elastic == static
    assert all(np.isfinite(static)) and static[-1] < static[0]
    assert [(e.action, e.from_procs, e.to_procs) for e in runner.events] == \
        [("expand", 4, 8), ("shrink", 8, 2)]
    _, jstate = _jax_state()
    nbytes = sum(np.asarray(l).nbytes for l in jax.tree.leaves(jstate))
    assert [e.transfer.bytes_moved for e in runner.events] == [nbytes] * 2


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
