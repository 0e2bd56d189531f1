"""The port's dry-run tooling against the JAX package's, on the CPU.

``launch/roofline.py``'s analytic counts equal the JAX package's exactly;
the meta trees (``abstract_params``, ``abstract_state``, ``input_specs``,
a decode cache) have the paths, shapes and dtypes of the JAX package's
abstract ones (``jax.eval_shape``: nothing is compiled); the placements of
a decode cache equal JAX's specs, and a worker's argument bytes on the
(16, 16) production mesh equal a count from JAX's specs; ``flopcount``
counts a granite-smoke training step to the integer worked out by hand;
the kernels' wrappers pass meta tensors through (shapes only, no launch);
the dry-run CLI writes a record that ``report`` tabulates.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.data.pipeline import input_specs as j_input_specs
from repro.dmr.patterns import _path_str
from repro.launch import roofline as JR
from repro.models import model as JM
from repro.models import train as JT
from repro.optim import AdamW as JAdamW
from repro.parallel import sharding as JS
from repro_torch import tree as T
from repro_torch.configs import SHAPES, all_configs, get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import input_specs
from repro_torch.kernels import blockcyclic as bc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import meta as kmeta
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, flopcount, report
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import (make_production_mesh, mesh_device_set)
from repro_torch.models import model as M
from repro_torch.models import train as TT
from repro_torch.optim import AdamW
from repro_torch.parallel import sharding as S
from repro_torch.parallel.mesh import (Placement, default_device,
                                       logical_workers)

ARCHS = list(all_configs())


def _jax_flat(tree):
    return [(_path_str(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _torch_flat(tree):
    return [(p, tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in T.flatten(tree)]


class _Mesh:
    """What JAX's ``spec_for_axes`` and ``cache_shardings`` read of a mesh
    (``AbstractMesh``'s constructor raises under JAX 0.9.0)."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data",
                                                        "model")),
          ((2, 4), ("data", "model")), ((1, 8), ("data", "model"))]


# ----------------------------------------------------------------------
# roofline: the analytic counts
# ----------------------------------------------------------------------

@pytest.mark.parametrize("layers", [None, 1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_jax(arch, layers):
    """Every config, at its depth and cut to 1 and 3 layers, every shape:
    the same numbers, exactly."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    assert R.param_counts(cfg) == JR.param_counts(jcfg)
    for s, js in zip(SHAPES, J_SHAPES):
        assert R.model_flops(cfg, s) == JR.model_flops(jcfg, js), s.name


def test_roofline_constants_are_the_cards():
    """The H100's bf16 dense peak and HBM rate; the card's memory from
    torch (80 GB with no card); no collective term on one card."""
    assert R.PEAK_FLOPS == 989.4e12 and R.HBM_BW == 3.35e12
    assert R.card_bytes() == R.DEFAULT_CARD_BYTES == 80e9
    counted = flopcount.FlopCount(2e12, 1e9, 2e12, {}, {}, {}, 1)
    cfg, shape = get_config("granite-3-2b"), get_shape("train_4k")
    rl = R.build_roofline(cfg, shape, "card", 1, counted, 1e9)
    assert rl.collective_s == 0.0 and rl.bottleneck == "compute"
    assert rl.compute_s == 2e12 / 989.4e12
    assert rl.useful_ratio == R.model_flops(cfg, shape) / 2e12
    assert R.measured_mfu(989.4e12, 2.0) == 0.5


# ----------------------------------------------------------------------
# meta trees against JAX's abstract ones
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_state_equal_jax(arch):
    """Paths, shapes and dtypes of the parameter tree and the TrainState
    (the moments in the optimizer's moment dtype) equal ``jax.eval_shape``
    of the JAX package's ``init_params`` / ``init_state``; nothing is
    allocated."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    params = M.abstract_params(cfg)
    assert _torch_flat(params) == _jax_flat(JM.abstract_params(jcfg))
    assert all(t.is_meta for t in T.leaves(params))
    mdt = cfg.opt_moment_dtype
    state = TT.abstract_state(cfg, AdamW(moment_dtype=mdt))
    jstate = jax.eval_shape(lambda: JT.init_state(
        jcfg, JAdamW(moment_dtype=mdt)))
    assert _torch_flat(state) == _jax_flat(jstate)
    assert all(t.is_meta for t in T.leaves(state))
    # the reference's own abstract_state differs only in rng's shape
    ref = _jax_flat(JT.abstract_state(jcfg, JAdamW(moment_dtype=mdt)))
    assert [x for x in _torch_flat(state) if x[0] != "rng"] == \
        [x for x in ref if x[0] != "rng"]


def test_abstract_state_matches_init_state():
    """The meta state is ``init_state``'s, leaf for leaf."""
    cfg = get_config("granite-3-2b-smoke")
    opt = AdamW()
    assert _torch_flat(TT.abstract_state(cfg, opt)) == \
        _torch_flat(TT.init_state(cfg, opt, 0))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "seamless-m4t-medium",
                                  "pixtral-12b", "mamba2-370m"])
def test_input_specs_equal_jax(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    got = input_specs(cfg, get_shape(shape))
    exp = j_input_specs(jcfg, get_shape(shape))
    assert list(got) == list(exp)
    for k in exp:
        assert got[k].is_meta
        assert (tuple(got[k].shape), str(got[k].dtype).split(".")[-1]) == \
            (tuple(exp[k].shape), str(exp[k].dtype)), k


# ----------------------------------------------------------------------
# placements on the production meshes
# ----------------------------------------------------------------------

def test_production_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert single.device.type == "meta"
    assert mesh_device_set(multi) == set(range(512))
    with pytest.raises(ValueError):
        type(single)(single.devices, ("pod", "data", "model"))


@pytest.mark.parametrize("mesh_shape,names", MESHES)
@pytest.mark.parametrize("arch,shape", [
    ("granite-3-2b", "decode_32k"), ("granite-3-2b", "long_500k"),
    ("mamba2-370m", "decode_32k"), ("mamba2-370m", "long_500k"),
    ("zamba2-2.7b", "decode_32k"), ("seamless-m4t-medium", "decode_32k"),
    ("qwen2.5-32b", "decode_32k")])
def test_cache_shardings_match_jax_specs(arch, shape, mesh_shape, names,
                                         monkeypatch):
    """Every decode-cache leaf's placement equals the JAX package's
    ``cache_shardings`` spec on a mesh of the same shape (batch, sequence,
    SSM heads and conv channels)."""
    monkeypatch.setattr(JS, "_named", lambda mesh, spec: spec)
    cfg, jcfg, shp = get_config(arch), j_get_config(arch), get_shape(shape)
    B, S_ = shp.global_batch, shp.seq_len
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, S_, enc_len=S_))
    exp = jax.tree.leaves(JS.cache_shardings(
        jcfg, shp, _Mesh(mesh_shape, names), jcache),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    cache = M.init_cache(cfg, B, S_, device="meta", enc_len=S_)
    assert _torch_flat(cache) == _jax_flat(jcache)
    mesh = _Mesh(mesh_shape, names)
    got = T.leaves(S.cache_shardings(cfg, shp, mesh, cache))
    assert got == [Placement(mesh, tuple(p)) for p in exp]


def _jax_local_bytes(specs, shapes_dtypes, mesh):
    total = 0
    for spec, (shape, itemsize) in zip(specs, shapes_dtypes):
        n = list(shape)
        for i, e in enumerate(tuple(spec)):
            if e:
                n[i] //= math.prod(mesh.shape[a] for a in
                                   ((e,) if isinstance(e, str) else e))
        total += math.prod(n) * itemsize
    return total


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi4-mini-3.8b",
                                  "qwen2.5-32b", "mixtral-8x7b",
                                  "zamba2-2.7b"])
def test_worker_argument_bytes_on_the_production_mesh(arch):
    """A worker's share of a train_4k step's state and batch on (16, 16):
    the dry run's bytes equal a count from the JAX package's
    ``spec_for_axes`` specs (params and both moments) and batch axes."""
    cfg, jcfg, shp = get_config(arch), j_get_config(arch), \
        get_shape("train_4k")
    jmesh = _Mesh((16, 16), ("data", "model"))
    rules = JS.rules_for(jcfg)
    defs = jax.tree.leaves(JM.model_schema(jcfg),
                           is_leaf=lambda x: hasattr(x, "axes"))
    specs = [JS.spec_for_axes(d.axes, rules, jmesh, d.shape) for d in defs]
    msize = np.dtype(jcfg.opt_moment_dtype).itemsize
    state = sum(_jax_local_bytes(specs, [(d.shape, isz) for d in defs],
                                 jmesh) for isz in
                (np.dtype(jcfg.param_dtype).itemsize, msize, msize)) + 20
    batch_axes = JS._batch_axes(jmesh, shp.global_batch)
    rows = shp.global_batch // math.prod(jmesh.shape[a] for a in batch_axes)
    batch = sum(rows * x.shape[1] * x.dtype.itemsize
                for x in j_input_specs(jcfg, shp).values())
    _, args = dryrun.abstract_args(cfg, shp)
    got = dryrun.argument_bytes(cfg, shp, args, make_production_mesh())
    assert got == {"state": state, "batch": batch}
    # the whole state: params and both moments, and four scalars (step,
    # count, data_cursor, rng's two words) of 20 bytes
    whole = dryrun.argument_bytes(cfg, shp, args)
    leaves = T.leaves(args["state"].params)
    assert whole["state"] == sum(t.numel() * (t.element_size() + 2 * msize)
                                 for t in leaves) + 20


# ----------------------------------------------------------------------
# flopcount
# ----------------------------------------------------------------------

def test_flopcount_counts_a_granite_smoke_step_by_hand():
    """granite-3-2b-smoke (2 layers, d 64, 4 heads over 2 of 16, d_ff 128,
    vocab 256 tied, fp32, no remat) at 8 x 64 tokens: every product x @ W
    of N = 512 tokens costs 2 N a b forward and twice that backward (dx and
    dW): per layer q, k, v, o (64x64, 64x32, 64x32, 64x64) and the MLP's
    gate, up, down (64x128, 64x128, 128x64), and the tied unembedding
    (64x256); K1 over its causal pairs (64 x 65 / 2 a head, 8 x 4 heads),
    4 D a pair forward and 10 D backward."""
    cfg = get_config("granite-3-2b-smoke")
    shape = ShapeConfig("t", "train", 64, 8)
    N, L, D = 8 * 64, 2, 16
    ab = 64 * 64 + 64 * 32 + 64 * 32 + 64 * 64 + 3 * 64 * 128
    products = 6 * N * (L * ab + 64 * 256)
    assert products == 276_824_064
    pairs = 8 * 4 * (64 * 65 // 2)
    step, args = dryrun.abstract_args(cfg, shape)
    c = flopcount.count(step, *args.values())
    assert c.product_flops == products
    assert c.kernel_calls == {"flash_attention": L, "flash_attention_bwd": L}
    assert c.kernel_flops == {"flash_attention": L * 4 * D * pairs,
                              "flash_attention_bwd": L * 10 * D * pairs}
    assert c.flops == products + L * 14 * D * pairs == 306_642_944
    # bytes: q, k, v and out once a forward (fp32), and the lse beside
    assert c.kernel_bytes["flash_attention"] == L * (
        2 * 8 * 4 * 64 * D * 4 + 2 * 8 * 2 * 64 * D * 4 + 4 * 8 * 4 * 64)
    assert c.hbm_bytes > sum(c.kernel_bytes.values()) and c.n_ops > 100


def test_flopcount_with_remat_counts_the_recomputation():
    """Under remat a layer's forward runs again in the backward: K1's
    forward twice a layer, and the products' forward again up to the last
    one whose output the backward needs (non-reentrant checkpointing stops
    there): every product but the MLP's down projection (128 x 64)."""
    cfg = dataclasses.replace(get_config("granite-3-2b-smoke"), remat=True)
    step, args = dryrun.abstract_args(cfg, ShapeConfig("t", "train", 64, 8))
    c = flopcount.count(step, *args.values())
    assert c.kernel_calls == {"flash_attention": 4, "flash_attention_bwd": 2}
    N, ab = 512, 64 * 64 + 64 * 32 + 64 * 32 + 64 * 64 + 3 * 64 * 128
    assert c.product_flops == 2 * (8 * N * ab - 2 * N * 128 * 64) + \
        6 * N * 64 * 256


@pytest.mark.parametrize("arch", ["mamba2-370m-smoke", "zamba2-2.7b-smoke",
                                  "mixtral-8x7b-smoke",
                                  "seamless-m4t-medium-smoke",
                                  "pixtral-12b-smoke"])
def test_every_family_steps_on_meta(arch):
    """Each family's training step runs on meta: its kernels are counted
    by their work and the useful ratio is a share."""
    cfg = get_config(arch)
    rec = dryrun.run_cell(arch, "smoke", "card", verbose=False)
    assert rec["status"] == "ok", rec["status"]
    kern = rec["count"]["kernel_calls"]
    if cfg.is_ssm or cfg.is_hybrid:
        assert kern["ssd_scan"] == kern["ssd_scan_bwd"] == cfg.num_layers
    if not cfg.is_ssm:
        assert kern["flash_attention"] == kern["flash_attention_bwd"] > 0
    assert 0 < rec["roofline"]["useful_ratio"] < 1.5


def test_attention_pairs():
    assert kmeta.attention_pairs(4, 4, True) == 10
    assert kmeta.attention_pairs(4, 4, False) == 16
    assert kmeta.attention_pairs(1, 512, False, kv_len=384) == 384
    assert kmeta.attention_pairs(6, 6, True, window=2) == 1 + 5 * 2
    assert kmeta.attention_pairs(3, 5, True) == 6          # top-left
    brute = sum(min(i + 1, 100) for i in range(300))
    assert kmeta.attention_pairs(300, 300, True, window=100) == brute


# ----------------------------------------------------------------------
# the wrappers on meta tensors
# ----------------------------------------------------------------------

def test_meta_tensors_pass_through_every_wrapper():
    """Shapes, dtypes and K1's (B, Sq, H, D) layout of each output, the
    call's work recorded, no launch counted, no path taken; gradients
    through K1 and K3 take their backward's meta branch."""
    ops.reset_counts()
    m = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty(2, 6, 64, 32, **m).requires_grad_()
    k, v = (torch.empty(2, 2, 64, 32, **m).requires_grad_()
            for _ in range(2))
    with kmeta.recording() as calls:
        out = ops.flash_attention(q, k, v, causal=True)
        out.sum().backward()
        o2, lse = fa.flash_attention_lse(q.detach(), k.detach(), v.detach())
        x = torch.empty(1, 128, 2, 16, **m).requires_grad_()
        a = torch.empty(1, 128, 2, device="meta").requires_grad_()
        bm = torch.empty(1, 128, 16, **m).requires_grad_()
        y = ops.ssd_scan(x, a, bm, bm, chunk=64)
        y.sum().backward()
        r = ops.repack(torch.empty(5, 4, 8, device="meta"), [4, 0, 2])
    assert out.shape == (2, 6, 64, 32) and out.dtype == torch.bfloat16
    assert out.is_meta and out.stride() == (6 * 64 * 32, 32, 6 * 32, 1)
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert lse.shape == (2, 6, 64) and lse.dtype == torch.float32
    assert y.shape == x.shape and x.grad.shape == x.shape
    assert a.grad.dtype == torch.float32 and bm.grad.shape == bm.shape
    assert r.shape == (3, 4, 8) and r.is_meta
    assert [c.kernel for c in calls] == [
        "flash_attention", "flash_attention_bwd", "flash_attention",
        "ssd_scan", "ssd_scan_bwd", "repack"]
    assert calls[0].flops == 4 * 32 * 2 * 6 * (64 * 65 // 2)
    assert calls[-1] == kmeta.KernelWork("repack", 0, 2 * 3 * 4 * 8 * 4)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert all(n == 0 for fn in ops.KERNELS.values()
               for n in fn.path_launches.values())
    with pytest.raises(IndexError):
        ops.repack(torch.empty(5, 4, 8, device="meta"), [5])
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :3], v, causal=True)


def test_a_card_request_with_no_card_raises():
    """Asking for the card where there is none raises: the default device
    of every entry point, a worker pool, a tensor on it, and the dry
    run's measured step."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    with pytest.raises(RuntimeError):
        logical_workers(8)
    with pytest.raises((RuntimeError, AssertionError)):
        torch.empty(1, device="cuda")
    cfg, shape = dryrun.cell_config("granite-3-2b-smoke", "smoke")
    with pytest.raises((RuntimeError, AssertionError)):
        dryrun.measure_cell(cfg, shape, 0.0)


def test_repack_meta_checks_its_indices():
    with pytest.raises(ValueError):
        bc.repack(torch.empty(4, 2, 3, device="meta"),
                  torch.zeros(1, dtype=torch.long, device="meta"))


# ----------------------------------------------------------------------
# the CLI and the report
# ----------------------------------------------------------------------

def test_dryrun_cli_writes_a_record_the_report_tabulates(tmp_path, capsys):
    rc = dryrun.main(["--arch", "granite-3-2b-smoke", "--shape", "smoke",
                      "--mesh", "card", "--out", str(tmp_path)])
    assert rc == 0
    dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(tmp_path)])
    dryrun.main(["--arch", "granite-3-2b", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == ["granite-3-2b-smoke__smoke__card__L2.json",
                     "granite-3-2b__long_500k__pod16x16__L40.json",
                     "mamba2-370m__long_500k__pod16x16__L48.json"]
    rec = json.loads((tmp_path / files[0]).read_text())
    assert rec["status"] == "ok" and rec["chips"] == 1
    assert rec["roofline"]["model_flops"] == R.model_flops(
        get_config("granite-3-2b-smoke"), get_shape("smoke"))
    m = rec["memory"]
    assert m["resize_clone_gb"] == m["state_gb"] and m["fits_card"]
    capsys.readouterr()
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "cells: 2 ok / 1 skipped / 0 not countable on meta / 0 FAILED" \
        in out
    assert "| granite-3-2b-smoke | smoke | 2 |" in out
    assert "skipped:" in out and "| mamba2-370m | long_500k | 48 |" in out
