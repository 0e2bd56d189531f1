"""Dry run of the port: size and score every (arch x shape x mesh) cell on
meta tensors, and on the card check the sizing (port of
``repro/launch/dryrun.py``).

Per cell it records:
  * ``status`` (``shape_applicable``'s verdict);
  * the argument bytes, exactly, from the meta trees
    (``models/train.py::abstract_state``, ``data/pipeline.py::input_specs``,
    ``model.init_cache`` on meta): the state (or parameters), the batch and
    a decode step's cache -- per worker on a logical production mesh
    (``--mesh single``: (16, 16); ``multi``: (2, 16, 16)), whole on one card
    (``--mesh card``), where it adds the gradients (one per parameter) and
    the state a resize clones (every leaf, by the ``default`` pattern);
  * one step's FLOPs and HBM bytes counted on meta (``launch/flopcount.py``)
    and the roofline terms (``launch/roofline.py``).  On a production mesh
    the step runs inside ``sharding_context(mesh, rules_for(cfg))``, as
    the reference's lowering does, so its attention and MoE layers go
    through their sharded bodies (``parallel/spmd.py``) over the mesh's
    logical workers: K1 once per sequence shard, counted by its offset
    pairs; each shard's expert products;
  * ``fits_card``.

The JAX package reads a compiled step's temporaries from XLA's memory
analysis.  Nothing on meta can know them, so nothing here guesses them:
with ``--measure`` (on the card) the cell runs one real step at the cut
(random weights from seed 0, a warm step then a timed one) and records
``peak_gb`` (``torch.cuda.max_memory_allocated``), ``temp_gb`` (the peak
less the argument bytes), ``step_s`` and the measured MFU.

Usage:
  python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k \\
      --layers 8 --global-batch 8 --mesh single          # meta only, any host
  python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape train_4k \\
      --layers 8 --global-batch 8 --mesh card --measure  # on the card
  python -m repro_torch.launch.dryrun --all --mesh single --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import tree as T
from repro_torch.configs import (SHAPES, all_configs, get_config, get_shape,
                                 shape_applicable)
from repro_torch.data.pipeline import input_specs
from repro_torch.launch import flopcount
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (build_roofline, card_bytes,
                                         measured_mfu)
from repro_torch.models import model as M
from repro_torch.models.train import (abstract_state, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.optim import AdamW
from repro_torch.parallel.context import sharding_context
from repro_torch.parallel.mesh import default_device
from repro_torch.parallel.sharding import (batch_shardings, cache_shardings,
                                           param_shardings, rules_for,
                                           state_shardings)

MESHES = {"single": "pod16x16", "multi": "pod2x16x16", "card": "card"}
GB = 1e9


def cell_config(arch: str, shape_name: str, layers=None, global_batch=None):
    """(cfg, shape) of a cell, cut to ``layers`` and ``global_batch``."""
    cfg, shape = get_config(arch), get_shape(shape_name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=global_batch)
    return cfg, shape


def optimizer_for(cfg) -> AdamW:
    return AdamW(learning_rate=1e-4, moment_dtype=cfg.opt_moment_dtype)


def abstract_args(cfg, shape):
    """A cell's step function and its arguments as meta trees, by role:
    ``{"state" | "params", "batch" | "cache" + "tokens"}``."""
    if shape.kind == "train":
        return make_train_step(cfg, optimizer_for(cfg)), {
            "state": abstract_state(cfg, optimizer_for(cfg)),
            "batch": input_specs(cfg, shape)}
    params = M.abstract_params(cfg)
    if shape.kind == "prefill":
        return make_prefill_step(cfg), {"params": params,
                                        "batch": input_specs(cfg, shape)}
    B, S = shape.global_batch, shape.seq_len
    serve = make_serve_step(cfg)
    index = torch.empty((), dtype=torch.int32, device="meta")

    def decode(params, cache, tokens):          # one token at the cache's end
        return serve(params, cache, tokens["tokens"], index)

    return decode, {
        "params": params,
        "cache": M.init_cache(cfg, B, S, device="meta", enc_len=S),
        "tokens": {"tokens": torch.empty((B, 1), dtype=torch.int32,
                                         device="meta")}}


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in T.leaves(tree))


def argument_bytes(cfg, shape, args, mesh=None) -> dict:
    """Bytes of each argument, whole (``mesh`` None) or per worker of
    ``mesh`` (its placements' local parts)."""
    if mesh is None:
        return {k: _bytes(v) for k, v in args.items()}
    place = {"state": lambda v: state_shardings(cfg, mesh),
             "params": lambda v: param_shardings(cfg, mesh),
             "batch": lambda v: batch_shardings(cfg, shape, mesh, v),
             "tokens": lambda v: batch_shardings(cfg, shape, mesh, v),
             "cache": lambda v: cache_shardings(cfg, shape, mesh, v)}
    return {k: sum(p.local_bytes(t) for p, t in zip(
        T.leaves(place[k](v)), T.leaves(v))) for k, v in args.items()}


def _microbatches(cfg, shape) -> int:
    """The microbatches a train step runs (``make_train_step``'s rule)."""
    mb, B = max(1, cfg.train_microbatches), shape.global_batch
    return mb if B % mb == 0 and B >= mb else 1


def grad_bytes(cfg, shape, state, mesh=None) -> int:
    """A train step's gradients, whole or per worker of ``mesh``: one per
    parameter in its dtype and, when the step runs microbatches, their
    sums beside them in the moments' dtype (``make_train_step``)."""
    params = argument_bytes(cfg, shape, {"params": state.params},
                            mesh)["params"]
    if _microbatches(cfg, shape) == 1:
        return params
    p0, m0 = T.leaves(state.params)[0], T.leaves(state.opt.mu)[0]
    return params + params * m0.element_size() // p0.element_size()


def count_cell(step, args, cfg=None, mesh=None):
    """The step's count on meta, or the reason it cannot be counted; with
    a ``mesh``, inside ``cfg``'s sharding context on it."""
    try:
        if mesh is not None:
            with sharding_context(mesh, rules_for(cfg)):
                return flopcount.count(step, *args.values()), None
        return flopcount.count(step, *args.values()), None
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f"not countable on meta: {type(e).__name__}: {e}"


def measure_cell(cfg, shape, argument: float, seed: int = 0) -> dict:
    """One real step at the cut on the card: a warm step, then a timed
    one; the peak memory over both."""
    import numpy as np
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models.train import init_state
    if shape.kind != "train":
        raise ValueError("--measure runs training cells")
    dev = default_device("cuda")
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt = optimizer_for(cfg)
    state = init_state(cfg, opt, seed, dev)
    step = make_train_step(cfg, opt)
    ds = SyntheticDataset(cfg, shape, seed=seed)
    secs = []
    for i in range(2):
        batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                 for k, v in ds.batch_at(i * ds.global_batch).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - base
    del state, batch, m
    torch.cuda.empty_cache()
    return {"peak_gb": peak / GB, "temp_gb": (peak - argument) / GB,
            "step_s": secs[-1], "warm_step_s": secs[0]}


def run_cell(arch: str, shape_name: str, mesh: str = "card", layers=None,
             global_batch=None, measure=False, out_dir=None, verbose=True):
    mesh_name = MESHES[mesh]
    cfg, shape = cell_config(arch, shape_name, layers, global_batch)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "layers": cfg.num_layers, "global_batch": shape.global_batch}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {why}")
        return _write(rec, out_dir)
    t0 = time.time()
    try:
        step, args = abstract_args(cfg, shape)
        pmesh = None if mesh == "card" else \
            make_production_mesh(multi_pod=mesh == "multi")
        chips = 1 if pmesh is None else pmesh.size
        arg = argument_bytes(cfg, shape, args, pmesh)
        counted, why = count_cell(step, args, cfg, pmesh)
    except Exception as e:                       # a failure here is a bug
        rec.update(status="FAILED", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_name}: {e}")
        return _write(rec, out_dir)
    argument = float(sum(arg.values()))
    memory = {f"{k}_gb": v / GB for k, v in arg.items()}
    memory["argument_gb"] = argument / GB
    whole = argument_bytes(cfg, shape, args) if pmesh else arg
    if shape.kind == "train":
        memory["grads_gb"] = grad_bytes(cfg, shape, args["state"],
                                        pmesh) / GB
        if pmesh is None:       # on the card a resize clones every leaf
            memory["resize_clone_gb"] = whole["state"] / GB
    need = argument + memory.get("grads_gb", 0.0) * GB
    if measure:
        memory.update(measure_cell(cfg, shape, argument))
        need = memory["peak_gb"] * GB
    memory["card_gb"] = card_bytes() / GB
    memory["fits_card"] = need <= card_bytes()
    rec.update(status="ok" if counted else why, chips=chips,
               count_s=round(time.time() - t0, 1), memory=memory)
    if counted:
        rl = build_roofline(cfg, shape, mesh_name, chips, counted, need,
                            note="collective term 0: one card, and the "
                                 "logical meshes run no collective")
        rec.update(count=counted.as_dict(), roofline=rl.as_dict())
        if measure:
            rec["measured_mfu"] = measured_mfu(rl.model_flops,
                                               memory["step_s"])
    if verbose:
        _print(rec)
    return _write(rec, out_dir)


def _print(rec):
    m = rec["memory"]
    head = (f"[{'ok' if rec['status'] == 'ok' else 'meta?'}] {rec['arch']} "
            f"x {rec['shape']} x {rec['mesh']} L={rec['layers']} "
            f"B={rec['global_batch']}: argument {m['argument_gb']:.2f} GB"
            + (f", grads {m['grads_gb']:.2f}" if "grads_gb" in m else "")
            + (f", peak {m['peak_gb']:.2f} (temp {m['temp_gb']:.2f})"
               if "peak_gb" in m else "")
            + f", fits_card={m['fits_card']}")
    if "roofline" not in rec:
        print(f"{head}; {rec['status']}")
        return
    r = rec["roofline"]
    print(f"{head}; terms c/m/n = {r['compute_s']:.3e}/{r['memory_s']:.3e}/"
          f"{r['collective_s']:.1e} s -> {r['bottleneck']}, model "
          f"{r['model_flops']:.3e} / counted {r['counted_flops']:.3e} "
          f"(useful {r['useful_ratio']:.3f}), roofline MFU {r['mfu']:.1%}"
          + (f", step {m['step_s']:.4f} s, MFU {rec['measured_mfu']:.1%}"
             if "measured_mfu" in rec else ""))


def _write(rec, out_dir):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__"
                                   f"{rec['mesh']}__L{rec['layers']}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--layers", type=int, default=None,
                   help="cut the decoder to this many layers")
    p.add_argument("--global-batch", type=int, default=None)
    p.add_argument("--mesh", choices=list(MESHES), default="single")
    p.add_argument("--measure", action="store_true",
                   help="run one real step on the card (training cells)")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="experiments/dryrun_torch")
    args = p.parse_args(argv)
    if args.measure and args.mesh != "card":
        p.error("--measure needs --mesh card")

    cells = []
    if args.all:
        cells = [(a, s.name) for a in all_configs() for s in SHAPES]
    elif args.arch and not args.shape:
        cells = [(args.arch, s.name) for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            p.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    results = [run_cell(a, s, args.mesh, args.layers, args.global_batch,
                        args.measure, args.out) for a, s in cells]
    n = {k: sum(r["status"].startswith(k) for r in results)
         for k in ("ok", "skipped", "FAILED", "not countable")}
    print(f"\n== dry-run: {n['ok']} ok / {n['skipped']} skipped / "
          f"{n['not countable']} not countable on meta / {n['FAILED']} "
          "FAILED ==")
    return 1 if n["FAILED"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
