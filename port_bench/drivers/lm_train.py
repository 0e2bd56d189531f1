"""Driver of an elastic LM training job: the paper's Listing 2 on the
port (``repro_torch.dmr.MalleableRunner`` over
``repro_torch.core.lm_app.lm_train_app``), as ``launch/train.py`` loops:
``dmr.reconfig``, the step, the loss read.

Set-up makes the weights from the seed (the reference's
:func:`make_params`, handed to the job's ``init``), builds the runner
with the traffic's resource manager, and runs the traffic's set-up
steps through the window's own calls on the seed's batches: each worker
count and each kind of resize of the schedule once.  Each set-up resize
is checked to leave the state's bits as they were; the first step's
clipped gradient (from AdamW's first moment) and each leaf's change over
the reference's steps are read as the program holds them.  The window
then steps until ``--seconds`` have passed, draining the device at each
scheduled resize.  After it, with the job's state freed, the reference
follows the same first steps in float32 and the gaps are judged.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from port_bench.harness import (Outcome, Run, ScheduleRMS, Window,
                                fingerprint, leaf_gap, load_module)


def _check_layout(params, abstract) -> None:
    from repro_torch import tree as T
    mine = {p: (tuple(t.shape), t.dtype) for p, t in T.flatten(params)}
    theirs = {p: (tuple(t.shape), t.dtype) for p, t in T.flatten(abstract)}
    if mine != theirs:
        raise RuntimeError(f"the reference's weights do not fit the "
                           f"program's layout: {sorted(set(mine) ^ set(theirs))}"
                           f" or shapes differ")


def arch_config(cfg: dict, m: dict):
    """The program's ``ArchConfig``: the sizes ``m`` that the reference
    reads from the configuration's source keys, and ``program``'s fields,
    which the source does not state."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(
        name=cfg["name"], num_layers=m["num_layers"], d_model=m["d_model"],
        num_heads=m["num_heads"], num_kv_heads=m["num_kv_heads"],
        head_dim=m["head_dim"], d_ff=m["d_ff"], vocab_size=m["vocab_size"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=m["rope_theta"], norm_eps=m["norm_eps"],
        **cfg["program"])


def gaps(got: dict, r: dict) -> dict:
    """The numbers compared, of ``got`` (the program's readings, or a
    control's) against the reference's ``r``: the largest relative gap
    of a step's loss; the worst leaf's gap of the first clipped
    gradient's norm and of the change's norm over the steps; and the
    first clipped gradient's relative difference at the sampled entries
    of every leaf, |g - g_ref| / |g_ref| (``grad_diff``: the norms'
    gaps do not part bf16 from an fp8 control, whose rounding is noise
    that a norm averages out).  Leaves whose reference gradient is under
    a thousandth of the median leaf's are left out."""
    med = statistics.median(r["grad_norms"].values())
    counted = [k for k, v in r["grad_norms"].items() if v >= 1e-3 * med]
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], r["losses"]))
    grad_gap, grad_leaf = leaf_gap(got["grad_norms"], r["grad_norms"],
                                   counted)
    change_gap, change_leaf = leaf_gap(got["change_norms"],
                                       r["change_norms"], counted)
    diff = sum(float(torch.sum((got["grad_sample"][k].double() -
                                r["grad_sample"][k].double()) ** 2))
               for k in counted)
    ref_sq = sum(float(torch.sum(r["grad_sample"][k].double() ** 2))
                 for k in counted)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "grad_diff": math.sqrt(diff / ref_sq),
            "change_gap": change_gap, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf,
            "left_out": sorted(set(r["grad_norms"]) - set(counted))}


def run(run: Run, breaks=None, reference=None) -> Outcome:
    """``breaks``: hooks that break the timed path, for the benchmark's
    fault tests and readings (``{"app": fn(app) -> app, "optimizer":
    fn(opt) -> opt}``); ``reference``: the reference's outputs for this
    seed, when a caller has them already (``extra["reference"]`` of an
    earlier run)."""
    import torch
    from repro_torch import dmr
    from repro_torch import tree as T
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.lm_app import lm_train_app
    from repro_torch.models.model import abstract_params
    from repro_torch.models.train import TrainState
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel.mesh import logical_workers

    cell, seed, dev = run.cell, run.seed, run.device
    cfg, tr = cell.config, cell.traffic
    ref = load_module(cfg["reference"])
    m, o = ref.sizes(cfg), cfg["optimizer"]
    B, S = tr["batch"], tr["seq_len"]
    n_ref = cfg["reference_steps"]
    arch = arch_config(cfg, m)
    opt = AdamW(learning_rate=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                weight_decay=o["weight_decay"], clip_norm=o["clip_norm"],
                moment_dtype=arch.opt_moment_dtype)
    if breaks and "optimizer" in breaks:
        opt = breaks["optimizer"](opt)
    prog = lm_train_app(arch, ShapeConfig(cell.traffic_name, "train", S, B),
                        opt, global_batch=B)

    def init(mesh):
        params = ref.nest(ref.make_params(m, seed, mesh.device))
        _check_layout(params, abstract_params(arch))
        zero = torch.zeros((), dtype=torch.int32, device=mesh.device)
        return TrainState(params=params, opt=opt.init(params),
                          step=zero.clone(),
                          rng=torch.tensor([0, (seed + 1) % 2 ** 32],
                                           dtype=torch.uint32,
                                           device=mesh.device),
                          data_cursor=zero.clone())

    app = dmr.App(init=init, shardings=prog.state_shardings,
                  step=prog.make_step, name=prog.name)
    if breaks and "app" in breaks:
        app = breaks["app"](app)
    params = dmr.set_parameters(*cfg["malleability"])
    rms = ScheduleRMS(tr)
    runner = dmr.MalleableRunner(
        app, params, rms, devices=logical_workers(params.max_procs, dev))
    batch_at = lambda i: ref.make_batch(m, B, S, seed, i)  # noqa: E731

    # -- set-up: the reference's steps and one of each resize ----------
    state = runner.init()
    losses, changed = [], 0
    grad_norms = grad_sample = change_norms = None
    for i in range(tr["setup_steps"]):
        if rms.scheduled(i):
            before = [fingerprint(t) for t in T.leaves(state)]
            state = dmr.reconfig(runner, state, i)
            after = [fingerprint(t) for t in T.leaves(state)]
            changed += sum(a != b for a, b in zip(before, after))
        else:
            state = dmr.reconfig(runner, state, i)
        state, met = runner.step(state, i, batch_at(i))
        losses.append(float(met["loss"]))
        if i == 0:
            grad_norms = {p: float(torch.linalg.vector_norm(
                t, dtype=torch.float64)) / (1 - o["b1"])
                for p, t in T.flatten(state.opt.mu)}
            idx = ref.sample_index(m, seed, dev)
            grad_sample = {p: (t.reshape(-1)[idx[p]] / (1 - o["b1"])).cpu()
                           for p, t in T.flatten(state.opt.mu)}
            del idx
        if i == n_ref - 1:
            p0 = ref.make_params(m, seed, dev)
            change_norms = {p: float(torch.linalg.vector_norm(
                t - p0[p], dtype=torch.float64))
                for p, t in T.flatten(state.params)}
            del p0

    # -- the window ------------------------------------------------------
    win = Window(run)
    win.start()
    i, steps, failed = tr["setup_steps"], 0, 0
    while True:
        batch = batch_at(i)
        resized = rms.scheduled(i)
        if resized:
            state = win.resize(lambda: dmr.reconfig(runner, state, i))
        else:
            with win.span("bench.reconfig"):
                state = dmr.reconfig(runner, state, i)
        with win.span("bench.step"):
            state, met = runner.step(state, i, batch)
        with win.span("bench.loss_read"):
            loss = float(met["loss"])
        if resized:
            win.resumed()
        failed += not math.isfinite(loss)
        steps += 1
        i += 1
        if win.elapsed() >= run.seconds:
            break
    win.close()

    # -- judge the first steps against the reference ---------------------
    del state, met, runner, app, prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    r = reference or ref.train_steps(
        m, o, seed, [batch_at(k) for k in range(n_ref)], dev, "fp32")
    t_ref = time.perf_counter() - t_ref
    g = gaps({"losses": losses[:n_ref], "grad_norms": grad_norms,
              "grad_sample": grad_sample, "change_norms": change_norms}, r)
    lim = cell.limits
    checks = [(k, g[k], lim[k])
              for k in ("loss_gap", "grad_gap", "grad_diff", "change_gap")]
    checks.append(("resize_changed_leaves", changed,
                   lim["resize_changed_leaves"]))
    tokens = steps * B * S
    return Outcome(
        e2e={"train_tokens_per_s": tokens / win.window_s,
             "peak_mem_gb": win.peak / 1e9, "setup_s": win.setup_s},
        checks=checks, attempted=steps, failed=failed, window=win,
        steps=steps,
        extra={"losses": losses, "ref_losses": r["losses"],
               "grad_leaf": g["grad_leaf"], "change_leaf": g["change_leaf"],
               "left_out": g["left_out"], "reference_s": t_ref,
               "leaf_grad_gaps": {k: abs(grad_norms[k] - v) / v for k, v
                                  in r["grad_norms"].items()},
               "reference": r})
