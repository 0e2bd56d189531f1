"""Cells of ``BENCHMARK.json`` cut to a size that the CPU runs in a
second, for the benchmark's tests: the same drivers, references and
traffic schedules at tiny widths (granite's smoke widths in fp32, CG at
n = 512), with the limits of the tiny sizes.  The program takes its
plain CPU path (no CUDA kernel runs here)."""
from __future__ import annotations

import time

from port_bench import harness

#: granite's source keys at the smoke widths
TINY_HF = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, intermediate_size=128, vocab_size=250)
#: the reference's sizes at those keys
TINY_LM = harness.load_module("refs/dense_lm.py").sizes(
    dict(harness.load_json(harness.BENCH_DIR / "configs" /
                           "granite-3-2b.json"), **TINY_HF))
#: fp32 program against the fp32 reference: rounding of the sums' order
TINY_LM_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "grad_diff": 1e-4,
                  "change_gap": 1e-4, "resize_changed_leaves": 0}
TINY_CG_N = 512
TINY_CG_LIMITS = {"x_err": 1e-5, "a_changed_entries": 0,
                  "resize_changed_leaves": 0}


def tiny_cell(workload: str) -> harness.Cell:
    cell = harness.resolve(harness.load_json(harness.ROOT /
                                             "BENCHMARK.json"), workload)
    cfg = dict(cell.config)
    if cfg["driver"] == "lm_train":
        cfg.update(TINY_HF)
        cfg["program"] = dict(cfg["program"], dtype="float32", remat=False)
        cell.traffic = dict(cell.traffic, batch=4, seq_len=64)
        cell.limits = dict(TINY_LM_LIMITS)
    else:
        cfg["n"] = TINY_CG_N
        cell.limits = dict(TINY_CG_LIMITS)
    cell.config = cfg
    return cell


def cpu_run(cell: harness.Cell, seed: int, seconds: float = 0.2,
            trace: bool = False, breaks=None) -> harness.Outcome:
    import torch
    run = harness.Run(cell=cell, device=torch.device("cpu"),
                      seconds=seconds, seed=seed, trace=trace,
                      t0=time.perf_counter())
    driver = harness.load_module(f"drivers/{cell.config['driver']}.py")
    return driver.run(run, breaks=breaks)
