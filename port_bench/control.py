"""Readings that set a cell's limits: the program's, the control's and,
for a training cell, each planted fault's, on several seeds at the
cell's own size.  The benchmark's own runs never run this.

    python port_bench/control.py --workload <cell> --seeds 11,12,...,22 \\
        [--control-seeds 11,12,13] [--faults half_batch,answer_altered] \\
        [--no-control]

Prints one JSON line a reading: the program's on every seed, the
faults' and the control's on the ``--control-seeds`` (all by default;
``--no-control`` leaves the control out).  The control is the reference put in
the program's place in the nearest precision below the configuration's:
for bf16 training the reference with fp8 matrix products, for fp32 CG
the reference's iteration in TF32.
"""
import argparse
import json
import sys
import time

from run import ROOT  # sets the caches and sys.path as a run does


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from port_bench import harness
    cell = harness.resolve(harness.load_json(ROOT / "BENCHMARK.json"),
                           args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = [int(s) for s in args.control_seeds.split(",") if s] or seeds
    for line in readings(cell, seeds, [f for f in args.faults.split(",")
                                       if f], torch.device("cuda", 0),
                         control_seeds=ctl, control=not args.no_control):
        print(json.dumps(line), flush=True)
    return 0


def readings(cell, seeds, faults, device, control_seeds=None,
             control=True, solves=16):
    """Yield ``{"seed", "what", <number>: value, ...}`` for each seed:
    the program's numbers ("program"), each fault's, the control's.
    ``solves``: how many of the job's right-hand sides the CG control
    solves, each in the program's iterations a solve."""
    import torch
    from port_bench import harness
    from port_bench.faults import FAULTS
    kind = cell.config["driver"]
    driver = harness.load_module(f"drivers/{kind}.py")
    ref = harness.load_module(cell.config["reference"])

    def one(seed, breaks=None, reference=None):
        run = harness.Run(cell=cell, device=device, seconds=0.0, seed=seed,
                          trace=False, t0=time.perf_counter())
        t = time.perf_counter()
        out = driver.run(run, breaks=breaks, reference=reference) \
            if kind == "lm_train" else driver.run(run, breaks=breaks)
        return out, time.perf_counter() - t

    for seed in seeds:
        out, sec = one(seed)
        yield {"seed": seed, "what": "program", "seconds": sec,
               **{n: v for n, v, _ in out.checks},
               **{k: v for k, v in out.extra.items()
                  if k not in ("reference", "losses", "ref_losses")}}
        if control_seeds is not None and seed not in control_seeds:
            continue
        for f in faults:
            fout, sec = one(seed, FAULTS[kind][f],
                            out.extra.get("reference"))
            yield {"seed": seed, "what": f"fault:{f}", "seconds": sec,
                   **{n: v for n, v, _ in fout.checks}}
        if not control:
            continue
        t = time.perf_counter()
        if kind == "lm_train":
            r = out.extra["reference"]
            m, tr = ref.sizes(cell.config), cell.traffic
            batches = [ref.make_batch(m, tr["batch"], tr["seq_len"], seed, k)
                       for k in range(cell.config["reference_steps"])]
            ctrl = ref.train_steps(m, cell.config["optimizer"], seed,
                                   batches, device, "fp8")
            g = driver.gaps(ctrl, r)
            yield {"seed": seed, "what": "control:fp8",
                   "seconds": time.perf_counter() - t,
                   **{k: g[k] for k in ("loss_gap", "grad_gap", "grad_diff",
                                        "change_gap", "grad_leaf",
                                        "change_leaf")},
                   "leaf_grad_gaps": _leaf_gaps(ctrl, r, "grad_norms")}
        else:
            n, every = cell.config["n"], cell.traffic["read_every"]
            a = ref.make_matrix(n, seed, device)
            bs = torch.stack([ref.rhs(n, seed, k, device)
                              for k in range(solves)], 1)
            x_star = ref.solve(a, bs)
            err = max(ref.rel_err(ref.cg(a, bs[:, k].contiguous(), every,
                                         "tf32"), x_star[:, k])
                      for k in range(solves))
            yield {"seed": seed, "what": "control:tf32",
                   "seconds": time.perf_counter() - t, "solves": solves,
                   "iters_a_solve": every, "x_err": err}
            del a, bs, x_star


def _leaf_gaps(got, r, key):
    return {k: abs(got[key][k] - r[key][k]) / r[key][k] for k in r[key]}


if __name__ == "__main__":
    sys.exit(main())
