"""Run one cell of the port's benchmark once, on the card.

    python port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints one JSON line last on stdout (see
``port_bench/README.md``) and the numbers compared with their limits as
the last lines of stderr.  Exits non-zero, printing no result, when no
CUDA card is present, when the cell asks for more cards than there are,
and when the process holds ``jax``, ``jaxlib``, ``flax``, ``repro``,
``benchmarks`` or ``chip_smoke`` once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"
# every cache of the program and of its libraries inside the checkout, at
# fixed paths: only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(BUILD / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench import harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.resolve(bench, args.workload)

    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), {have} present", file=sys.stderr)
        return 2
    run = harness.Run(cell=cell, device=torch.device("cuda", 0),
                      seconds=args.seconds, seed=args.seed,
                      trace=bool(args.trace), t0=T0)
    driver = harness.load_module(f"drivers/{cell.config['driver']}.py")
    return harness.finish(run, driver.run(run))


if __name__ == "__main__":
    sys.exit(main())
