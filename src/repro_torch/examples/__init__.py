"""The paper's §4.3 malleable applications on the port (ports of the JAX
package's ``examples/``): each is three plain functions bound to a
``dmr.App`` and one ``main()`` loop with a ``dmr.reconfig`` call at the
top of every iteration.

* :mod:`~repro_torch.examples.quickstart` — LM training (Listing 2),
  ``granite-3-2b-smoke``, 4 -> 8 -> 2 workers;
* :mod:`~repro_torch.examples.cg_solver` — Conjugate Gradient, A split
  by rows, 4 -> 8 -> 2; at any problem size (``--n``);
* :mod:`~repro_torch.examples.jacobi` — Jacobi, 4 -> 8 -> 2;
* :mod:`~repro_torch.examples.nbody` — N-body, the "MPI_PARTICLE" state,
  4 -> 8 -> 1;
* :mod:`~repro_torch.examples.aligner_pipeline` — the irregular
  producer/consumer aligner, its reference table re-replicated on every
  resize, 6 -> 8 -> 3.

``python -m repro_torch.examples.<app> [--device cpu]`` runs one: on the
card unless a device is named, never falling back to the CPU.  Each
``main(device=None)`` prints the reference's lines, raises when the
reference's check fails, and returns ``(runner, state, out)``: the
runner (its ``events``), the final state and what the loop printed
(``out["lines"]`` and the values behind them).
"""
import argparse
import contextlib
from typing import Callable, List, Optional

import torch


class Log:
    """What an example's loop prints, kept for its caller."""

    def __init__(self):
        self.lines: List[str] = []

    def __call__(self, line: str) -> None:
        print(line, flush=True)
        self.lines.append(line)


def check(ok: bool, what: str) -> None:
    """An example's own check: raises (also under ``python -O``, and on a
    NaN, which compares false) when it fails."""
    if not ok:
        raise AssertionError(what)


@contextlib.contextmanager
def full_fp32():
    """fp32 matrix products without TF32 (as the reference computes them),
    restoring the caller's setting.  CG and Jacobi state their precision
    once, on their ``main()`` (``@full_fp32()``): the flag is process-wide,
    so a run assumes that no other thread runs CUDA matrix products
    meanwhile, and a caller that drives an example's ``app`` itself
    chooses its own precision."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def cli(main: Callable, argv: Optional[List[str]] = None, **extra) -> None:
    """``python -m repro_torch.examples.<app> [--device DEV]``; ``extra``
    adds integer options (``n=512`` adds ``--n``)."""
    parser = argparse.ArgumentParser(description=main.__module__)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; cpu runs on "
                             "the CPU)")
    for name, default in extra.items():
        parser.add_argument(f"--{name}", type=int, default=default)
    args = parser.parse_args(argv)
    main(**vars(args))
