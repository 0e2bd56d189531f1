"""Where K3's tensor-core path rounds, modelled on the CPU.

The wgmma path of ``csrc/ssd_scan.cu`` computes in fp32 accumulators from
bf16 operands.  C, B and x are bf16 inputs and exact operands; three
operands are not inputs and must be rounded to bf16 to enter a product:
the decayed, masked G (``p``), the carried fp32 state (``state``) and
``x o decay`` of the state update (``update``).  Each can go in as one
bf16 value or split, ``hi + lo``, as two (~16 bits).  :func:`model_y`
repeats the kernel's algorithm -- 64-row sub-chunks, local cumsums, the
state carried from sub-chunk to sub-chunk -- in float64 with exactly
those roundings, so the error each choice adds to y can be held against
``SSD_CHUNKED_TOL`` before any card is involved::

    python -m repro_torch.kernels.ssd_rounding      # from src/, on a CPU

prints the largest ``|y - ref| / (tol + tol |ref|)`` for each choice at
the mamba2 path's shape (B cut to 2), ``ref`` being
``ssd_chunked_reference`` (above 1: the choice misses the tolerance).
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.kernels.ref import ssd_chunked_reference

SUB = 64                    # rows per sub-chunk, as the kernel


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _operand(t: torch.Tensor, split: bool) -> torch.Tensor:
    """``t`` as the kernel feeds it to the tensor cores."""
    hi = _bf16(t)
    return hi + _bf16(t - hi) if split else hi


def model_y(xdt, a, bm, cm, *, p: bool, state: bool, update: bool):
    """y of the wgmma path for bf16 inputs, with the named operands split
    (True) or rounded once (False); accumulations in float64, y rounded to
    bf16 at the end.  Shapes as ``ssd_scan``; S a multiple of 64."""
    B, S, H, P = xdt.shape
    x, a = xdt.double(), a.double()
    b_, c_ = bm.double(), cm.double()
    st = torch.zeros((B, H, P, b_.shape[-1]), dtype=torch.float64)
    mask = torch.ones((SUB, SUB), dtype=torch.bool).tril()[None, :, :, None]
    ys = []
    for s0 in range(0, S, SUB):
        xs, bs, cs = x[:, s0:s0 + SUB], b_[:, s0:s0 + SUB], c_[:, s0:s0 + SUB]
        lc = torch.cumsum(a[:, s0:s0 + SUB], dim=1)            # (B, 64, H)
        g = torch.einsum("bqn,bsn->bqs", cs, bs)
        ex = torch.exp((lc[:, :, None] - lc[:, None]).masked_fill(
            ~mask, float("-inf")))
        y = torch.einsum("bqsh,bshp->bqhp", _operand(g[..., None] * ex, p),
                         xs)
        y = y + torch.einsum("bqn,bhpn->bqhp", cs, _operand(st, state)) * \
            torch.exp(lc)[..., None]
        dec = torch.exp(lc[:, -1:] - lc)                       # (B, 64, H)
        st = st * torch.exp(lc[:, -1])[..., None, None] + torch.einsum(
            "bshp,bsn->bhpn", _operand(xs * dec[..., None], update), bs)
        ys.append(y)
    return torch.cat(ys, dim=1).to(torch.bfloat16)


def inputs(seed: int, B: int, H: int, S: int, P: int, N: int,
           decay: float = 0.02):
    """bf16 xdt, bm, cm and f32 a as ``chip_smoke.py`` draws them (inputs
    times 0.3; decay 0.02 keeps the state alive across sub-chunks)."""
    rng = np.random.default_rng(seed)

    def scaled(shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(
            np.float32)).to(torch.bfloat16)
    a = -np.abs(rng.standard_normal((B, S, H))) * decay
    return (scaled((B, S, H, P)), torch.from_numpy(a.astype(np.float32)),
            scaled((B, S, N)), scaled((B, S, N)))


def worst_ratio(y, ref, tol: float) -> float:
    """The largest error in units of the tolerance ``tol + tol |ref|``."""
    err = (y.float() - ref.float()).abs()
    return (err / (tol + tol * ref.float().abs())).max().item()


def main(B: int = 2, H: int = 32, S: int = 1024, P: int = 64, N: int = 128,
         Q: int = 256, tol: float = 1e-2) -> None:
    args = inputs(0, B, H, S, P, N)
    ref = ssd_chunked_reference(*args, Q)
    print(f"B={B} H={H} S={S} P={P} N={N} Q={Q}, tol {tol}: worst "
          "|y - ref| / (tol + tol |ref|)")
    for p, state, update in itertools.product((False, True), repeat=3):
        r = worst_ratio(model_y(*args, p=p, state=state, update=update),
                        ref, tol)
        print(f"split p={p!s:5} state={state!s:5} update={update!s:5} "
              f"{r:.3f}")


if __name__ == "__main__":
    main()
