"""Where K1's backward rounds on its tensor-core path, modelled on the CPU.

The wgmma path of ``csrc/flash_attention_bwd.cu`` takes bf16 q, k, v, o
and dO, forms S = Q K^T and dP = dO V^T in fp32 accumulators, recomputes
P = exp(S D^-0.5 - lse) and dS = P o (dP - delta) in fp32, and rounds P
and dS once to bf16 to enter the three gradient products, whose sums stay
fp32 in tile order: dV and dK over the (query head, query tile) items of
a key tile, dQ over the key tiles of a query tile; each output is rounded
once to bf16.  :func:`model_grads` repeats that arithmetic, so the error
the roundings add can be held against ``BWD_TOL["bfloat16"]`` (2e-2)
before any card is involved::

    python -m repro_torch.kernels.bwd_rounding      # from src/, on a CPU

prints the largest ``|g - ref| / (tol + tol |ref|)`` of dq, dk and dv at
one KV head of the training shape (G = 4, S = 4096, D = 64, causal), with
dS rounded once and split hi + lo; ``ref`` is
``attention_backward_reference`` (above 1: the choice misses the
tolerance).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ref import (attention_backward_reference,
                                     attention_lse_reference,
                                     attention_reference, _attention_mask)

TILE = 64                   # query rows / keys per tile, as the kernel


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _operand(t: torch.Tensor, split: bool) -> torch.Tensor:
    """``t`` as the kernel feeds it to the tensor cores."""
    hi = _bf16(t)
    return hi + _bf16(t - hi) if split else hi


def model_grads(q, k, v, o, do, lse, *, causal: bool = True,
                window: int = 0, split_ds: bool = False):
    """(dq, dk, dv) of the wgmma path for bf16 inputs, one batch row and KV
    head at a time (the plain version's memory at S = 4096 is one head's
    (S, S) fp32 scores); shapes and result as
    ``attention_backward_reference``."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    mask = _attention_mask(Sq, Sk, causal=causal, window=window, kv_len=None,
                           device=q.device)
    dq = torch.empty(B, H, Sq, D)
    dk = torch.empty(B, Hkv, Sk, D)
    dv = torch.empty(B, Hkv, Sk, D)
    for b in range(B):
        for kh in range(Hkv):
            kk, vv = k[b, kh].float(), v[b, kh].float()
            acc_k, acc_v = torch.zeros(Sk, D), torch.zeros(Sk, D)
            for g in range(G):
                h = kh * G + g
                qq, dd = q[b, h].float(), do[b, h].float()
                delta = (dd * o[b, h].float()).sum(-1)
                s = (qq @ kk.T) * scale
                p = torch.where(mask, torch.exp(s - lse[b, h, :, None]), 0.)
                ds = p * (dd @ vv.T - delta[:, None])
                p16, ds16 = _bf16(p), _operand(ds, split_ds)
                # (b): items (head g, query tile) in order, fp32 sums
                for i0 in range(0, Sq, TILE):
                    r = slice(i0, i0 + TILE)
                    acc_v += p16[r].T @ dd[r]
                    acc_k += ds16[r].T @ qq[r]
                # (c): key tiles in order
                acc_q = torch.zeros(Sq, D)
                for j0 in range(0, Sk, TILE):
                    c = slice(j0, j0 + TILE)
                    acc_q += ds16[:, c] @ kk[c]
                dq[b, h] = acc_q * scale
            dk[b, kh], dv[b, kh] = acc_k * scale, acc_v
    return (dq.to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16))


def reference_grads(q, k, v, o, do, lse, *, causal: bool = True,
                    window: int = 0):
    """``attention_backward_reference`` on the same values, one batch row
    and query head at a time (dk, dv summed over the G heads in fp32),
    rounded to bf16 as the plain version rounds them."""
    B, H, Sq, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    dq, dk, dv = (torch.zeros(t.shape) for t in (q, k, v))
    for b in range(B):
        for h in range(H):
            one = lambda t: t[b:b + 1, h:h + 1].float()
            kv = lambda t: t[b:b + 1, h // G:h // G + 1].float()
            gq, gk, gv = attention_backward_reference(
                one(q), kv(k), kv(v), one(o), one(do), lse[b:b + 1, h:h + 1],
                causal=causal, window=window)
            dq[b, h] = gq[0, 0]
            dk[b, h // G] += gk[0, 0]
            dv[b, h // G] += gv[0, 0]
    return (dq.to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16))


def inputs(seed: int, B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int,
           *, causal: bool = True, window: int = 0):
    """bf16 q, k, v, dO from a seed, and the forward's o (bf16) and lse
    (fp32) from their plain versions, one query head at a time."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)
    q, k, v = draw((B, H, Sq, D)), draw((B, Hkv, Sk, D)), draw((B, Hkv, Sk, D))
    do = draw((B, H, Sq, D))
    G = H // Hkv
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq)
    for h in range(H):
        qh = q[:, h:h + 1]
        kh, vh = k[:, h // G:h // G + 1], v[:, h // G:h // G + 1]
        o[:, h:h + 1] = attention_reference(qh, kh, vh, causal=causal,
                                            window=window)
        lse[:, h:h + 1] = attention_lse_reference(qh, kh, causal=causal,
                                                  window=window)
    return q, k, v, o, do, lse


def worst_ratio(got, ref, tol: float) -> float:
    """The largest error in units of the tolerance ``tol + tol |ref|``."""
    err = (got.float() - ref.float()).abs()
    return (err / (tol + tol * ref.float().abs())).max().item()


def main(H: int = 4, S: int = 4096, D: int = 64, tol: float = 2e-2) -> None:
    args = inputs(0, 1, H, 1, S, S, D)
    ref = reference_grads(*args)
    print(f"B=1 H={H} Hkv=1 S={S} D={D} causal, tol {tol}: worst "
          "|g - ref| / (tol + tol |ref|) of dq, dk, dv")
    for split in (False, True):
        got = model_grads(*args, split_ds=split)
        print(f"dS {'split hi + lo' if split else 'rounded once':15} " +
              " ".join(f"{worst_ratio(a, b, tol):.3f}"
                       for a, b in zip(got, ref)))


if __name__ == "__main__":
    main()
