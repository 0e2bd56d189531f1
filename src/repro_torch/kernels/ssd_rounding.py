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

The backward's wgmma path (``csrc/ssd_scan_bwd.cu``) is modelled the same
way by :func:`model_grads`: the carried states (``states``) and the
decayed rows of their chunk sums (``rows``) split or rounded once, the
decayed, masked G of dx (``gl``) and the head sum M = sum_h D o L of dB
and dC (``m``) likewise; every other operand is an input.  ``python -m
repro_torch.kernels.ssd_rounding bwd`` prints, at mamba2-370m's training
shape (B=8, H=32, S=4096, P=64, N=128, Q=256), each output's worst
error over ``SSD_BWD_TOL`` of its largest entry for a set of choices
(~1-2 min); ``bwd H N [B]`` takes another head count, state size and
batch, e.g. ``bwd 80 64 2`` for zamba2-2.7b's scan (H=80, N=64) with
the batch cut to 2.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.kernels.ref import (ssd_chunked_backward_reference,
                                     ssd_chunked_reference)

SUB = 64                    # rows per sub-chunk, as the kernel


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _operand(t: torch.Tensor, split) -> torch.Tensor:
    """``t`` as the kernel feeds it to the tensor cores: split into hi + lo
    (True), rounded once (False) or, for the model's own yardstick, exact
    (None)."""
    if split is None:
        return t
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
           decay=0.02):
    """bf16 xdt, bm, cm and f32 a as ``chip_smoke.py`` draws them (inputs
    times 0.3; decay 0.02 keeps the state alive across sub-chunks;
    ``"model"`` draws a = dt * A as mamba2's random init does: dt =
    softplus of a normal of std 0.64, A in [-16, -1], so that in-chunk
    cumsums reach ~-3e3)."""
    rng = np.random.default_rng(seed)

    def scaled(shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(
            np.float32)).to(torch.bfloat16)
    if decay == "model":
        dt = np.log1p(np.exp(0.64 * rng.standard_normal((B, S, H))))
        a = -dt * rng.uniform(1.0, 16.0, H)
    else:
        a = -np.abs(rng.standard_normal((B, S, H))) * decay
    return (scaled((B, S, H, P)), torch.from_numpy(a.astype(np.float32)),
            scaled((B, S, N)), scaled((B, S, N)))


def worst_ratio(y, ref, tol: float) -> float:
    """The largest error in units of the tolerance ``tol + tol |ref|``."""
    err = (y.float() - ref.float()).abs()
    return (err / (tol + tol * ref.float().abs())).max().item()


def model_grads(xdt, a, bm, cm, dy, chunk: int, *, states=True, rows=True,
                gl=False, m=True):
    """(dx, da, dB, dC) of the backward's wgmma path for bf16 inputs, in
    float64 with its roundings; each keyword names an operand that is not
    an input: split into bf16 hi + lo (True), rounded once (False) or exact
    (None).  ``states``: the chunk-start states S_in and the chunk-end
    state gradients dS_out, carried in fp32 and fed split to every product
    they enter; ``rows``: x o exp(l[63] - l) and dy o exp(l) of the state
    sums, over 64-row sub-chunks with local cumsums l as the states kernel
    walks them; ``gl``: (G o L)^T of dx; ``m``: M = sum_h D o L, summed
    over the heads in fp32 before its products with B and C.  W = G o L o
    D and its row and column sums stay fp32 (float64 here); dx, dB and dC
    are rounded to bf16 once, da is float32.  Shapes as ``ssd_scan_bwd``;
    ``chunk`` a multiple of 64."""
    B, S, H, P = xdt.shape
    N = bm.shape[-1]
    Q, nc = chunk, S // chunk
    x, g, a = xdt.double(), dy.double(), a.double()
    b_, c_ = bm.double(), cm.double()
    # the states kernel: 64-row sub-chunks, forward for S_in, backward for
    # dS_out, each stored (split or rounded) at its chunk's edge
    s_in, ds_out = [None] * nc, [None] * nc
    st = torch.zeros((B, H, P, N), dtype=torch.float64)
    for s0 in range(0, S, SUB):
        if s0 % Q == 0:
            s_in[s0 // Q] = _operand(st, states)
        lc = torch.cumsum(a[:, s0:s0 + SUB], dim=1)            # (B, 64, H)
        dec = torch.exp(lc[:, -1:] - lc)
        st = st * torch.exp(lc[:, -1])[..., None, None] + torch.einsum(
            "bshp,bsn->bhpn", _operand(x[:, s0:s0 + SUB] * dec[..., None],
                                       rows), b_[:, s0:s0 + SUB])
    st = torch.zeros_like(st)
    for s0 in reversed(range(0, S, SUB)):
        if (s0 + SUB) % Q == 0:
            ds_out[s0 // Q] = _operand(st, states)
        lc = torch.cumsum(a[:, s0:s0 + SUB], dim=1)
        st = st * torch.exp(lc[:, -1])[..., None, None] + torch.einsum(
            "bqhp,bqn->bhpn", _operand(g[:, s0:s0 + SUB] *
                                       torch.exp(lc)[..., None], rows),
            c_[:, s0:s0 + SUB])
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()[None, :, :, None]
    dx, da, db, dc = [], [], [], []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xc, gc, bc, cc = x[:, sl], g[:, sl], b_[:, sl], c_[:, sl]
        cum = torch.cumsum(a[:, sl], dim=1)                     # (B, Q, H)
        tot = cum[:, -1]
        dec, ecum = torch.exp(tot[:, None] - cum), torch.exp(cum)
        L = torch.exp((cum[:, :, None] - cum[:, None]).masked_fill(
            ~causal, float("-inf")))                            # q, s
        GL = torch.einsum("bqn,bsn->bqs", cc, bc)[..., None] * L
        D = torch.einsum("bqhp,bshp->bqsh", gc, xc)
        W = GL * D
        M = _operand((D * L).sum(-1), m)                        # (B, Q, Q)
        si, so = s_in[c], ds_out[c]
        dsb = torch.einsum("bhpn,bsn->bshp", so, bc)           # dS_out B_s
        dx.append(torch.einsum("bqsh,bqhp->bshp", _operand(GL, gl), gc) +
                  dec[..., None] * dsb)
        db.append(torch.einsum("bqs,bqn->bsn", M, cc) + torch.einsum(
            "bsh,bshn->bsn", dec, torch.einsum("bshp,bhpn->bshn", xc, so)))
        tmp = torch.einsum("bqhp,bhpn->bqhn", gc, si)          # dy_q S_in
        dc.append(torch.einsum("bqs,bsn->bqn", M, bc) +
                  torch.einsum("bqh,bqhn->bqn", ecum, tmp))
        V = dec * (xc * dsb).sum(-1)                            # (B, Q, H)
        dcum = W.sum(2) - W.sum(1) + ecum * torch.einsum(
            "bqhn,bqn->bqh", tmp, cc) - V
        dcum[:, -1] += V.sum(1) + torch.exp(tot) * (so * si).sum((-2, -1))
        da.append(dcum.flip(1).cumsum(1).flip(1))
    cat = lambda ts, dt: torch.cat(ts, dim=1).to(dt)
    return (cat(dx, torch.bfloat16), cat(da, torch.float32),
            cat(db, torch.bfloat16), cat(dc, torch.bfloat16))


def grad_inputs(seed: int, B: int, H: int, S: int, P: int, N: int,
                decay="model"):
    """:func:`inputs` and a bf16 cotangent dy of unit scale, as
    ``chip_smoke.py``'s backward cases draw them; by default at mamba2's
    decays."""
    dy = np.random.default_rng(seed + 1).standard_normal((B, S, H, P))
    return (*inputs(seed, B, H, S, P, N, decay),
            torch.from_numpy(dy.astype(np.float32)).to(torch.bfloat16))


#: K3's backward against its plain version, per output: bf16 dx, dB, dC
#: within 1e-2 of their largest entry, fp32 da within 1e-4 (chip_smoke.py's
#: SSD_BWD_TOL)
BWD_TOL = (1e-2, 1e-4, 1e-2, 1e-2)


def bwd_ratios(got, ref) -> list:
    """Each output's largest error over its tolerance times its largest
    entry (``BWD_TOL``; above 1: it misses), in the order dx, da, dB, dC."""
    return [((g.double() - r.double()).abs().max() /
             (tol * r.double().abs().max())).item()
            for g, r, tol in zip(got, ref, BWD_TOL)]


#: (label, keywords of model_grads) of the backward's table
BWD_CHOICES = [
    ("exact operands", dict(states=None, rows=None, gl=None, m=None)),
    ("chosen: states, rows, M split; G o L once",
     dict(states=True, rows=True, gl=False, m=True)),
    ("G o L and M once", dict(states=True, rows=True, gl=False, m=False)),
    ("every operand split", dict(states=True, rows=True, gl=True, m=True)),
    ("decayed rows once", dict(states=True, rows=False, gl=False, m=True)),
    ("states once", dict(states=False, rows=True, gl=False, m=True)),
]


def main_bwd(B: int = 8, H: int = 32, S: int = 4096, P: int = 64,
             N: int = 128, Q: int = 256) -> None:
    args = grad_inputs(0, B, H, S, P, N)
    ref = ssd_chunked_backward_reference(*args, Q)
    print(f"B={B} H={H} S={S} P={P} N={N} Q={Q}, bf16, mamba2's decays: "
          "worst |d - ref| / (tol max |ref|), tol 1e-2 (1e-4 for da)")
    for label, kw in BWD_CHOICES:
        r = bwd_ratios(model_grads(*args, Q, **kw), ref)
        print(f"{label:42} dx {r[0]:.3f}  da {r[1]:.3f}  dB {r[2]:.3f}  "
              f"dC {r[3]:.3f}")


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
    import sys
    if sys.argv[1:2] == ["bwd"]:
        main_bwd(**dict(zip(("H", "N", "B"), map(int, sys.argv[2:5]))))
    else:
        main()
