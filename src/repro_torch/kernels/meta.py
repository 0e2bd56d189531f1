"""The kernels' wrappers on meta tensors: output shapes only, and the work
each call stands for.

A step run on ``torch.device("meta")`` allocates nothing and computes
nothing; the dry run counts one that way (``launch/flopcount.py``).  Given
meta tensors, each wrapper checks its inputs as it does on a card, returns
empty meta tensors of its kernel's output shapes, dtypes and layouts, and
reports here the work that kernel would do for the call: floating-point
operations over the pairs it visits (K1's causal or windowed pairs, K3's
chunk products) and the bytes it must move (each input read once, each
output written once).  No arithmetic goes through this path, and nothing
is counted as a launch.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

_sinks: List[list] = []


@dataclasses.dataclass(frozen=True)
class KernelWork:
    kernel: str          # the wrapper's name, as ``ops.KERNELS`` keys it
    flops: float
    nbytes: float


@contextlib.contextmanager
def recording():
    """Collects the :class:`KernelWork` of every meta call made inside."""
    calls: List[KernelWork] = []
    _sinks.append(calls)
    try:
        yield calls
    finally:
        _sinks.remove(calls)


def record(kernel: str, flops: float, nbytes: float) -> None:
    for s in _sinks:
        s.append(KernelWork(kernel, float(flops), float(nbytes)))


def attention_pairs(sq: int, sk: int, causal: bool, window: int = 0,
                    kv_len: Optional[int] = None, q_offset: int = 0) -> int:
    """(query, key) pairs one head of K1 visits: every row over the first
    ``kv_len`` (else all ``sk``) keys, or, causal, the row at position
    ``p = q_offset + i`` over keys ``max(0, p - window + 1) .. p`` of
    those (top-left aligned when ``q_offset`` is 0)."""
    n = sk if kv_len is None else min(int(kv_len), sk)
    if not causal:
        return sq * n

    def row(p):                           # keys the row at position p sees
        return max(0, min(n, p + 1) - (max(0, p - window + 1) if window
                                       else 0))

    # row(p) is linear between the breakpoints: sum each piece as an
    # arithmetic series
    a, b = q_offset, q_offset + sq
    cuts = sorted({a, b} | {c for c in (n, window, n + window - 1)
                            if window or c == n} - {0})
    cuts = [c for c in [a] + cuts if a <= c <= b]
    total = 0
    for s0, s1 in zip(cuts, cuts[1:]):
        if s1 > s0:
            total += (row(s0) + row(s1 - 1)) * (s1 - s0) // 2
    return total


def attention_work(B, H, Hkv, sq, sk, D, itemsize, causal, window=0,
                   kv_len=None, with_lse=False, backward=False, q_offset=0):
    """(flops, bytes) of one K1 call: QK^T and PV (2 D each a pair) in the
    forward, the backward's five products (S again, dP, dV, dQ, dK);
    q, k, v (the keys it reads) and the output once, the fp32 lse beside
    them; the backward reads q, k, v, o, dO and the lse and writes dq, dk,
    dv.  ``q_offset``: a sequence shard's (``attention_pairs``)."""
    pairs = B * H * attention_pairs(sq, sk, causal, window, kv_len, q_offset)
    keys = sk if kv_len is None else min(int(kv_len), sk)
    q_bytes, kv_bytes = B * H * sq * D * itemsize, B * Hkv * keys * D * itemsize
    lse = 4 * B * H * sq
    if backward:
        return 10 * D * pairs, 4 * q_bytes + 4 * kv_bytes + lse
    return 4 * D * pairs, 2 * q_bytes + 2 * kv_bytes + (lse if with_lse
                                                         else 0)


def ssd_work(B, S, H, P, N, Q, itemsize, backward=False):
    """(flops, bytes) of one K3 call at chunk ``Q``: C B^T once per
    (batch, chunk) over its causal pairs, and per head the masked product
    with x, the inter-chunk term and the state update; xdt, B and C in
    their dtype and the fp32 a read, y written.  The backward: its five
    Q P N products and the pair products of dx, dB, dC and da; xdt, dy
    read and dx written, a read and da written, B and C read and dB and
    dC written."""
    nc, pb = S // Q, Q * (Q + 1) // 2
    if backward:
        return (2 * (B * H * nc * (5 * Q * P * N + pb * (2 * P + 2 * N))
                     + B * nc * pb * N),
                itemsize * 3 * B * S * H * P + 4 * 2 * B * S * H
                + itemsize * 4 * B * S * N)
    return (nc * B * Q * Q * N + nc * B * H * (Q * Q * P + 4 * Q * P * N),
            itemsize * 2 * B * S * H * P + 4 * B * S * H
            + itemsize * 2 * B * S * N)
