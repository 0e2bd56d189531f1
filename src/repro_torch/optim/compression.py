"""Int8 gradient compression with error feedback (port of
``repro/optim/compression.py``).

Before a reduction over a slow mesh axis (the reference's ``pod`` axis,
which crosses the data-centre network), gradients are quantized to int8
with one fp32 scale per tensor and dequantized after it, a quarter of the
bytes; error feedback carries each quantization residual into the next
round.  :func:`compressed_psum_tree` runs inside a ``shard_map`` body
(``parallel/spmd.py``): its gradients are per-worker lists.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tree as T
from repro_torch.parallel import spmd


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (int8 values, fp32 scale): round-half-even of x / scale,
    clipped to [-127, 127], with scale = max(|x|) / 127 (at least 1e-12)."""
    x = x.float()
    scale = torch.clamp(x.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum_tree(grads, axis_name, error=None):
    """psum a gradient tree over ``axis_name`` in int8 with error feedback,
    inside a ``shard_map`` body: ``grads`` (and ``error``, fp32, or None
    for zeros) is a tree whose leaves are per-worker lists.  Returns
    (reduced grads, new error), trees of the same form: the int8 values
    summed in int32, the scales averaged, the sum divided by the group's
    size (the reference's arithmetic, in its order)."""
    leaves = T.leaves(grads)
    errs_in = T.leaves(error) if error is not None else \
        [spmd.each(lambda g: torch.zeros_like(g, dtype=torch.float32), l)
         for l in leaves]
    n = spmd.axis_size(axis_name)
    outs, errs = [], []
    for g, e in zip(leaves, errs_in):
        corrected = spmd.each(lambda g_, e_: g_.float() + e_, g, e)
        q, scale = spmd.each(compress_int8, corrected)
        errs.append(spmd.each(lambda c, q_, s: c - decompress_int8(q_, s),
                              corrected, q, scale))
        summed = spmd.psum(spmd.each(lambda q_: q_.to(torch.int32), q),
                           axis_name)
        sscale = spmd.each(lambda s: s / n, spmd.psum(scale, axis_name))
        outs.append(spmd.each(lambda s, sc, g_: (s.float() * sc / n).to(
            g_.dtype), summed, sscale, g))
    return T.unflatten(grads, outs), T.unflatten(grads, errs)
