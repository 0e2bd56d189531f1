"""Data redistribution helpers (port of ``repro/core/redistribute.py``).

* ``TransferStats`` — what a resize moved.
* Default (1-D uniform block) redistribution — paper Listing 3/4.
* Block-cyclic redistribution — paper Table 1.  ``blockcyclic_split`` /
  ``blockcyclic_merge`` are the plain per-rank semantics;
  ``blockcyclic_redistribute`` composes merge and split into ONE host-
  computed block index vector and runs one repack over the concatenated
  parts — the block-cyclic kernel on a card, its plain version on the CPU.

Every helper takes numpy arrays or torch tensors and returns the same kind.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch


@dataclass
class TransferStats:
    bytes_moved: int
    seconds: float
    n_leaves: int


def _cat(parts: Sequence):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(list(parts))
    return np.concatenate(list(parts))


def _split(data, n: int) -> List:
    """``n`` equal contiguous row chunks (views)."""
    if data.shape[0] % n:
        raise ValueError(f"cannot split {data.shape[0]} rows into {n} "
                         "equal parts")
    m = data.shape[0] // n
    return [data[i * m:(i + 1) * m] for i in range(n)]


# ----------------------------------------------------------------------
# Default (1-D uniform block) redistribution — paper Listing 3/4
# ----------------------------------------------------------------------

def send_expand_default(data, factor: int) -> List:
    """Parent side of an expansion by an integer factor: split this rank's
    block into ``factor`` contiguous chunks (one per child peer)."""
    return _split(data, factor)


def recv_expand_default(chunks: List):
    """Child side of an expansion: exactly one chunk arrives."""
    if len(chunks) != 1:
        raise ValueError(f"expected one chunk, got {len(chunks)}")
    return chunks[0]


def send_shrink_default(data) -> List:
    """Parent side of a shrink: the whole local block goes to one survivor."""
    return [data]


def recv_shrink_default(chunks: List):
    """Survivor side of a shrink by factor f: concatenate f parent blocks."""
    return _cat(chunks)


def default_redistribution(parts: List, new_nprocs: int) -> List:
    """End-to-end 1-D uniform redistribution old->new worker counts.

    Matches DMR_Send/Recv_*_default semantics for multiple/divisor resizes;
    arbitrary counts fall back to an even re-split of the concatenation.
    """
    old = len(parts)
    if new_nprocs == old:
        return list(parts)
    if new_nprocs % old == 0:
        f = new_nprocs // old
        out: List = []
        for p in parts:
            out.extend(send_expand_default(p, f))
        return out
    if old % new_nprocs == 0:
        f = old // new_nprocs
        return [recv_shrink_default(parts[i * f:(i + 1) * f])
                for i in range(new_nprocs)]
    return _split(_cat(parts), new_nprocs)


# ----------------------------------------------------------------------
# Block-cyclic redistribution — paper Table 1 (second group)
# ----------------------------------------------------------------------

def blockcyclic_owner(nblocks: int, nprocs: int) -> np.ndarray:
    """Owner rank of each block under a block-cyclic layout."""
    return np.arange(nblocks) % nprocs


def _blocks(data, block: int):
    n = data.shape[0]
    if n % block:
        raise ValueError(f"{n} rows are not a multiple of block {block}")
    return data.reshape(n // block, block, *data.shape[1:])


def blockcyclic_split(data, nprocs: int, block: int) -> List:
    """Global 1-D array -> per-rank local arrays (block-cyclic layout)."""
    blocks = _blocks(data, block)
    owners = blockcyclic_owner(blocks.shape[0], nprocs)
    take = [np.flatnonzero(owners == r) for r in range(nprocs)]
    if isinstance(data, torch.Tensor):
        take = [torch.from_numpy(t).to(data.device) for t in take]
    return [blocks[t].reshape(-1, *data.shape[1:]) for t in take]


def blockcyclic_merge(parts: List, block: int):
    """Inverse of blockcyclic_split."""
    nprocs = len(parts)
    per = [_blocks(p, block) for p in parts]
    nblocks = sum(p.shape[0] for p in per)
    order = [per[b % nprocs][b // nprocs] for b in range(nblocks)]
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(order).reshape(-1, *parts[0].shape[1:])
    return np.stack(order).reshape(-1, *parts[0].shape[1:])


def blockcyclic_index(counts: Sequence[int], new_nprocs: int) -> List[np.ndarray]:
    """Merge-then-split as one gather: for parts holding ``counts[r]`` blocks
    each (block-cyclic over ``len(counts)`` ranks), the indices — into the
    concatenation of the parts — of each new rank's blocks, in order."""
    old = len(counts)
    offset = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    g = np.arange(int(sum(counts)), dtype=np.int64)      # global block ids
    src = offset[g % old] + g // old                     # where each one is
    return [src[r::new_nprocs] for r in range(new_nprocs)]


def blockcyclic_redistribute(parts: List, new_nprocs: int,
                             block: int) -> List:
    """Block-cyclic layout on ``len(parts)`` ranks -> same layout on
    ``new_nprocs`` ranks (DMR_Send/Recv_*_blockcyclic).

    The parts are concatenated and one repack launch gathers every new
    rank's blocks into one buffer; the result is per-rank views of it.  numpy parts go through the plain
    version on the CPU and come back as numpy arrays."""
    from repro_torch.kernels.ops import repack
    as_numpy = not isinstance(parts[0], torch.Tensor)
    tparts = [torch.from_numpy(np.ascontiguousarray(p)) for p in parts] \
        if as_numpy else list(parts)
    counts = [_blocks(p, block).shape[0] for p in tparts]
    idx = blockcyclic_index(counts, new_nprocs)
    src = _blocks(_cat(tparts), block)
    flat = src.reshape(src.shape[0], block, -1)
    out = repack(flat, np.concatenate(idx)).reshape(-1, *tparts[0].shape[1:])
    rows = [len(i) * block for i in idx]
    views = list(torch.split(out, rows, dim=0))
    return [v.numpy() for v in views] if as_numpy else views
