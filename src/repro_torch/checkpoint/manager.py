"""On-disk checkpoint/restart — the paper's §2.1 baseline, and the fault-
tolerance fallback when in-memory redistribution (§2.2) is impossible (not
enough surviving workers).  Port of ``repro/checkpoint/manager.py``.

Layout, the JAX package's: one ``ckpt_<step>.npz`` per checkpoint, leaf
``i`` of the state's flatten order as ``leaf_<i>``, plus a JSON manifest.
The two packages flatten a TrainState in the same order, so a checkpoint
written by one restores in the other.  Leaves are numpy arrays on disk:
dtypes numpy has (fp32, int32, uint32, ...); a bfloat16 leaf is refused.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as T


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    try:
        return torch.empty(0, dtype=dtype).numpy().dtype
    except TypeError:
        raise TypeError(f"checkpoint: no numpy dtype for {dtype}") from None


def _flatten(state) -> Dict[str, np.ndarray]:
    out = {}
    for i, leaf in enumerate(T.leaves(state)):
        if isinstance(leaf, torch.Tensor):
            _numpy_dtype(leaf.dtype)
            leaf = leaf.detach().cpu().numpy()
        out[f"leaf_{i}"] = np.asarray(leaf)
    return out


def save_state(path: str, state, step: int) -> Dict[str, float]:
    """Write a checkpoint; returns timing/size stats."""
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    arrays = _flatten(state)
    fn = os.path.join(path, f"ckpt_{step:08d}.npz")
    np.savez(fn, **arrays)
    sz = os.path.getsize(fn)
    manifest = {"step": int(step), "file": os.path.basename(fn),
                "n_leaves": len(arrays), "bytes": sz}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return {"seconds": time.perf_counter() - t0, "bytes": sz}


def restore_state(path: str, like, shardings=None,
                  step: Optional[int] = None):
    """Restore into ``like``'s structure, dtypes and shapes, on ``like``'s
    devices, or on the mesh of ``shardings`` (a placement tree: a C/R-based
    resize onto any worker set)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    step = manifest["step"] if step is None else step
    fn = os.path.join(path, f"ckpt_{step:08d}.npz")
    with np.load(fn) as data:
        like_leaves = T.leaves(like)
        devices = [l.device for l in like_leaves] if shardings is None \
            else [p.mesh.device for p in T.leaves(shardings)]
        out = [torch.from_numpy(np.asarray(data[f"leaf_{i}"]).astype(
                   _numpy_dtype(l.dtype)).reshape(tuple(l.shape))).to(d)
               for i, (l, d) in enumerate(zip(like_leaves, devices))]
    return T.unflatten(like, out), step


class CheckpointManager:
    """Periodic checkpointing with retention, for the train loop."""

    def __init__(self, path: str, every_steps: int = 100, keep: int = 2):
        self.path = path
        self.every = every_steps
        self.keep = keep
        self.history: List[int] = []

    def maybe_save(self, state, step: int) -> Optional[Dict[str, float]]:
        if self.every <= 0 or step % self.every != 0:
            return None
        stats = save_state(self.path, state, step)
        self.history.append(step)
        while len(self.history) > self.keep:
            old = self.history.pop(0)
            fn = os.path.join(self.path, f"ckpt_{old:08d}.npz")
            if os.path.exists(fn):
                os.remove(fn)
        return stats

    def latest_step(self) -> Optional[int]:
        try:
            with open(os.path.join(self.path, "manifest.json")) as f:
                return json.load(f)["step"]
        except FileNotFoundError:
            return None
