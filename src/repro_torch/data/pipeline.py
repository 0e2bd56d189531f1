"""Deterministic, shardable synthetic data pipeline (port of
``repro/data/pipeline.py``: numpy code, array for array the reference's).

The stream is a pure function of the sample cursor, so the data-iterator
state that survives a malleability resize (or a checkpoint restore) is a
single integer — the paper's redistribution of "the current iteration"
(§3.3) generalized to data order.  The token stream embeds a learnable
affine-successor pattern, so training runs show a decreasing loss.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig


def _rows(cfg: ArchConfig, shape: ShapeConfig, cursor: int, rows: int,
          seq_len: int, seed: int):
    """Deterministic (rows, seq_len) int32 tokens for samples
    [cursor, cursor + rows)."""
    V = cfg.vocab_size
    a, b = 31, 17                       # affine successor patterns
    out = np.empty((rows, seq_len), np.int32)
    for i in range(rows):
        rng = np.random.default_rng(np.uint64(seed * 1_000_003 + cursor + i))
        t = np.empty(seq_len, np.int64)
        t[0] = rng.integers(0, V)
        noise = rng.random(seq_len) < 0.1
        rnd = rng.integers(0, V, seq_len)
        for j in range(1, seq_len):
            t[j] = rnd[j] if noise[j] else (a * t[j - 1] + b) % V
        out[i] = t
    return out


class SyntheticDataset:
    """Checkpointable synthetic stream: state == the sample cursor."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, seed: int = 0,
                 global_batch: int | None = None):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.global_batch = global_batch or shape.global_batch

    def text_len(self) -> int:
        cfg, shape = self.cfg, self.shape
        if cfg.frontend is not None and cfg.frontend.kind == "vision":
            return shape.seq_len - cfg.frontend.tokens_per_sample
        return shape.seq_len

    def batch_at(self, cursor: int) -> Dict[str, np.ndarray]:
        cfg, shape = self.cfg, self.shape
        B = self.global_batch
        S = self.text_len()
        toks = _rows(cfg, shape, cursor, B, S + 1, self.seed)
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((B, S), np.float32),
        }
        rng = np.random.default_rng(np.uint64(self.seed * 7 + cursor + 1))
        if cfg.frontend is not None and cfg.frontend.kind == "vision":
            P, E = cfg.frontend.tokens_per_sample, cfg.frontend.embed_dim
            batch["patch_embeds"] = rng.standard_normal((B, P, E)).astype(
                np.float32)
        if cfg.is_encdec:
            E = cfg.frontend.embed_dim
            batch["frames"] = rng.standard_normal(
                (B, shape.seq_len, E)).astype(np.float32)
        return batch


def make_batch(cfg: ArchConfig, shape: ShapeConfig, cursor: int = 0,
               seed: int = 0) -> Dict[str, np.ndarray]:
    return SyntheticDataset(cfg, shape, seed).batch_at(cursor)


# ----------------------------------------------------------------------
# input_specs -- meta stand-ins for the dry run (no allocation)
# ----------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """A step's inputs for (arch, shape) as meta tensors: the batch of a
    train or prefill step, with the vision family's patch embeddings and
    the encoder-decoder family's frames; a decode step's cache comes from
    ``model.init_cache`` on meta."""
    B, S = shape.global_batch, shape.seq_len
    spec = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    S_text = S
    specs: Dict[str, torch.Tensor] = {}
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        P, E = cfg.frontend.tokens_per_sample, cfg.frontend.embed_dim
        S_text = S - P
        specs["patch_embeds"] = spec(B, P, E)
    if cfg.is_encdec:
        specs["frames"] = spec(B, S, cfg.frontend.embed_dim)
    specs["tokens"] = spec(B, S_text, dt=torch.int32)
    if shape.kind == "train":
        specs["labels"] = spec(B, S_text, dt=torch.int32)
        specs["mask"] = spec(B, S_text)
    return specs
