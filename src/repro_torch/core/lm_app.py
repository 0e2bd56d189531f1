"""LM pretraining as a ``dmr.App`` (port of ``repro/core/lm_app.py``): the
paper's Listing 2, an elastic training job.

``lm_train_app`` binds (ArchConfig, shape, optimizer) into a
``repro_torch.dmr`` App: the job resizes between any legal worker counts;
the full TrainState (params, AdamW moments, step, RNG, data cursor) is
redistributed in memory on every resize (no ``patterns``: every leaf
moves by ``default``) and the per-mesh step closure is swapped.  As in
the reference, ``init_state`` and every step run inside
``sharding_context(mesh, rules_for(cfg))``: on a mesh of more than one
worker the step's attention takes the sequence-parallel path where the
head count does not split over ``model``, and a MoE layer routes each
shard's tokens on their own (``models/attention.py``, ``models/moe.py``),
so a step's numbers follow the worker count as the reference's do.
The deprecated ``LMTrainApp`` class of the reference is not ported.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.dmr.app import App
from repro_torch.models.train import TrainState, init_state, make_train_step
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel.context import sharding_context
from repro_torch.parallel.sharding import rules_for, state_shardings


class _LMTrainImpl:
    """The three user functions of the paper, for an LM training job."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 optimizer: Optional[AdamW] = None, seed: int = 0,
                 global_batch: Optional[int] = None):
        self.cfg = cfg
        self.shape = shape
        self.optimizer = optimizer or AdamW(
            learning_rate=1e-3, moment_dtype=cfg.opt_moment_dtype)
        self.seed = seed
        self.dataset = SyntheticDataset(cfg, shape, seed=seed,
                                        global_batch=global_batch)
        self.rules = rules_for(cfg)

    # -- MalleableApp protocol -----------------------------------------
    def state_shardings(self, mesh):
        return state_shardings(self.cfg, mesh)

    def init_state(self, mesh) -> TrainState:
        with sharding_context(mesh, self.rules):
            return init_state(self.cfg, self.optimizer, self.seed,
                              mesh.device)

    def make_step(self, mesh):
        ds = self.dataset
        train_step = make_train_step(self.cfg, self.optimizer)
        dev, rules = mesh.device, self.rules

        def fn(state: TrainState, step_i: int,
               batch: Optional[Dict[str, np.ndarray]] = None):
            if batch is None:
                batch = ds.batch_at(step_i * ds.global_batch)
            batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                     for k, v in batch.items()}
            with sharding_context(mesh, rules):
                return train_step(state, batch)

        return fn


def lm_train_app(cfg: ArchConfig, shape: ShapeConfig,
                 optimizer: Optional[AdamW] = None, seed: int = 0,
                 global_batch: Optional[int] = None) -> App:
    """LM pretraining as a ``repro_torch.dmr.App`` (the facade form)."""
    impl = _LMTrainImpl(cfg, shape, optimizer, seed, global_batch)
    app = App(init=impl.init_state, shardings=impl.state_shardings,
              step=impl.make_step, name=f"lm:{cfg.name}")
    app.dataset = impl.dataset           # exposed for data-pipeline callers
    return app
