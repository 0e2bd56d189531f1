"""AdamW with decoupled weight decay and global-norm clipping (port of
``repro/optim/adamw.py``, in the same order of operations).

Optimizer moments live in the ``TrainState`` tree, so a malleability resize
redistributes them exactly like parameters — the paper's "robust restart"
(§3, Fig. 2) covers the full job state, not just model weights.

Unlike the JAX version, :meth:`AdamW.update` writes the new moments and
parameters into the tensors it is given (``state.mu`` / ``state.nu`` /
``params``) and returns them: at granite-3-2b's full depth a functional
update would hold a second 30 GB copy of params and moments beside them.
The arithmetic is the reference's, in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree as T
from repro_torch.models.params import torch_dtype


class OptState(NamedTuple):
    mu: Any          # first moment  (tree like params)
    nu: Any          # second moment (tree like params)
    count: torch.Tensor   # int32 scalar


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"   # bf16 for the 235B-class archs

    def _lr(self, count):
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.full((), self.learning_rate, dtype=torch.float32,
                          device=count.device)

    def init(self, params) -> OptState:
        dt = torch_dtype(self.moment_dtype)
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        device = T.leaves(params)[0].device
        return OptState(mu=T.tree_map(zeros, params),
                        nu=T.tree_map(zeros, params),
                        count=torch.zeros((), dtype=torch.int32,
                                          device=device))

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """-> (params, OptState, grad norm); ``grads``: a tree like
        ``params``.  Writes the moments and parameters in place, leaf by
        leaf (one leaf's fp32 temporaries live at a time)."""
        count = state.count + 1
        cf = count.float()
        g_leaves = T.leaves(grads)
        gnorm = global_norm(g_leaves)
        scale = None if self.clip_norm is None else \
            torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)

        mdt = torch_dtype(self.moment_dtype)
        bc1 = 1 - torch.pow(torch.full((), self.b1, device=cf.device), cf)
        bc2 = 1 - torch.pow(torch.full((), self.b2, device=cf.device), cf)
        lr = self._lr(count)
        for p, m, v, g in zip(T.leaves(params), T.leaves(state.mu),
                              T.leaves(state.nu), g_leaves):
            g = g.float() if scale is None else g.float() * scale
            m.copy_((self.b1 * m.float() + (1 - self.b1) * g).to(mdt))
            v.copy_((self.b2 * v.float() + (1 - self.b2) * g.square())
                    .to(mdt))
            step = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) +
                                        self.eps)
            if self.weight_decay and p.dim() >= 2:   # no decay on norms
                step = step + self.weight_decay * p.float()
            p.copy_((p.float() - lr * step).to(p.dtype))
        return params, OptState(mu=state.mu, nu=state.nu, count=count), gnorm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    leaves = tree if isinstance(tree, list) else T.leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))
