"""Weight and state conversion from the JAX package.

The JAX package's parameters, moved to the host as a numpy pytree
(``jax.tree.map(np.asarray, params)``), are nested dicts keyed by the same
paths as the port's (``layers/attn/wq``, ...), with the same shapes and
layouts, so conversion is leaf-by-leaf.  Used by the parity tests, and
accepted by ``make_decode_app`` / ``decode_demo`` as ``params=``; a whole
training state crosses with ``train_state_from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T


def _tensor(a) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays -> the same dict of torch tensors (a
    bfloat16 array, as JAX's bf16 master weights come, keeps its bits)."""
    return T.tree_map(lambda a: _tensor(a).to(device), tree)


def train_state_from_numpy(state, device="cpu"):
    """A JAX ``TrainState`` on the host (``jax.tree.map(np.asarray,
    state)``) -> the port's ``TrainState``, leaf for leaf: the two have the
    same fields in the same order (params, opt (mu, nu, count), step, rng,
    data_cursor) and the same dtypes (the key data stays uint32)."""
    from repro_torch.models.train import TrainState
    from repro_torch.optim.adamw import OptState
    conv = lambda x: params_from_numpy(x, device)
    return TrainState(params=conv(state.params),
                      opt=OptState(*(conv(x) for x in state.opt)),
                      step=conv(state.step), rng=conv(state.rng),
                      data_cursor=conv(state.data_cursor))
