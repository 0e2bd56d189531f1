"""Weight conversion from the JAX package's parameters.

The JAX package's parameters, moved to the host as a numpy pytree
(``jax.tree.map(np.asarray, params)``), are nested dicts keyed by the same
paths as the port's (``layers/attn/wq``, ...), with the same shapes and
layouts, so conversion is leaf-by-leaf.  Used by the parity tests, and
accepted by ``make_decode_app`` / ``decode_demo`` as ``params=``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T


def params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays -> the same dict of torch tensors."""
    return T.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)
