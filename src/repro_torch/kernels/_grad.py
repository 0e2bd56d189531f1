"""When a wrapper's call must carry a gradient: the one condition shared by
the kernels' wrappers, kept apart so that it is testable on CPU tensors."""
from __future__ import annotations

import torch


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd would record a call on ``tensors``: grad mode is
    on and one of them requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
