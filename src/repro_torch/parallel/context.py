"""Activation-sharding context of the port (port of
``repro/parallel/context.py``).

Model code is mesh-agnostic; a training job activates a ``(mesh, rules)``
context for its steps, and two layers read it: ``attn_apply`` runs
sequence-parallel attention and ``moe_apply`` routes each shard's tokens
on their own when the mesh has more than one worker (``models/attention.py``,
``models/moe.py``, both through ``parallel/spmd.py``).  ``constrain()``
pins an activation's layout by logical axes where the reference pins it:
it resolves the placement and returns its input, since the workers of a
job mesh share one device and a placement there is bookkeeping.  Without
an active context nothing is resolved.

The state is thread-local, as the reference's.  A layer that autograd
recomputes in its backward (``cfg.remat``) may run on another thread (the
engine's device threads), so the model captures the context with
:func:`bind` around its checkpointed functions.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional, Tuple

_state = threading.local()

# activation logical axes (extend the weight rules)
ACT_RULES = {
    "act_batch": ("pod", "data"),
    "act_seq": None,
    # residual stream between blocks: Megatron-style sequence parallelism
    "act_seq_blk": ("model",),
    "act_embed": None,
    "act_heads": ("model",),
    "act_kv_heads": None,
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_experts": ("model",),
    "act_cap": None,
    "act_ssm_inner": ("model",),
}


def _get():
    return getattr(_state, "ctx", None)


def get_context() -> Optional[Tuple[object, dict]]:
    """(mesh, merged rules), or None outside a context."""
    return _get()


@contextlib.contextmanager
def suspend_sharding_context():
    """Deactivate the context for a block (a ``shard_map`` body, whose
    values are per worker already)."""
    prev = _get()
    _state.ctx = None
    try:
        yield
    finally:
        _state.ctx = prev


@contextlib.contextmanager
def sharding_context(mesh, rules: dict):
    """Activate ``(mesh, rules)``: the weight rules, with ``ACT_RULES`` for
    every activation axis they do not name."""
    merged = dict(rules)
    for k, v in ACT_RULES.items():
        merged.setdefault(k, v)
    prev = _get()
    _state.ctx = (mesh, merged)
    try:
        yield
    finally:
        _state.ctx = prev


@contextlib.contextmanager
def _entered(ctx):
    prev = _get()
    _state.ctx = ctx
    try:
        yield
    finally:
        _state.ctx = prev


def bind(fn):
    """``fn`` run under the context active now, wherever it is called
    (a checkpointed layer's recomputation in autograd's threads)."""
    ctx = _get()

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _entered(ctx):
            return fn(*args, **kwargs)

    return run


def constrain(x, *axes):
    """Pin ``x``'s layout by logical axes: the placement is resolved (more
    axes than ``x`` has dimensions raise ``ValueError``, as the reference's
    sharding constraint does) and ``x`` is returned as it is; no-op
    without a context."""
    ctx = _get()
    if ctx is None:
        return x
    mesh, rules = ctx
    from repro_torch.parallel.sharding import spec_for_axes
    if len(axes) > x.dim():
        raise ValueError(f"constrain: {len(axes)} axes for a {x.dim()}-d "
                         "value")
    spec_for_axes(axes, rules, mesh, tuple(x.shape))
    return x
