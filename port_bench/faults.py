"""Faults planted under the timed path: for the benchmark's tests, which
see ``correct`` come out false under each, and for the readings that set
the upper ends of its limits (``control.py``).  Each is a ``breaks``
dict that a driver's ``run`` applies to the job it builds.

Training: the step leaves the state as it was (the optimizer writes
nothing); half of each batch is left out, the loss a mean over the rest;
the loss the step produces is altered.  CG: the iteration returns its
state unchanged; the product reads half of A's rows; an entry of x is
altered where the iteration produces it.  No cell runs across cards, so
no fault leaves an exchange between them out.
"""
from __future__ import annotations


def _wrap_step(app, wrap):
    """``app`` with each step closure ``fn`` replaced by ``wrap(fn)``."""
    from repro_torch import dmr
    return dmr.App(init=app.init_state, shardings=app.state_shardings,
                   step=lambda mesh: wrap(app.make_step(mesh)),
                   name=app.name)


class _FrozenOptimizer:
    """An optimizer whose update writes nothing."""

    def __init__(self, opt):
        self.opt = opt
        self.moment_dtype = opt.moment_dtype

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        from repro_torch import tree as T
        from repro_torch.optim.adamw import OptState, global_norm
        return params, OptState(mu=state.mu, nu=state.nu,
                                count=state.count + 1), \
            global_norm(T.leaves(grads))


def _half_batch(fn):
    def step(state, i, batch=None):
        return fn(state, i, {k: v[: v.shape[0] // 2]
                             for k, v in batch.items()})
    return step


def _loss_altered(fn):
    def step(state, i, batch=None):
        state, met = fn(state, i, batch)
        return state, dict(met, loss=met["loss"] * 1.05)
    return step


def _cg_unchanged(fn):
    import torch
    return lambda state, i: (state, torch.sqrt(state["rs"]))


def _cg_half_rows(fn):
    import torch

    def step(state, i):
        A = state["A"]
        h = A.shape[0] // 2
        half = dict(state, A=torch.cat([A[:h], torch.zeros_like(A[h:])]))
        new, res = fn(half, i)
        return dict(new, A=A), res
    return step


def _cg_x_altered(fn):
    def step(state, i):
        new, res = fn(state, i)
        x = new["x"].clone()
        x[0] += 1.0
        return dict(new, x=x), res
    return step


FAULTS = {
    "lm_train": {
        "state_unchanged": {"optimizer": _FrozenOptimizer},
        "half_batch": {"app": lambda app: _wrap_step(app, _half_batch)},
        "answer_altered": {"app": lambda app: _wrap_step(app,
                                                         _loss_altered)},
    },
    "cg": {
        "state_unchanged": {"app": lambda app: _wrap_step(app,
                                                          _cg_unchanged)},
        "half_batch": {"app": lambda app: _wrap_step(app, _cg_half_rows)},
        "answer_altered": {"app": lambda app: _wrap_step(app,
                                                         _cg_x_altered)},
    },
}
