"""``dmr.App`` — the paper's user-code surface as one small spec (port of
``repro/dmr/app.py``; a "mesh" is a ``repro_torch.parallel.mesh.JobMesh``
and a sharding tree a tree of ``Placement``s).

The paper's integration cost is three user functions (compute + the state's
layout) plus the malleability parameters; everything else is library-side.
``App`` mirrors that: bind ``init`` / ``shardings`` / ``step`` — as
constructor arguments or decorators — and the result satisfies the
:class:`MalleableApp` protocol every runner and simulator adapter consumes.

    app = dmr.App(name="cg")

    @app.init
    def init(mesh): ...                  # mesh -> state pytree

    @app.shardings
    def shardings(mesh): ...             # mesh -> placement tree

    @app.step
    def step(mesh): ...                  # mesh -> fn(state, i, *args)

    # or, in one call:
    app = dmr.App(init=init, shardings=shardings, step=step,
                  patterns={"table": "replicate"})

``patterns`` selects a named redistribution pattern per state subtree (see
``repro_torch.dmr.patterns``); the runner composes them on every resize.
``ensure_app`` adapts legacy protocol objects (``init_state`` /
``state_shardings`` / ``make_step`` methods) unchanged.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Protocol, runtime_checkable

from repro_torch.dmr.patterns import PatternSpec


@runtime_checkable
class MalleableApp(Protocol):
    """What a job must provide to become malleable (the paper's user code)."""

    def init_state(self, mesh) -> Any: ...
    def state_shardings(self, mesh) -> Any: ...
    def make_step(self, mesh) -> Callable[..., Any]: ...


class App:
    """Spec/decorator turning three plain functions into a MalleableApp."""

    def __init__(self, init: Optional[Callable] = None,
                 shardings: Optional[Callable] = None,
                 step: Optional[Callable] = None, *,
                 patterns: Optional[Dict[str, PatternSpec]] = None,
                 name: str = "app"):
        self._init = init
        self._shardings = shardings
        self._step = step
        self.patterns = dict(patterns) if patterns else None
        self.name = name

    # -- decorator registrars ------------------------------------------
    def init(self, fn: Callable) -> Callable:
        """Bind ``fn(mesh) -> state`` as the state initializer."""
        self._init = fn
        return fn

    def shardings(self, fn: Callable) -> Callable:
        """Bind ``fn(mesh) -> sharding pytree`` (congruent to the state)."""
        self._shardings = fn
        return fn

    def step(self, fn: Callable) -> Callable:
        """Bind ``fn(mesh) -> step_fn(state, i, *args)`` (one per mesh —
        the executable the runner swaps on a resize)."""
        self._step = fn
        return fn

    def _require(self, slot: str) -> Callable:
        fn = getattr(self, f"_{slot}")
        if fn is None:
            raise TypeError(
                f"App {self.name!r} has no {slot!r} function; bind it via "
                f"App({slot}=...) or the @app.{slot} decorator")
        return fn

    # -- MalleableApp protocol -----------------------------------------
    def init_state(self, mesh) -> Any:
        return self._require("init")(mesh)

    def state_shardings(self, mesh) -> Any:
        return self._require("shardings")(mesh)

    def make_step(self, mesh) -> Callable[..., Any]:
        return self._require("step")(mesh)

    def __repr__(self):
        bound = [s for s in ("init", "shardings", "step")
                 if getattr(self, f"_{s}") is not None]
        return f"App({self.name!r}, bound={bound}, patterns={self.patterns})"


def ensure_app(app: Any) -> MalleableApp:
    """Accept an ``App``, any MalleableApp-protocol object, or an object
    exposing plain ``init`` / ``shardings`` / ``step`` attributes."""
    if isinstance(app, App):
        return app
    if all(callable(getattr(app, m, None))
           for m in ("init_state", "state_shardings", "make_step")):
        return app
    if all(callable(getattr(app, m, None))
           for m in ("init", "shardings", "step")):
        return App(init=app.init, shardings=app.shardings, step=app.step,
                   patterns=getattr(app, "patterns", None),
                   name=type(app).__name__)
    raise TypeError(
        f"{app!r} is not a malleable app: provide init_state/state_shardings/"
        f"make_step (protocol) or init/shardings/step (dmr.App)")
