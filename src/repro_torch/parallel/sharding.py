"""Logical-axis sharding rules (MaxText-style) + per-arch overrides (port
of ``repro/parallel/sharding.py``, onto :class:`Placement`s).

Every parameter in the model schema carries a tuple of logical axis names;
``rules_for(cfg)`` maps those to mesh axes, and ``state_shardings`` /
``batch_shardings`` / ``cache_shardings`` give full placement trees for a
mesh.  Rules degrade gracefully: a mesh without a given axis (a job mesh
has no "pod") drops it.  On one card a placement is the layout a resize
accounts for, and the split a ``shard_map`` body's inputs take
(``parallel/spmd.py``).  On the dry run's production meshes it gives each
worker's bytes.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.parallel.mesh import Placement

Rules = Dict[str, Optional[Tuple[str, ...]]]

# Baseline rules: TP over "model", FSDP over "data" on the embed axis of
# weight matrices, batch over ("pod","data"). kv_heads replicated (GQA
# kv-count < model-axis on most archs — Megatron-style KV duplication).
DEFAULT_RULES: Rules = {
    "vocab": ("model",),
    "embed": ("data",),
    "q_heads": ("model",),
    "kv_heads": None,
    "head_dim": None,
    "mlp": ("model",),
    "experts": ("model",),
    "experts_in": None,
    "expert_mlp": None,
    "ssm_inner": ("model",),
    "ssm_heads": None,
    "ssm_state": None,
    "norm": None,
    "frontend": None,
    "layers": None,
    "batch": ("pod", "data"),
    "seq": None,
}

# Per-arch overrides.
ARCH_RULES: Dict[str, Rules] = {
    # mixtral: only 8 experts — TP inside each expert instead of padding the
    # expert axis onto 16 shards.
    "mixtral-8x7b": {"experts": None, "expert_mlp": ("model",)},
}


def rules_for(cfg: ArchConfig, overrides: Optional[Rules] = None) -> Rules:
    r = dict(DEFAULT_RULES)
    r.update(ARCH_RULES.get(cfg.name, {}))
    if overrides:
        r.update(overrides)
    return r


def spec_for_axes(axes: Tuple[Any, ...], rules: Rules, mesh,
                  shape: Optional[Tuple[int, ...]] = None) -> Tuple:
    """Map logical axes to mesh-axis entries, one per dimension, dropping
    mappings the dim size cannot honor (the reference keeps only exact
    divisions: e.g. 24 q_heads on a model=16 axis fall back to
    replication).  ``mesh``: anything with ``axis_names`` and a ``shape``
    dict."""
    entries = []
    for i, ax in enumerate(axes):
        mapped = rules.get(ax) if ax is not None else None
        if mapped is None:
            entries.append(None)
            continue
        if isinstance(mapped, str):
            mapped = (mapped,)
        live = tuple(a for a in mapped if a in mesh.axis_names)
        if shape is not None:
            # progressively drop trailing mesh axes until divisible
            while live:
                n = 1
                for a in live:
                    n *= mesh.shape[a]
                if shape[i] % n == 0 and shape[i] >= n:
                    break
                live = live[:-1]
        entries.append(live if len(live) > 1 else (live[0] if live else None))
    return tuple(entries)


# ----------------------------------------------------------------------
# Full trees
# ----------------------------------------------------------------------

def param_shardings(cfg: ArchConfig, mesh,
                    overrides: Optional[Rules] = None):
    rules = rules_for(cfg, overrides)
    return T.tree_map(
        lambda d: Placement(mesh, spec_for_axes(d.axes, rules, mesh,
                                                d.shape)),
        M.model_schema(cfg))


def state_shardings(cfg: ArchConfig, mesh,
                    overrides: Optional[Rules] = None):
    """Placements for a full TrainState (params + AdamW moments + scalars)."""
    from repro_torch.models.train import TrainState
    from repro_torch.optim.adamw import OptState
    ps = param_shardings(cfg, mesh, overrides)
    rep = Placement(mesh)
    return TrainState(
        params=ps,
        opt=OptState(mu=T.tree_map(lambda s: s, ps),
                     nu=T.tree_map(lambda s: s, ps), count=rep),
        step=rep, rng=rep, data_cursor=rep)


def _batch_axes(mesh, global_batch: int):
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    if global_batch % n == 0 and global_batch >= n:
        return axes
    if "data" in mesh.axis_names and global_batch % mesh.shape["data"] == 0:
        return ("data",)
    return ()  # tiny batch: replicate rows


def batch_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh,
                    batch: Dict[str, Any]):
    axes = _batch_axes(mesh, shape.global_batch)
    spec1 = axes if len(axes) > 1 else (axes[0] if axes else None)
    return {k: Placement(mesh, (spec1,) + (None,) * (len(v.shape) - 1))
            for k, v in batch.items()}


def cache_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh, cache):
    """Decode-cache placements, by leaf name (robust to stacking).

    KV caches (``k``, ``v``: (L, B, S, Hkv, hd)): batch over (pod, data)
    when divisible, and the sequence over "model" when it divides; at a
    batch the mesh cannot split (``long_500k``'s 1) the sequence also over
    "data" (sequence-parallel serving).  SSM states ((L, B, H, P, N)):
    heads over "model"; conv tails ((L, B, W-1, C)): channels over
    "model".  Every cache leaf has a leading layer (or group) axis, so the
    batch is axis 1."""
    axes = _batch_axes(mesh, shape.global_batch)
    bspec = axes if len(axes) > 1 else (axes[0] if axes else None)
    seq_par = not axes  # batch unshardable -> shard sequence/heads instead
    model_n = mesh.shape.get("model", 1)
    data_n = mesh.shape.get("data", 1)

    def _seq_axes(s: int):
        """Mesh axes for the cache's sequence dim: "model" whenever it
        divides (a 32k KV cache at batch 128 is ~800 GB), and "data" first
        when the batch is unshardable."""
        out, n = [], 1
        if seq_par and data_n > 1 and s > 1 and s % (n * data_n) == 0:
            out.append("data")
            n *= data_n
        if model_n > 1 and s > 1 and s % (n * model_n) == 0:
            out.append("model")
        if not out:
            return None
        return tuple(out) if len(out) > 1 else out[0]

    def leaf(path, x):
        name = path.rsplit("/", 1)[-1]
        spec = [None] * x.dim()
        if not seq_par:
            spec[1] = bspec            # axis 0 is the stacked layer axis
        if name in ("k", "v"):
            spec[2] = _seq_axes(x.shape[2])
        elif name == "state":
            if x.shape[2] % model_n == 0 and model_n > 1:
                spec[2] = "model"
        elif name.startswith("conv"):
            if x.shape[3] % model_n == 0 and model_n > 1:
                spec[3] = "model"
        return Placement(mesh, tuple(spec))

    flat = T.flatten(cache)
    return T.unflatten(cache, [leaf(p, x) for p, x in flat])
