"""Nested-dict pytrees: the port's stand-in for ``jax.tree``.

Parameters, caches and job states are nested ``dict``s whose leaves are
tensors (or ``ParamDef`` / placement objects).  Keys are visited in sorted
order, as ``jax.tree`` flattens dicts, and a leaf's path is its keys joined
by ``/`` (``layers/attn/wq``) — the strings the redistribution patterns
match on and the JAX package's ``_path_str`` produces.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_node(x) -> bool:
    return isinstance(x, dict)


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in sorted-key order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        out.extend(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, new_leaves: List[Any]):
    """Rebuild ``like``'s structure with ``new_leaves`` (flatten order)."""
    it = iter(new_leaves)

    def build(node):
        if not _is_node(node):
            return next(it)
        return {k: build(node[k]) for k in sorted(node)}

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_map(f: Callable, tree, *rest):
    """Apply ``f`` leaf-wise over ``tree`` and congruent ``rest`` trees."""
    if not _is_node(tree):
        return f(tree, *rest)
    return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in tree}
