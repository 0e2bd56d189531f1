"""Pytrees of nested dicts and NamedTuples: the port's stand-in for
``jax.tree``.

Parameters, caches and job states are nested ``dict``s and ``NamedTuple``s
(``TrainState``, ``OptState``) whose leaves are tensors (or ``ParamDef`` /
placement objects).  Flatten order is ``jax.tree``'s: a dict's keys in
sorted order, a NamedTuple's fields in declaration order.  A leaf's path is
its keys and field names joined by ``/`` (``params/layers/attn/wq``,
``opt/mu/embed/embedding``, ``step``) — the strings the redistribution
patterns match on and the JAX package's ``_path_str`` produces.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _is_node(x) -> bool:
    return isinstance(x, dict) or _is_namedtuple(x)


def _children(node) -> List[Tuple[str, Any]]:
    """``(key, child)`` pairs in flatten order."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    return list(zip(node._fields, node))


def _rebuild(node, children: List[Any]):
    """A node like ``node`` holding ``children`` (in flatten order)."""
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    return type(node)(*children)


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in flatten order."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, child in _children(tree):
        out.extend(flatten(child, f"{prefix}/{k}" if prefix else k))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, new_leaves: List[Any]):
    """Rebuild ``like``'s structure with ``new_leaves`` (flatten order)."""
    it = iter(new_leaves)

    def build(node):
        if not _is_node(node):
            return next(it)
        return _rebuild(node, [build(c) for _, c in _children(node)])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def tree_map(f: Callable, tree, *rest):
    """Apply ``f`` leaf-wise over ``tree`` and congruent ``rest`` trees."""
    if not _is_node(tree):
        return f(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in tree}
    return type(tree)(*(tree_map(f, c, *rest_c) for c, *rest_c in
                        zip(tree, *rest)))
