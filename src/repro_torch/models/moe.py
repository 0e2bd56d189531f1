"""Mixture-of-experts of the port: top-k router and capacity-bucketed
dispatch (port of ``repro/models/moe.py``, its global formulation
``moe_apply_reference``).

The port is one process: its logical workers never split the router's
tokens, so :func:`moe_apply` is the global formulation at every worker
count.  (Under a mesh of several devices the JAX package routes each
shard's tokens on their own, with a per-shard capacity; that dispatch,
``_moe_apply_shardmap``, waits for the multi-process slice.)

The JAX package computes this layer in jnp, outside any Pallas kernel, and
so does the port in plain PyTorch: ``torch.bmm`` for the three expert
products; a stable sort, ``searchsorted``, ``index_put`` and gathers for
the dispatch.  Dtypes follow the reference: router logits, softmax and the
aux loss in fp32; token rows, buckets, expert products and the combine in
``cfg.dtype``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamDef, torch_dtype

#: while :func:`count_drops` is active, one ``(dropped, routed)`` pair per
#: ``moe_apply`` call: device scalars, read once at the end
_drops = None


def moe_schema(cfg: ArchConfig):
    assert cfg.moe is not None
    d, e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff
    pd = cfg.param_dtype
    return {
        "router": ParamDef((d, e), ("embed", "experts_in"), dtype=pd),
        "wi_gate": ParamDef((e, d, f), ("experts", "embed", "expert_mlp"), dtype=pd),
        "wi_up":   ParamDef((e, d, f), ("experts", "embed", "expert_mlp"), dtype=pd),
        "wo":      ParamDef((e, f, d), ("experts", "expert_mlp", "embed"), dtype=pd,
                            init="scaled_normal"),
    }


def capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for ``tokens`` tokens, on the host as the
    reference computes it: ``T k cf / E`` truncated, rounded up to 8, at
    least 8."""
    m = cfg.moe
    c = int(tokens * m.experts_per_token * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, equal values in
    ascending index order (``torch.topk`` promises no order for ties; a
    stable descending sort keeps the lower index first)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@contextlib.contextmanager
def count_drops():
    """Collect, for every ``moe_apply`` call inside the block, the
    assignments dropped over capacity and those routed; the yielded dict's
    ``"dropped"`` and ``"routed"`` are filled (one host read) on exit."""
    global _drops
    out, _drops = {"dropped": 0, "routed": 0}, []
    try:
        yield out
    finally:
        pairs, _drops = _drops, None
        if pairs:
            out["dropped"] = int(torch.stack([d for d, _ in pairs]).sum())
            out["routed"] = sum(r for _, r in pairs)


def route(probs, k: int, C: int):
    """The reference's routing of T tokens' router probabilities (T, E):
    top-k gates renormalised over the k, then each assignment's rank among
    its expert's, by a stable sort (earlier tokens keep their slots), kept
    while below the capacity ``C``.  Returns ``(gate_vals, expert_idx)``,
    both (T, k), and ``(keep, slot_e, slot_c)``, each (T k,): a dropped
    assignment's expert slot is the extra bucket ``E`` (the reference's
    out-of-bounds index, which its ``mode="drop"`` scatter ignores) and its
    capacity slot 0."""
    T, E = probs.shape
    gate_vals, expert_idx = _top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    # sort-based ranks: O(Tk) memory, never the (Tk, E) one-hot cumsum
    flat_e = expert_idx.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=probs.device))
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(T * k, device=probs.device) - starts[sorted_e]
    keep = pos < C
    return (gate_vals, expert_idx), (keep, torch.where(keep, flat_e, E),
                                     torch.where(keep, pos, 0))


def moe_apply(params, x, cfg: ArchConfig):
    """x: (B, S, D) -> ((B, S, D) in ``cfg.dtype``, fp32 aux loss)."""
    m = cfg.moe
    dt = torch_dtype(cfg.dtype)
    B, S, D = x.shape
    T = B * S
    k = m.experts_per_token
    E = m.num_experts
    C = capacity(T, cfg)

    xf = x.reshape(T, D)
    logits = xf.float() @ params["router"].float()               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    (gate_vals, expert_idx), (keep, slot_e, slot_c) = route(probs, k, C)
    if _drops is not None:
        _drops.append(((~keep).sum(), T * k))

    # ---- aux loss (Switch-style load balancing); the one-hot carries no
    # gradient: the router's reaches it through mean(probs) only ----------
    density = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
    density_prob = probs.mean(dim=0)
    aux_loss = (density * density_prob).sum() * E * m.aux_loss_weight

    # ---- dispatch into (E, C, D) buckets; dropped rows land in bucket E,
    # which is cut away --------------------------------------------------
    token_rows = xf.to(dt).repeat_interleave(k, dim=0)            # (Tk, D)
    buckets = torch.zeros((E + 1, C, D), dtype=dt, device=x.device).index_put(
        (slot_e, slot_c), token_rows)[:E]

    # ---- expert compute ------------------------------------------------
    g = torch.bmm(buckets, params["wi_gate"].to(dt))
    u = torch.bmm(buckets, params["wi_up"].to(dt))
    y = torch.bmm(F.silu(g) * u, params["wo"].to(dt))             # (E, C, D)

    # ---- combine: a dropped assignment reads zeros (the reference's
    # fill on read); its clamped slot is never used ----------------------
    gathered = y[slot_e.clamp(max=E - 1), slot_c]                 # (Tk, D)
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=dt, device=x.device))
    w = gate_vals.reshape(T * k, 1).to(dt)
    out = (gathered * w).reshape(T, k, D).sum(dim=1)
    return out.reshape(B, S, D), aux_loss
