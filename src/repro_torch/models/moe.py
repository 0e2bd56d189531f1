"""Mixture-of-experts of the port: top-k router and capacity-bucketed
dispatch (port of ``repro/models/moe.py``).

:func:`moe_apply` dispatches as the reference's does: under a sharding
context (``parallel/context.py``) whose mesh has more than one worker it
runs :func:`_moe_apply_shardmap`, a ``shard_map`` body
(``parallel/spmd.py``) in which each shard routes its own tokens with a
per-shard capacity ``C_loc``, in one of two modes:

  * EP, experts split over ``model``: the buckets go to their experts' workers
    by an all-to-all over ``model`` and come back by another;
  * TP, experts whole and their MLP's F axis split over ``model``
    (mixtral's rules): every ``model`` worker holds the same tokens,
    computes its F-slice of each expert product and the slices are summed
    over ``model``.  Where the F axis is not split over ``model`` (it does
    not divide, or the rules do not split it), each worker already holds
    the whole product and nothing is summed.  The reference psums there
    too, which multiplies the layer's output by the ``model`` size;
    the port keeps the contract of the reference's docstring instead.

The aux loss is each shard's estimator, averaged over the shards.
Without a context (or on one worker) it is the global formulation,
:func:`moe_apply_reference`.

The JAX package computes this layer in jnp, outside any Pallas kernel, and
so does the port in plain PyTorch: ``torch.bmm`` for the three expert
products; a stable sort, ``searchsorted``, ``index_put`` and gathers for
the global dispatch, one-hot cumulative sums for a shard's.  Dtypes
follow the reference: router logits, softmax and the aux loss in fp32;
token rows, buckets, expert products and the combine in ``cfg.dtype``.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamDef, torch_dtype
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import spmd
from repro_torch.parallel.context import constrain, get_context

#: while :func:`count_drops` is active, one ``(dropped, routed, capacity)``
#: triple per ``moe_apply`` call (per shard under a sharding context):
#: ``dropped`` a device scalar, read once at the end
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
    """Collect, for every ``moe_apply`` call inside the block (every
    shard's routing under a sharding context: a shard's own capacity
    ``C_loc`` drops its own assignments), the assignments dropped over
    capacity and those routed; the yielded dict's ``"dropped"``,
    ``"routed"`` and ``"capacities"`` (the distinct slots per expert the
    calls had, ascending) are filled (one host read) on exit."""
    global _drops
    out, _drops = {"dropped": 0, "routed": 0, "capacities": []}, []
    try:
        yield out
    finally:
        calls, _drops = _drops, None
        if calls:
            out["dropped"] = int(torch.stack([d for d, _, _ in calls]).sum())
            out["routed"] = sum(r for _, r, _ in calls)
            out["capacities"] = sorted({c for _, _, c in calls})


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
    """x: (B, S, D) -> ((B, S, D) in ``cfg.dtype``, fp32 aux loss): the
    sharded dispatch under a context of more than one worker, else the
    global formulation (the module's docstring)."""
    ctx = get_context()
    if ctx is not None and ctx[0].size > 1:
        return _moe_apply_shardmap(params, x, cfg, ctx[0], ctx[1])
    return moe_apply_reference(params, x, cfg)


def moe_apply_reference(params, x, cfg: ArchConfig):
    """The global (mesh-agnostic) formulation: x (B, S, D) -> ((B, S, D)
    in ``cfg.dtype``, fp32 aux loss)."""
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
        _drops.append(((~keep).sum(), T * k, C))

    buckets = _buckets(xf.to(dt).repeat_interleave(k, dim=0), slot_e,
                       slot_c, E, C)
    y = _experts(buckets, params["wi_gate"], params["wi_up"], params["wo"],
                 dt)
    out = _local_combine(y, slot_e, slot_c, keep, gate_vals, T)
    return out.reshape(B, S, D), _aux_loss(probs, expert_idx, cfg)


def _aux_loss(probs, expert_idx, cfg: ArchConfig):
    """Switch-style load balancing over the tokens of ``probs`` (T, E):
    the one-hot carries no gradient, the router's reaches it through
    mean(probs) only."""
    m = cfg.moe
    E = m.num_experts
    density = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
    return (density * probs.mean(dim=0)).sum() * E * m.aux_loss_weight


def _buckets(rows, slot_e, slot_c, E: int, C: int):
    """The (E, C, D) buckets of the assignments' rows (T k, D); a dropped
    assignment's row lands in the extra bucket E, which is cut away."""
    return torch.zeros((E + 1, C, rows.shape[-1]), dtype=rows.dtype,
                       device=rows.device).index_put((slot_e, slot_c),
                                                     rows)[:E]


# ----------------------------------------------------------------------
# shard_map dispatch: per-shard routing + explicit collectives
# ----------------------------------------------------------------------

def _local_dispatch(xf, logits, cfg: ArchConfig, C: int):
    """Token -> bucket dispatch for one shard's tokens (the reference's
    ``_local_dispatch``).  xf: (T, D), logits: (T, E) fp32.  Returns
    ``(buckets (E, C, D) in xf's dtype, slot_e, slot_c, keep, gate_vals,
    aux)``: an assignment's rank among its expert's is its one-hot
    cumulative sum (earlier tokens first), kept below ``C``; a dropped one
    has expert slot ``E`` and capacity slot 0."""
    m = cfg.moe
    T, D = xf.shape
    E, k = m.num_experts, m.experts_per_token
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    flat_e = expert_idx.reshape(T * k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)             # local: small
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = pos < C
    slot_e = torch.where(keep, flat_e, E)
    slot_c = torch.where(keep, pos, 0)
    buckets = _buckets(xf.repeat_interleave(k, dim=0), slot_e, slot_c, E, C)
    return (buckets, slot_e, slot_c, keep, gate_vals,
            _aux_loss(probs, expert_idx, cfg))


def _local_combine(y, slot_e, slot_c, keep, gate_vals, T: int):
    """y: (E, C, D) -> (T, D): each token's kept assignments' rows of
    ``y``, weighted by their gates; a dropped assignment reads zeros (the
    reference's fill on read), its clamped slot never used."""
    k = gate_vals.shape[-1]
    E, _, D = y.shape
    g = y[slot_e.clamp(max=E - 1), slot_c]
    g = torch.where(keep[:, None], g, torch.zeros((), dtype=y.dtype,
                                                  device=y.device))
    w = gate_vals.reshape(T * k, 1).to(y.dtype)
    return (g * w).reshape(T, k, D).sum(dim=1)


def _experts(b, wig, wiu, wo, dt):
    """The expert MLPs on buckets b (E', C', D): (E', C', D)."""
    g = torch.bmm(b, wig.to(dt))
    u = torch.bmm(b, wiu.to(dt))
    return torch.bmm(F.silu(g) * u, wo.to(dt))


def _moe_apply_shardmap(params, x, cfg: ArchConfig, mesh, rules):
    """Expert dispatch with explicit collectives under ``shard_map`` (the
    reference's ``_moe_apply_shardmap``; its modes and the one difference
    in the module's docstring).  Expert weights split over ``data`` at rest
    are gathered over it where they are used."""
    m = cfg.moe
    dt = torch_dtype(cfg.dtype)
    B, S, D = x.shape
    E, k = m.num_experts, m.experts_per_token
    ep_n = mesh.shape.get("model", 1)
    ep_mode = ("model" in spmd.entry_axes(rules.get("experts"))
               and E % ep_n == 0 and ep_n > 1)
    # EP: each shard routes its own slice of the sequence; TP: every model
    # worker holds the same tokens (their F-slices are summed)
    seq_axis = "act_seq_blk" if ep_mode else "act_seq"
    x = constrain(x, "act_batch", seq_axis, "act_embed")
    x_spec = shd.spec_for_axes(("act_batch", seq_axis, "act_embed"), rules,
                               mesh, x.shape)
    names, schema = ("router", "wi_gate", "wi_up", "wo"), moe_schema(cfg)
    specs = [shd.spec_for_axes(schema[n].axes, rules, mesh, params[n].shape)
             for n in names]
    # TP sums the products over model only where F is split over it
    tp_sum = not ep_mode and "model" in spmd.entry_axes(specs[1][2])

    def parts(i):
        e = x_spec[i] if i < len(x_spec) else None
        return math.prod(mesh.shape[a] for a in spmd.entry_axes(e))

    B_loc, S_loc = B // parts(0), S // parts(1)
    T_loc = B_loc * S_loc
    C_loc = max(8, -(-int(T_loc * k * m.capacity_factor / E) // 8) * 8)

    def body(*args):
        *ws, xb = args
        rw, wig, wiu, wo = (spmd.gather_split(w, spec, "data")
                            for w, spec in zip(ws, specs))

        def dispatch(xw, r):
            xf = xw.reshape(-1, D).to(dt)
            out = _local_dispatch(xf, xf.float() @ r.float(), cfg, C_loc)
            if _drops is not None:
                _drops.append(((~out[3]).sum(), T_loc * k, C_loc))
            return out

        buckets, se, sc, keep, gv, aux = spmd.each(dispatch, xb, rw)
        expert = lambda b, g, u, o: _experts(b, g, u, o, dt)
        if ep_mode:
            # (E, C, D) -> (E / ep, C ep, D) and back
            b = spmd.all_to_all(buckets, "model", 0, 1, tiled=True)
            y = spmd.each(expert, b, wig, wiu, wo)
            y = spmd.all_to_all(y, "model", 1, 0, tiled=True)
        else:
            y = spmd.each(expert, buckets, wig, wiu, wo)
            if tp_sum:
                y = spmd.psum(y, "model")
        out = spmd.each(
            lambda y_, e_, c_, k_, g_: _local_combine(
                y_, e_, c_, k_, g_, T_loc).reshape(B_loc, S_loc, D),
            y, se, sc, keep, gv)
        return out, spmd.pmean(aux, tuple(mesh.axis_names))

    return spmd.shard_map(body, mesh, specs + [x_spec], [x_spec, ()])(
        *[params[n] for n in names], x)
