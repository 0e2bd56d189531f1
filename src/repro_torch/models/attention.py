"""GQA attention of the port (port of ``repro/models/attention.py``, dense
path).  Both call sites run the flash-attention kernel
(``repro_torch.kernels.ops.flash_attention``): ``attn_apply`` in place of
the JAX package's pure-jnp ``chunked_attention``, and ``decode_attn_apply``
in place of its einsum softmax over the cache.  Each also takes the
encoder-decoder family's cross-attention: ``attn_apply(kv_x=)`` reads keys
and values of the encoder's output (Sq != Sk, no causal mask), and
``decode_attn_apply(cross=True)`` reads a cross cache whose every slot is
valid.

Under a sharding context (``parallel/context.py``) whose mesh's ``model``
axis does not divide the head count but divides the sequence (phi4-mini's
24 heads or qwen2.5's 40 on 16 workers; every smoke config's 4 on 8),
``attn_apply`` runs the reference's sequence-parallel path as a
``shard_map`` body (``parallel/spmd.py``): each worker projects q, k and
v for its slice of the sequence, the workers all-gather K and V over
``model``, and each launches K1 for its queries over the whole sequence's
keys with a causal query offset (``q_offset``: its slice's first
position).  The weights are gathered over ``data`` where they are split
over it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.params import ParamDef, torch_dtype
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import spmd
from repro_torch.parallel.context import constrain, get_context


# ----------------------------------------------------------------------
# Schema
# ----------------------------------------------------------------------

def attention_schema(cfg: ArchConfig):
    d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = cfg.param_dtype
    s = {
        "wq": ParamDef((d, h, hd), ("embed", "q_heads", "head_dim"), dtype=pd),
        "wk": ParamDef((d, hk, hd), ("embed", "kv_heads", "head_dim"), dtype=pd),
        "wv": ParamDef((d, hk, hd), ("embed", "kv_heads", "head_dim"), dtype=pd),
        "wo": ParamDef((h, hd, d), ("q_heads", "head_dim", "embed"), dtype=pd,
                       init="scaled_normal"),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamDef((h, hd), ("q_heads", "head_dim"), dtype=pd, init="zeros")
        s["bk"] = ParamDef((hk, hd), ("kv_heads", "head_dim"), dtype=pd, init="zeros")
        s["bv"] = ParamDef((hk, hd), ("kv_heads", "head_dim"), dtype=pd, init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = ParamDef((hd,), ("head_dim",), dtype=pd, init="ones")
        s["k_norm"] = ParamDef((hd,), ("head_dim",), dtype=pd, init="ones")
    return s


# ----------------------------------------------------------------------
# Projections
# ----------------------------------------------------------------------

def _heads(x, w, dt):
    """``einsum("bsd,dhk->bshk")`` as one matmul."""
    d, h, k = w.shape
    return (x @ w.to(dt).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_q(params, x, cfg: ArchConfig, positions, rope: bool = True):
    dt = torch_dtype(cfg.dtype)
    q = _heads(x, params["wq"], dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
    if cfg.qk_norm:
        q = rmsnorm({"scale": params["q_norm"]}, q, cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta) if rope else q


def _project_qkv(params, x, cfg: ArchConfig, positions, kv_x=None,
                 rope: bool = True):
    """q from ``x``; k and v from ``kv_x`` when given (cross-attention),
    else from ``x``.  With rope, k takes its own positions ``0..Sk-1``
    when it comes from ``kv_x``."""
    dt = torch_dtype(cfg.dtype)
    kv_in = x if kv_x is None else kv_x
    q = _project_q(params, x, cfg, positions, rope=rope)
    k = _heads(kv_in, params["wk"], dt)
    v = _heads(kv_in, params["wv"], dt)
    if cfg.qkv_bias:
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        k = rmsnorm({"scale": params["k_norm"]}, k, cfg.norm_eps)
    if rope:
        k = apply_rope(k, positions if kv_x is None else torch.arange(
            kv_in.shape[1], device=kv_in.device)[None, :], cfg.rope_theta)
    return q, k, v


def _out_proj(o, params, dt):
    """``einsum("bshk,hkd->bsd")``; o: (B, S, H, hd)."""
    h, k, d = params["wo"].shape
    return o.reshape(*o.shape[:2], h * k) @ params["wo"].to(dt).reshape(h * k, d)


# ----------------------------------------------------------------------
# Full layer applications
# ----------------------------------------------------------------------

def attn_apply(params, x, cfg: ArchConfig, *, positions, kv_x=None,
               causal: bool = True, rope: bool = True):
    """Self- or cross-attention over a full sequence (prefill / train
    forward); cross-attention (``kv_x``, the encoder's output) passes its
    Sk = S_enc keys to K1 beside the Sq queries of ``x``.  Under a
    sharding context, self-attention takes the sequence-parallel path
    where the reference does (the module's docstring)."""
    ctx = get_context()
    if ctx is not None and kv_x is None:
        mesh, rules = ctx
        model_n = mesh.shape.get("model", 1)
        S = x.shape[1]
        if (model_n > 1 and cfg.num_heads % model_n != 0
                and S % model_n == 0 and S >= model_n):
            return _attn_apply_seq_shardmap(params, x, cfg, mesh, rules,
                                            causal=causal, rope=rope)
    dt = torch_dtype(cfg.dtype)
    x = constrain(x, "act_batch", "act_seq", "act_embed")
    if kv_x is not None:
        kv_x = constrain(kv_x, "act_batch", "act_seq", "act_embed")
    q, k, v = _project_qkv(params, x, cfg, positions, kv_x=kv_x, rope=rope)
    window = cfg.window if cfg.attention == "swa" else 0
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return _out_proj(out.transpose(1, 2), params, dt)


def _attn_apply_seq_shardmap(params, x, cfg: ArchConfig, mesh, rules, *,
                             causal: bool, rope: bool):
    """Sequence-parallel self-attention (the reference's
    ``_attn_apply_seq_shardmap``).

    x arrives split over the sequence by ``model`` (the block-boundary
    residual layout) and over the batch by ``data``; each worker projects
    q/k/v for its S / model positions, K and V are all-gathered over
    ``model`` (one tensor per group, shared by its workers), and each
    worker runs K1 on its queries with the causal query offset of its
    slice.  Weights split over ``data`` are gathered over it first."""
    dt = torch_dtype(cfg.dtype)
    B, S, D = x.shape
    S_loc = S // mesh.shape["model"]
    x_spec = shd.spec_for_axes(("act_batch", "act_seq_blk", "act_embed"),
                               rules, mesh, x.shape)
    schema = attention_schema(cfg)
    names = list(schema)
    specs = [shd.spec_for_axes(schema[n].axes, rules, mesh, params[n].shape)
             for n in names]
    window = cfg.window if cfg.attention == "swa" else 0

    def body(*args):
        *ws, xb = args
        p = {n: spmd.gather_split(w, spec, "data")
             for n, w, spec in zip(names, ws, specs)}
        offsets = [i * S_loc for i in spmd.axis_index("model")]

        def project(xw, off, *wl):
            pos = (off + torch.arange(S_loc, device=xw.device))[None, :]
            return _project_qkv(dict(zip(names, wl)), xw, cfg, pos,
                                rope=rope)

        q, k, v = spmd.each(project, xb, offsets, *(p[n] for n in names))
        k = spmd.all_gather(k, "model", axis=1, tiled=True)
        v = spmd.all_gather(v, "model", axis=1, tiled=True)

        def attend(qw, kw, vw, off, wo):
            o = flash_attention(qw.transpose(1, 2), kw.transpose(1, 2),
                                vw.transpose(1, 2), causal=causal,
                                window=window, q_offset=off)
            return _out_proj(o.transpose(1, 2), {"wo": wo}, dt)

        return spmd.each(attend, q, k, v, offsets, p["wo"])

    return spmd.shard_map(body, mesh, specs + [x_spec], x_spec)(
        *[params[n] for n in names], x)


def decode_attn_apply(params, x, cfg: ArchConfig, cache, *, cache_index,
                      kv_len=None, cross: bool = False):
    """One-token decode against a KV cache.

    cache: {"k","v"}: (B, S_cache, Hkv, hd), updated IN PLACE at the new
    token's slot (the JAX version returns a new buffer; writing one slot
    saves a copy of the whole cache per layer per step).  ``cache_index``
    is the absolute position of the new token, a 0-d int tensor on the
    cache's device; ``kv_len`` (= cache_index + 1, computed once per step by
    the caller) is the number of filled slots the kernel reads.  For SWA the
    cache is a rolling buffer of ``window`` slots, all live.

    ``cross``: the cache holds the encoder's keys and values (the
    reference's cross cache); q is projected without rope, nothing is
    written, and the kernel reads every slot, unmasked.  The reference
    projects k and v of the new token too and drops them: the port skips
    those two products.
    """
    dt = torch_dtype(cfg.dtype)
    B = x.shape[0]
    pos = cache_index.reshape(1, 1).expand(B, 1)
    if cross:
        q = _project_q(params, x, cfg, pos, rope=False)
        o = flash_attention(q.transpose(1, 2), cache["k"].transpose(1, 2),
                            cache["v"].transpose(1, 2), causal=False)
        return _out_proj(o.transpose(1, 2), params, dt), cache
    q, k_new, v_new = _project_qkv(params, x, cfg, pos)
    S = cache["k"].shape[1]
    if cfg.attention == "swa":
        slot, kv_len = torch.remainder(cache_index, S), S
    else:
        slot = cache_index
        if kv_len is None:
            kv_len = (cache_index + 1).to(torch.int32)
    slot = slot.reshape(1).long()
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    o = flash_attention(q.transpose(1, 2), cache["k"].transpose(1, 2),
                        cache["v"].transpose(1, 2), causal=False,
                        kv_len=kv_len)
    return _out_proj(o.transpose(1, 2), params, dt), cache


def init_kv_cache(cfg: ArchConfig, batch: int, seq_len: int, device="cpu"):
    window = cfg.window if cfg.attention == "swa" else 0
    S = min(seq_len, window) if window else seq_len
    shp = (batch, S, cfg.num_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shp, dtype=dt, device=device),
            "v": torch.zeros(shp, dtype=dt, device=device)}
