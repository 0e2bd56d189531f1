"""GQA attention of the port (port of ``repro/models/attention.py``, dense
path).  Both call sites run the flash-attention kernel
(``repro_torch.kernels.ops.flash_attention``): ``attn_apply`` in place of
the JAX package's pure-jnp ``chunked_attention``, and ``decode_attn_apply``
in place of its einsum softmax over the cache.  The sequence-parallel
``shard_map`` path waits for the multi-process slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.params import ParamDef, torch_dtype


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


def _project_qkv(params, x, cfg: ArchConfig, positions, rope: bool = True):
    dt = torch_dtype(cfg.dtype)
    q = _heads(x, params["wq"], dt)
    k = _heads(x, params["wk"], dt)
    v = _heads(x, params["wv"], dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    if cfg.qk_norm:
        q = rmsnorm({"scale": params["q_norm"]}, q, cfg.norm_eps)
        k = rmsnorm({"scale": params["k_norm"]}, k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(o, params, dt):
    """``einsum("bshk,hkd->bsd")``; o: (B, S, H, hd)."""
    h, k, d = params["wo"].shape
    return o.reshape(*o.shape[:2], h * k) @ params["wo"].to(dt).reshape(h * k, d)


# ----------------------------------------------------------------------
# Full layer applications
# ----------------------------------------------------------------------

def attn_apply(params, x, cfg: ArchConfig, *, positions, causal: bool = True,
               rope: bool = True):
    """Self-attention over a full sequence (prefill / train forward)."""
    dt = torch_dtype(cfg.dtype)
    q, k, v = _project_qkv(params, x, cfg, positions, rope=rope)
    window = cfg.window if cfg.attention == "swa" else 0
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window)
    return _out_proj(out.transpose(1, 2), params, dt)


def decode_attn_apply(params, x, cfg: ArchConfig, cache, *, cache_index,
                      kv_len=None):
    """One-token decode against a KV cache.

    cache: {"k","v"}: (B, S_cache, Hkv, hd), updated IN PLACE at the new
    token's slot (the JAX version returns a new buffer; writing one slot
    saves a copy of the whole cache per layer per step).  ``cache_index``
    is the absolute position of the new token, a 0-d int tensor on the
    cache's device; ``kv_len`` (= cache_index + 1, computed once per step by
    the caller) is the number of filled slots the kernel reads.  For SWA the
    cache is a rolling buffer of ``window`` slots, all live.
    """
    dt = torch_dtype(cfg.dtype)
    B = x.shape[0]
    pos = cache_index.reshape(1, 1).expand(B, 1)
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
