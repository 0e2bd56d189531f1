"""Shared layers: norms, RoPE, MLPs, embeddings (port of
``repro/models/layers.py``, with the same fp32 upcasts)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, phys_vocab
from repro_torch.models.params import ParamDef, torch_dtype


# ----------------------------------------------------------------------
# RMSNorm
# ----------------------------------------------------------------------

def rmsnorm_schema(dim: int, cfg: ArchConfig):
    return {"scale": ParamDef((dim,), ("norm",), dtype=cfg.param_dtype, init="ones")}


def rmsnorm(params, x, eps: float):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ----------------------------------------------------------------------
# Rotary position embeddings
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)     # (half,)
    ang = positions[..., :, None].float() * inv               # (..., seq, half)
    sin = torch.sin(ang)[..., :, None, :]                     # broadcast over heads
    cos = torch.cos(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# SwiGLU MLP
# ----------------------------------------------------------------------

def mlp_schema(cfg: ArchConfig, d_in: Optional[int] = None,
               d_ff: Optional[int] = None):
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    pd = cfg.param_dtype
    return {
        "wi_gate": ParamDef((d, f), ("embed", "mlp"), dtype=pd),
        "wi_up":   ParamDef((d, f), ("embed", "mlp"), dtype=pd),
        "wo":      ParamDef((f, d), ("mlp", "embed"), dtype=pd, init="scaled_normal"),
    }


def mlp(params, x, cfg: ArchConfig):
    dt = torch_dtype(cfg.dtype)
    gate = x @ params["wi_gate"].to(dt)
    up = x @ params["wi_up"].to(dt)
    return (F.silu(gate) * up) @ params["wo"].to(dt)


# ----------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------

def embed_schema(cfg: ArchConfig):
    vp = phys_vocab(cfg.vocab_size)
    s = {"embedding": ParamDef((vp, cfg.d_model), ("vocab", "embed"),
                               dtype=cfg.param_dtype, scale=0.02)}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamDef((cfg.d_model, vp), ("embed", "vocab"),
                                dtype=cfg.param_dtype)
    return s


def embed(params, tokens, cfg: ArchConfig):
    # gather, then cast: the same values as casting the table first, without
    # converting every row of the table on every decode step
    return params["embedding"][tokens].to(torch_dtype(cfg.dtype))


def unembed(params, x, cfg: ArchConfig):
    dt = torch_dtype(cfg.dtype)
    if cfg.tie_embeddings:
        return x @ params["embedding"].to(dt).t()         # (..., V)
    return x @ params["unembed"].to(dt)
