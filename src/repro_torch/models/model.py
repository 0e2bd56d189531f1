"""Model assembly of the port: the dense decoder-only family (port of the
dense branches of ``repro/models/model.py``).

Layer stacks are ``(L, ...)`` tensors indexed per layer in a Python loop,
where the JAX package scans.  SSM, hybrid, MoE, encoder-decoder and vision
families come in later slices and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks, params as P
from repro_torch.models.layers import (embed, embed_schema, rmsnorm,
                                       rmsnorm_schema, unembed)


def _require_dense(cfg: ArchConfig):
    if cfg.is_ssm or cfg.is_hybrid or cfg.is_moe or cfg.is_encdec or \
            cfg.frontend is not None or cfg.attention == "none":
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the PyTorch port runs the dense "
            "decoder-only family so far")


# ----------------------------------------------------------------------
# Schema
# ----------------------------------------------------------------------

def model_schema(cfg: ArchConfig):
    _require_dense(cfg)
    return {"embed": embed_schema(cfg),
            "ln_f": rmsnorm_schema(cfg.d_model, cfg),
            "layers": P.stack(blocks.decoder_block_schema(cfg), cfg.num_layers)}


def init_params(cfg: ArchConfig, gen: torch.Generator, device="cpu"):
    return P.init(model_schema(cfg), gen, device)


def layer(stacked, i: int):
    """Layer ``i``'s parameters (or cache) from an ``(L, ...)`` stack: views."""
    return T.tree_map(lambda t: t[i], stacked)


# ----------------------------------------------------------------------
# Trunk (prefill / train forward)
# ----------------------------------------------------------------------

def forward_hidden(params, cfg: ArchConfig, batch: Dict[str, Any]):
    """Trunk only -> (final normed hidden (B, S, D), aux_loss = 0)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.num_layers):
        x = blocks.decoder_block_apply(layer(params["layers"], i), x, cfg,
                                       positions=positions, causal=True)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params, cfg: ArchConfig, batch: Dict[str, Any]):
    """Full-sequence forward -> (full logits, aux_loss)."""
    x, aux = forward_hidden(params, cfg, batch)
    return unembed(params["embed"], x, cfg), aux


# ----------------------------------------------------------------------
# Decode (serving) path
# ----------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device="cpu"):
    """Decode-state tree for one new token against a seq_len-deep context:
    ``{"layers": {"k", "v"}}`` of shape (L, B, S, Hkv, hd)."""
    _require_dense(cfg)
    one = attn_mod.init_kv_cache(cfg, batch, seq_len, device)
    return {"layers": {n: t.unsqueeze(0).repeat(cfg.num_layers,
                                                *([1] * t.dim()))
                       for n, t in one.items()}}


def decode_step(params, cfg: ArchConfig, tokens, cache, cache_index):
    """One-token decode. tokens: (B, 1) int; cache_index: 0-d int tensor on
    the device.  Returns (logits, cache); the cache is updated in place
    (see ``attention.decode_attn_apply``)."""
    _require_dense(cfg)
    x = embed(params["embed"], tokens, cfg)
    kv_len = (cache_index + 1).to(torch.int32)      # once per step, on device
    for i in range(cfg.num_layers):
        x, _ = blocks.decoder_block_decode(
            layer(params["layers"], i), x, cfg, layer(cache["layers"], i),
            cache_index=cache_index, kv_len=kv_len)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params["embed"], x, cfg), cache
