"""Decoder blocks (self-attention, for the encoder-decoder family
cross-attention over the encoder's output, then a dense MLP or, for the
MoE family, a mixture of experts), SSM (Mamba2) blocks and the
encoder-decoder family's bidirectional encoder blocks of the port (port of
``repro/models/blocks.py``).  A decoder block's full-sequence application
returns its MoE aux loss beside its output (zero for a dense MLP); its
decode step drops it, as the reference's."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import mlp, mlp_schema, rmsnorm, rmsnorm_schema


def decoder_block_schema(cfg: ArchConfig, cross: bool = False):
    s = {
        "ln1": rmsnorm_schema(cfg.d_model, cfg),
        "attn": attn.attention_schema(cfg),
        "ln2": rmsnorm_schema(cfg.d_model, cfg),
    }
    if cross:
        s["ln_x"] = rmsnorm_schema(cfg.d_model, cfg)
        s["cross"] = attn.attention_schema(cfg)
    if cfg.is_moe:
        s["moe"] = moe_mod.moe_schema(cfg)
    else:
        s["mlp"] = mlp_schema(cfg)
    return s


def decoder_block_apply(params, x, cfg: ArchConfig, *, positions,
                        enc_out=None, causal=True):
    """-> (x, aux): the block's output and its MoE aux loss (fp32).  With
    ``enc_out`` (B, S_enc, d), cross-attention over it follows the
    self-attention: non-causal, no rope."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    x = x + attn.attn_apply(params["attn"], h, cfg, positions=positions,
                            causal=causal)
    if enc_out is not None:
        h = rmsnorm(params["ln_x"], x, cfg.norm_eps)
        x = x + attn.attn_apply(params["cross"], h, cfg, positions=positions,
                                kv_x=enc_out, causal=False, rope=False)
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        y, aux = moe_mod.moe_apply(params["moe"], h, cfg)
    else:
        y = mlp(params["mlp"], h, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def decoder_block_decode(params, x, cfg: ArchConfig, cache, *, cache_index,
                         kv_len=None, cross_cache=None):
    """One-token decode. cache: {"k","v"} of this layer (updated in place);
    cross_cache: the encoder's K/V for this layer (read, never written)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a, cache = attn.decode_attn_apply(params["attn"], h, cfg, cache,
                                      cache_index=cache_index, kv_len=kv_len)
    x = x + a
    if cross_cache is not None:
        h = rmsnorm(params["ln_x"], x, cfg.norm_eps)
        a, _ = attn.decode_attn_apply(params["cross"], h, cfg, cross_cache,
                                      cache_index=cache_index, cross=True)
        x = x + a
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    if cfg.is_moe:
        y, _ = moe_mod.moe_apply(params["moe"], h, cfg)
    else:
        y = mlp(params["mlp"], h, cfg)
    return x + y, cache


# ----------------------------------------------------------------------
# SSM (Mamba2) block
# ----------------------------------------------------------------------

def ssm_block_schema(cfg: ArchConfig):
    return {"ln": rmsnorm_schema(cfg.d_model, cfg),
            "ssm": ssm_mod.ssm_schema(cfg)}


def ssm_block_apply(params, x, cfg: ArchConfig):
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    return x + ssm_mod.ssm_apply(params["ssm"], h, cfg)


def ssm_block_decode(params, x, cfg: ArchConfig, cache):
    """One-token decode. cache: this layer's SSM cache (updated in place)."""
    h = rmsnorm(params["ln"], x, cfg.norm_eps)
    y, cache = ssm_mod.ssm_decode_step(params["ssm"], h, cfg, cache)
    return x + y, cache


# ----------------------------------------------------------------------
# Encoder block (bidirectional)
# ----------------------------------------------------------------------

def encoder_block_schema(cfg: ArchConfig):
    return {
        "ln1": rmsnorm_schema(cfg.d_model, cfg),
        "attn": attn.attention_schema(cfg),
        "ln2": rmsnorm_schema(cfg.d_model, cfg),
        "mlp": mlp_schema(cfg),
    }


def encoder_block_apply(params, x, cfg: ArchConfig, *, positions):
    """Self-attention over the whole encoder sequence (no causal mask, rope
    on the encoder's own positions), then the MLP."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    x = x + attn.attn_apply(params["attn"], h, cfg, positions=positions,
                            causal=False)
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + mlp(params["mlp"], h, cfg)
