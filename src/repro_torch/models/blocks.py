"""Dense decoder block of the port (port of ``repro/models/blocks.py``)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp, mlp_schema, rmsnorm, rmsnorm_schema


def decoder_block_schema(cfg: ArchConfig):
    return {
        "ln1": rmsnorm_schema(cfg.d_model, cfg),
        "attn": attn.attention_schema(cfg),
        "ln2": rmsnorm_schema(cfg.d_model, cfg),
        "mlp": mlp_schema(cfg),
    }


def decoder_block_apply(params, x, cfg: ArchConfig, *, positions, causal=True):
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    x = x + attn.attn_apply(params["attn"], h, cfg, positions=positions,
                            causal=causal)
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + mlp(params["mlp"], h, cfg)


def decoder_block_decode(params, x, cfg: ArchConfig, cache, *, cache_index,
                         kv_len=None):
    """One-token decode. cache: {"k","v"} of this layer (updated in place)."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a, cache = attn.decode_attn_apply(params["attn"], h, cfg, cache,
                                      cache_index=cache_index, kv_len=kv_len)
    x = x + a
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    return x + mlp(params["mlp"], h, cfg), cache
