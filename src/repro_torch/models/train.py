"""Serve / prefill step factories of the port (port of the serving part of
``repro/models/train.py``; the training step comes with the next slice)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.layers import unembed


def _mask_padded_vocab(logits, cfg: ArchConfig):
    """Physical vocab is padded to a shardable multiple; mask the pad ids."""
    v = logits.shape[-1]
    if v == cfg.vocab_size:
        return logits
    ids = torch.arange(v, device=logits.device)
    return logits.masked_fill(ids[None, :] >= cfg.vocab_size, float("-inf"))


def make_serve_step(cfg: ArchConfig):
    """One-token batched decode: (params, cache, tokens, index) ->
    (next tokens (B, 1) int32, cache)."""
    def serve_step(params, cache, tokens, cache_index):
        logits, cache = M.decode_step(params, cfg, tokens, cache, cache_index)
        masked = _mask_padded_vocab(logits[:, -1, :], cfg)
        next_tok = torch.argmax(masked, dim=-1).to(torch.int32)
        return next_tok[:, None], cache

    return serve_step


def prefill_logits(params, cfg: ArchConfig, batch):
    """Full-sequence forward; only the last position's logits (B, V_phys)."""
    x, _ = M.forward_hidden(params, cfg, batch)
    return unembed(params["embed"], x[:, -1:, :], cfg)[:, -1, :]


def make_prefill_step(cfg: ArchConfig):
    """Full-sequence forward -> greedy next token per sequence (B,) int32."""
    def prefill_step(params, batch):
        masked = _mask_padded_vocab(prefill_logits(params, cfg, batch), cfg)
        return torch.argmax(masked, dim=-1).to(torch.int32)

    return prefill_step
