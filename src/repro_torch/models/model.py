"""Model assembly of the port: every family of the JAX package's
``repro/models/model.py`` -- the dense and MoE decoder-only, the SSM
(Mamba2), the hybrid (zamba2), the encoder-decoder (seamless-m4t) and the
vision-prefix (pixtral) families.

Layer stacks are ``(L, ...)`` tensors indexed per layer in a Python loop,
where the JAX package scans.  A MoE decoder block holds a mixture of
experts (``models/moe.py``) where a dense block holds its MLP; the trunk
sums the blocks' aux losses over the layers.  The hybrid family runs its
SSM layers in groups of ``shared_attention_every``, each group followed by
ONE shared attention block (``params["shared_attn"]``, a single set of
leaves applied once per group).  The encoder-decoder family projects its
precomputed frames (``frontend_proj``), runs a bidirectional encoder stack
(``enc_layers``, ``ln_enc``) once, and gives its output to every decoder
block's cross-attention; its decode step reads a per-layer cross cache of
the encoder's keys and values.  The vision family prepends its projected
patch embeddings to the token embeddings.  Experts in an SSM or hybrid
model, and an encoder feeding one (whose trunk has no cross-attention),
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks, params as P, ssm as ssm_mod
from repro_torch.models.layers import (embed, embed_schema, rmsnorm,
                                       rmsnorm_schema, unembed)
from repro_torch.models.params import ParamDef, torch_dtype
from repro_torch.parallel.context import bind


def _require_supported(cfg: ArchConfig):
    """Admit the dense and MoE decoder-only, the SSM, the hybrid, the
    encoder-decoder and the vision-prefix families; raise for experts or an
    encoder in an SSM or hybrid model."""
    decoder = cfg.ssm is None and cfg.attention != "none"
    if not (decoder or cfg.is_ssm or cfg.is_hybrid) or \
            ((cfg.is_moe or cfg.is_encdec) and not decoder):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the PyTorch port runs experts and "
            "an encoder in decoder-only models only")
    if cfg.is_hybrid and cfg.num_layers % cfg.shared_attention_every:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                         f"groups of {cfg.shared_attention_every}")


def _shared_after(cfg: ArchConfig, i: int) -> bool:
    """Whether the hybrid's shared attention block follows SSM layer i."""
    return cfg.is_hybrid and (i + 1) % cfg.shared_attention_every == 0


# ----------------------------------------------------------------------
# Schema
# ----------------------------------------------------------------------

def model_schema(cfg: ArchConfig):
    _require_supported(cfg)
    ssm_layers = cfg.is_ssm or cfg.is_hybrid
    block = blocks.ssm_block_schema(cfg) if ssm_layers else \
        blocks.decoder_block_schema(cfg, cross=cfg.is_encdec)
    s = {"embed": embed_schema(cfg),
         "ln_f": rmsnorm_schema(cfg.d_model, cfg),
         "layers": P.stack(block, cfg.num_layers)}
    if cfg.is_hybrid:
        # ONE weight set {ln1, attn, ln2, mlp}, applied after every group
        s["shared_attn"] = blocks.decoder_block_schema(cfg)
    if cfg.is_encdec:
        s["enc_layers"] = P.stack(blocks.encoder_block_schema(cfg),
                                  cfg.encoder_layers)
        s["ln_enc"] = rmsnorm_schema(cfg.d_model, cfg)
    if cfg.frontend is not None:
        s["frontend_proj"] = ParamDef((cfg.frontend.embed_dim, cfg.d_model),
                                      ("frontend", "embed"),
                                      dtype=cfg.param_dtype)
    return s


def init_params(cfg: ArchConfig, gen: torch.Generator, device="cpu"):
    return P.init(model_schema(cfg), gen, device)


def abstract_params(cfg: ArchConfig):
    """``init_params``'s tree as meta tensors (a dry run's parameters)."""
    return P.abstract(model_schema(cfg))


def layer(stacked, i: int):
    """Layer ``i``'s parameters (or cache) from an ``(L, ...)`` stack: views."""
    return T.tree_map(lambda t: t[i], stacked)


# ----------------------------------------------------------------------
# Trunk (prefill / train forward)
# ----------------------------------------------------------------------

def _run(cfg: ArchConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant)
    with ``cfg.remat`` while a gradient is being recorded; the
    recomputation runs under the sharding context of the forward
    (``parallel.context.bind``: autograd may recompute on another
    thread)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(bind(fn), *args, use_reentrant=False)
    return fn(*args)


def _encode(params, frames, cfg: ArchConfig):
    """The encoder stack over precomputed frame embeddings (the reference's
    stub frontend): ``frames`` (B, S_enc, E) cast to ``cfg.dtype`` and
    projected, ``encoder_layers`` bidirectional blocks (each its own
    checkpoint unit under remat), then ``ln_enc``."""
    dt = torch_dtype(cfg.dtype)
    x = frames.to(dt) @ params["frontend_proj"].to(dt)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    stacks = T.tree_map(lambda t: t.unbind(0), params["enc_layers"])

    def body(h, lp):
        return blocks.encoder_block_apply(lp, h, cfg, positions=positions)

    for i in range(cfg.encoder_layers):
        x = _run(cfg, body, x, T.tree_map(lambda views: views[i], stacks))
    return rmsnorm(params["ln_enc"], x, cfg.norm_eps)


def forward_hidden(params, cfg: ArchConfig, batch: Dict[str, Any]):
    """Trunk only -> (final normed hidden (B, S, D), aux_loss): the MoE
    family's aux loss summed over the layers in order (fp32; zero for the
    other families).

    batch: ``tokens`` (B, S) int, always (the decoder's tokens);
    ``patch_embeds`` (B, P, E), the vision family's prefix, projected and
    prepended to the token embeddings (S grows to P + S, positions cover
    both); ``frames`` (B, S_enc, E), the encoder-decoder family's encoder
    input, encoded once (:func:`_encode`) and read by every decoder
    block's cross-attention.

    With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant), the counterpart of the reference's ``jax.checkpoint``
    over the layer scan: a layer keeps only its input for the backward and
    runs again there, so a training step launches each layer's kernel (K1
    or K3) forward twice and its backward once; a checkpointed decoder
    block returns its aux loss beside its output, and takes the encoder's
    output as an input of its own, so that the gradient reaching the
    encoder sums over the decoder layers.  The stacked parameters are
    unbound once, so their gradients are stacked once (indexing each layer
    would build a full-size zero gradient per layer).

    The hybrid trunk runs groups of ``shared_attention_every`` SSM blocks,
    each group followed by the shared attention block (the reference's
    ``_trunk``).  Under remat each SSM block and each application of the
    shared block is its own checkpoint unit; the reference nests
    ``jax.checkpoint`` (the group around its inner per-layer scan), which
    recomputes in another pattern but computes the same numbers.  The
    shared leaves are one set used once per group, so autograd sums their
    gradient over the groups."""
    _require_supported(cfg)
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, cfg)
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        dt = torch_dtype(cfg.dtype)
        patches = batch["patch_embeds"].to(dt) @ \
            params["frontend_proj"].to(dt)
        x = torch.cat([patches, x], dim=1)
    enc_out = _encode(params, batch["frames"], cfg) if cfg.is_encdec \
        else None
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    stacks = T.tree_map(lambda t: t.unbind(0), params["layers"])

    def body(h, lp, enc):
        if cfg.is_ssm or cfg.is_hybrid:
            return blocks.ssm_block_apply(lp, h, cfg), None
        return blocks.decoder_block_apply(lp, h, cfg, positions=positions,
                                          enc_out=enc, causal=True)

    def shared(h, sp):
        return blocks.decoder_block_apply(sp, h, cfg, positions=positions,
                                          causal=True)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, a = _run(cfg, body, x, T.tree_map(lambda views: views[i], stacks),
                    enc_out)
        if cfg.is_moe:
            aux = aux + a
        if _shared_after(cfg, i):
            x, _ = _run(cfg, shared, x, params["shared_attn"])
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return x, aux


def forward(params, cfg: ArchConfig, batch: Dict[str, Any]):
    """Full-sequence forward -> (full logits, aux_loss)."""
    x, aux = forward_hidden(params, cfg, batch)
    return unembed(params["embed"], x, cfg), aux


# ----------------------------------------------------------------------
# Decode (serving) path
# ----------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device="cpu",
               enc_len=None):
    """Decode-state tree for one new token against a seq_len-deep context:
    ``{"layers": {"k", "v"}}`` of shape (L, B, S, Hkv, hd) for the dense
    family, and beside it for the encoder-decoder family ``{"cross": {"k",
    "v"}}`` of shape (L, B, enc_len or seq_len, Hkv, hd), each layer's
    keys and values of the encoder's output (zeros here, as the
    reference's: its serving path never fills them); for the SSM family
    ``{"layers": {"state" (L, B, H, P, N) fp32, "conv_x", "conv_B",
    "conv_C" (L, B, W-1, C)}}``, whatever seq_len; for the hybrid family
    that SSM cache plus ``{"shared_kv": {"k", "v"}}`` of shape (groups, B,
    S, Hkv, hd), one KV cache per application of the shared block."""
    _require_supported(cfg)

    def stacked(one, n):
        return {k: t.unsqueeze(0).repeat(n, *([1] * t.dim()))
                for k, t in one.items()}

    if cfg.is_ssm or cfg.is_hybrid:
        cache = {"layers": stacked(ssm_mod.init_ssm_cache(cfg, batch, device),
                                   cfg.num_layers)}
        if cfg.is_hybrid:
            cache["shared_kv"] = stacked(
                attn_mod.init_kv_cache(cfg, batch, seq_len, device),
                cfg.num_layers // cfg.shared_attention_every)
        return cache
    cache = {"layers": stacked(
        attn_mod.init_kv_cache(cfg, batch, seq_len, device), cfg.num_layers)}
    if cfg.is_encdec:
        cache["cross"] = stacked(
            attn_mod.init_kv_cache(cfg, batch, enc_len or seq_len, device),
            cfg.num_layers)
    return cache


def decode_step(params, cfg: ArchConfig, tokens, cache, cache_index):
    """One-token decode. tokens: (B, 1) int; cache_index: 0-d int tensor on
    the device.  Returns (logits, cache); the cache is updated in place
    (see ``attention.decode_attn_apply`` and ``ssm.ssm_decode_step``); the
    encoder-decoder family's cross cache is read, never written."""
    _require_supported(cfg)
    x = embed(params["embed"], tokens, cfg)
    kv_len = (cache_index + 1).to(torch.int32)  # once per step, on device
    cross = cache.get("cross") if cfg.is_encdec else None
    for i in range(cfg.num_layers):
        lp, lc = layer(params["layers"], i), layer(cache["layers"], i)
        if cfg.is_ssm or cfg.is_hybrid:
            x, _ = blocks.ssm_block_decode(lp, x, cfg, lc)
        else:
            x, _ = blocks.decoder_block_decode(
                lp, x, cfg, lc, cache_index=cache_index, kv_len=kv_len,
                cross_cache=None if cross is None else layer(cross, i))
        if _shared_after(cfg, i):        # group i // every's own KV cache
            x, _ = blocks.decoder_block_decode(
                params["shared_attn"], x, cfg,
                layer(cache["shared_kv"], i // cfg.shared_attention_every),
                cache_index=cache_index, kv_len=kv_len)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params["embed"], x, cfg), cache
