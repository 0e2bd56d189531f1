"""Roofline terms of one NVIDIA H100 for a step, from the port's count
(``launch/flopcount.py``); port of ``repro/launch/roofline.py``.

    compute term    = FLOPs / (chips x 989.4e12)
    memory term     = HBM bytes / (chips x 3.35e12)
    collective term = 0

The count is of the whole step (every worker's share together), so the
terms divide by ``chips`` peaks.  On one card a step runs no collective,
and the dry run's logical meshes run none either: the collective term is
0, recorded as such.  MODEL_FLOPS is the analytic useful-work count
(``param_counts`` and ``model_flops`` below, the JAX package's line for
line) that the waste ratio ``useful_ratio`` and MFU are taken against.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, phys_vocab
from repro_torch.launch.flopcount import FlopCount

#: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit: the dense
#: bf16 tensor-core peak and the HBM3 rate of its data sheet; a card set
#: below 700 W runs slower under load, so every measured share names the
#: card's limit beside it
PEAK_FLOPS = 989.4e12      # bf16 FLOP/s, dense
HBM_BW = 3.35e12           # bytes/s
DEFAULT_CARD_BYTES = 80e9  # when no card is present


def card_bytes() -> float:
    """The card's memory (``total_memory`` of card 0), else 80 GB."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return DEFAULT_CARD_BYTES


# ----------------------------------------------------------------------
# Analytic model FLOPs (useful work)
# ----------------------------------------------------------------------

def param_counts(cfg: ArchConfig) -> Dict[str, float]:
    """Total and active (per-token) parameter counts."""
    d = cfg.d_model
    V = phys_vocab(cfg.vocab_size)
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    per_layer_attn = 0.0
    if cfg.attention != "none" and cfg.num_heads:
        hd = cfg.head_dim
        per_layer_attn = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd \
            + cfg.num_heads * hd * d
    mlp = 3 * d * cfg.d_ff if cfg.d_ff else 0.0
    moe_total = moe_active = 0.0
    if cfg.moe is not None:
        e = cfg.moe
        moe_total = 3 * d * e.d_ff * e.num_experts + d * e.num_experts
        moe_active = 3 * d * e.d_ff * e.experts_per_token + d * e.num_experts
    ssm = 0.0
    if cfg.ssm is not None:
        di, n, h = cfg.ssm_d_inner, cfg.ssm.state_size, cfg.ssm_num_heads
        ssm = 2 * d * di + 2 * d * n + d * h + di * d

    if cfg.is_ssm:
        layer_total = layer_active = ssm
        n_layers = cfg.num_layers
        total = emb + n_layers * ssm
        active = total
    elif cfg.is_hybrid:
        groups = cfg.num_layers // cfg.shared_attention_every
        shared = per_layer_attn + mlp
        total = emb + cfg.num_layers * ssm + shared
        # shared block executes once per group
        active = emb + cfg.num_layers * ssm + shared * groups
        layer_total = layer_active = ssm
    else:
        layer_total = per_layer_attn + (moe_total or mlp)
        layer_active = per_layer_attn + (moe_active or mlp)
        n_dec = cfg.num_layers
        total = emb + n_dec * layer_total
        active = emb + n_dec * layer_active
        if cfg.is_encdec:
            enc_layer = per_layer_attn + mlp
            cross = per_layer_attn
            total += cfg.encoder_layers * enc_layer + n_dec * cross
            active += cfg.encoder_layers * enc_layer + n_dec * cross
    if cfg.frontend is not None:
        total += cfg.frontend.embed_dim * d
        active += cfg.frontend.embed_dim * d
    return {"total": total, "active": active}


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Analytic useful FLOPs per executed step, GLOBAL (all chips).

    train:   6 * N_active * tokens  (+ attention quadratic term)
    prefill: 2 * N_active * tokens  (+ attention term)
    decode:  2 * N_active * batch   (+ attention over the cache)
    """
    counts = param_counts(cfg)
    N = counts["active"]
    B, S = shape.global_batch, shape.seq_len
    d_attn = cfg.num_heads * cfg.head_dim if cfg.num_heads else 0

    def attn_term(tokens, ctx, layers):
        # 2 * (QK^T) + 2 * (PV) = 4 * tokens * ctx * d_attn per layer
        if not d_attn:
            return 0.0
        eff_ctx = min(ctx, cfg.window) if cfg.attention == "swa" else ctx
        return 4.0 * tokens * eff_ctx * layers * d_attn

    if cfg.is_hybrid:
        attn_layers = cfg.num_layers // cfg.shared_attention_every
    elif cfg.attention == "none":
        attn_layers = 0
    else:
        attn_layers = cfg.num_layers + (cfg.encoder_layers or 0)

    if shape.kind == "train":
        toks = B * S
        flops = 6.0 * N * toks + 3.0 * attn_term(toks, S / 2, attn_layers)
        return flops * max(1, 1)      # microbatching doesn't change totals
    if shape.kind == "prefill":
        toks = B * S
        return 2.0 * N * toks + attn_term(toks, S / 2, attn_layers)
    # decode: one token per sequence against a seq_len cache
    toks = B * 1
    return 2.0 * N * toks + attn_term(toks, S, attn_layers)


# ----------------------------------------------------------------------
# Roofline report
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    counted_flops: float               # the whole step's (flopcount)
    useful_ratio: float                # model_flops / counted_flops
    step_time_s: float                 # max of the three terms
    mfu: float                         # model_flops / (chips*peak*step_time)
    memory_fit_gib: float
    note: str = ""

    def as_dict(self):
        return dataclasses.asdict(self)


def build_roofline(cfg: ArchConfig, shape: ShapeConfig, mesh_name: str,
                   chips: int, counted: FlopCount,
                   memory_bytes: float, note: str = "") -> Roofline:
    compute_s = counted.flops / (chips * PEAK_FLOPS)
    memory_s = counted.hbm_bytes / (chips * HBM_BW)
    collective_s = 0.0
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    step = max(terms.values())
    mfu = mf / (chips * PEAK_FLOPS * step) if step > 0 else 0.0
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=mf, counted_flops=counted.flops,
        useful_ratio=mf / counted.flops if counted.flops else 0.0,
        step_time_s=step, mfu=mfu,
        memory_fit_gib=memory_bytes / 2 ** 30, note=note)


def measured_mfu(flops: float, step_s: float, chips: int = 1) -> float:
    """``flops`` (``model_flops``) over what ``chips`` cards could do at
    their peak in ``step_s`` measured seconds."""
    return flops / (chips * PEAK_FLOPS * step_s)
