"""Architecture & shape configuration system (the port's own copy).

Every architecture is one frozen ``ArchConfig``.  This is a field-for-field
copy of the JAX package's ``repro/configs/base.py`` so that the PyTorch
port imports nothing of the JAX package; ``repro_torch.models`` is driven
entirely by this dataclass.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    experts_per_token: int
    d_ff: int                     # hidden size of each expert MLP
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD — state-space duality) block configuration."""

    state_size: int               # N — SSM state dimension
    head_dim: int = 64            # P — SSD head dim
    expand: int = 2               # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256         # SSD chunk length


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() provides precomputed embeddings.

    ``embed_dim`` is the dimensionality of the precomputed patch / frame
    embeddings; the model owns only the projection ``embed_dim -> d_model``.
    """

    kind: str                     # "vision" | "audio"
    embed_dim: int
    tokens_per_sample: int        # patches (vision) / frames (audio)


@dataclass(frozen=True)
class ArchConfig:
    # -- identity -------------------------------------------------------
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""              # provenance note from the assignment

    # -- trunk ----------------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0             # 0 -> d_model // num_heads
    d_ff: int = 0                 # dense-MLP hidden (0 for pure-SSM / pure-MoE)
    vocab_size: int = 0

    # -- attention flavour ----------------------------------------------
    attention: str = "full"       # full | swa | none
    window: int = 0               # sliding-window size when attention == swa
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0

    # -- MoE / SSM / hybrid ---------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one *shared-weight* attention block applied after
    # every ``shared_attention_every`` SSM layers.
    shared_attention_every: int = 0

    # -- encoder/decoder --------------------------------------------------
    encoder_layers: int = 0       # >0 -> encoder-decoder (cross-attention)

    # -- modality frontend (stub) ----------------------------------------
    frontend: Optional[FrontendConfig] = None

    # -- numerics ----------------------------------------------------------
    dtype: str = "bfloat16"       # activation / weight compute dtype
    param_dtype: str = "float32"  # master weight dtype
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # -- training ----------------------------------------------------------
    remat: bool = True            # activation checkpointing over the layer scan
    attn_chunk_q: int = 1024      # chunked-attention tile sizes (reference path)
    attn_chunk_k: int = 1024
    train_microbatches: int = 1   # gradient-accumulation microbatches
    opt_moment_dtype: str = "float32"  # AdamW moment dtype (bf16 at 235B scale)

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.attention != "none" and self.num_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # convenience ------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def is_ssm(self) -> bool:
        return self.ssm is not None and self.attention == "none" \
            and self.shared_attention_every == 0

    @property
    def is_hybrid(self) -> bool:
        return self.ssm is not None and self.shared_attention_every > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def ssm_d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        assert self.ssm is not None
        return self.ssm_d_inner // self.ssm.head_dim

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic context handling (SSM state / sliding window)."""
        if self.ssm is not None:
            return True           # SSD is linear; hybrid decode is O(S) per token
        return self.attention == "swa"


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                     # train | prefill | decode
    seq_len: int
    global_batch: int


def phys_vocab(vocab_size: int, multiple: int = 128) -> int:
    """Physical (padded) vocab rows: keeps the embedding/unembed shardable by
    any mesh axis up to ``multiple``. Labels always index the true vocab."""
    return -(-vocab_size // multiple) * multiple


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k",    "train",   4_096,   256),
    ShapeConfig("prefill_32k", "prefill", 32_768,  32),
    ShapeConfig("decode_32k",  "decode",  32_768,  128),
    ShapeConfig("long_500k",   "decode",  524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a dry-run cell is live, and why not if skipped.

    Rules from the assignment: ``long_500k`` needs sub-quadratic attention —
    skip for pure full-attention archs; encoder-only archs skip decode shapes
    (none of our archs are encoder-only).
    """
    if shape.name == "long_500k" and not arch.supports_long_context:
        return False, "full quadratic attention; 500k context infeasible (DESIGN.md §5)"
    return True, ""


# ----------------------------------------------------------------------
# Reduced (smoke-test) configs: same family, tiny dims.
# ----------------------------------------------------------------------

def reduced(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    kw = dict(
        name=f"{cfg.name}-smoke",
        num_layers=min(cfg.num_layers, 2),
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        dtype="float32",
        param_dtype="float32",
        opt_moment_dtype="float32",
        remat=False,
        attn_chunk_q=32,
        attn_chunk_k=32,
        train_microbatches=1,     # full-config fit knobs don't apply at smoke size
        rope_theta=cfg.rope_theta,
    )
    if cfg.attention != "none":
        kw.update(num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2) or 2,
                  head_dim=16)
        if cfg.attention == "swa":
            kw.update(window=16)
    else:
        kw.update(num_heads=0, num_kv_heads=0, head_dim=0)
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=4,
                              experts_per_token=min(cfg.moe.experts_per_token, 2),
                              d_ff=64, capacity_factor=2.0)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(state_size=16, head_dim=16, expand=2,
                              conv_width=4, chunk_size=32)
    if cfg.shared_attention_every:
        kw["shared_attention_every"] = 2
        kw.update(num_heads=4, num_kv_heads=4, head_dim=16)
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.frontend is not None:
        kw["frontend"] = FrontendConfig(kind=cfg.frontend.kind, embed_dim=32,
                                        tokens_per_sample=8)
    base_fields = {f.name for f in dataclasses.fields(ArchConfig)}
    merged = {**{k: getattr(cfg, k) for k in base_fields}, **kw}
    return ArchConfig(**merged)


SMOKE_SHAPE = ShapeConfig("smoke", "train", 64, 4)
SMOKE_PREFILL = ShapeConfig("smoke_prefill", "prefill", 64, 2)
SMOKE_DECODE = ShapeConfig("smoke_decode", "decode", 64, 4)
