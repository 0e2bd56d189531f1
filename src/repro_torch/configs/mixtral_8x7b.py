"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    source="arXiv:2401.04088; hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,                       # all MLPs are MoE
    vocab_size=32000,
    attention="swa",
    window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, experts_per_token=2, d_ff=14336),
    # expert-TP dispatch gathers the sequence per model shard (8 experts
    # can't split 16 ways): microbatching keeps the capacity buckets and
    # activation stash under 16 GiB/chip (EXPERIMENTS.md §Perf).
    train_microbatches=2,
)
