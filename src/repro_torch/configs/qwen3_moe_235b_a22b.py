"""qwen3-moe-235b-a22b [moe] — 128 experts top-8.

94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B; hf",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,                       # all MLPs are MoE
    vocab_size=151936,
    attention="full",
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, experts_per_token=8, d_ff=1536),
    # 235B on 256 x 16GiB chips: bf16 master + moments (stochastic-rounding
    # caveat documented in DESIGN.md) and 8 accumulation microbatches
    # (15.0 GiB/chip at train_4k; see EXPERIMENTS.md §Perf iteration log).
    param_dtype="bfloat16",
    opt_moment_dtype="bfloat16",
    train_microbatches=8,
)
