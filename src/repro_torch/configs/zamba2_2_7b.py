"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242; hf",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,             # MHA in the shared block
    head_dim=80,
    d_ff=10240,                  # shared block MLP hidden
    vocab_size=32000,
    attention="full",
    ssm=SSMConfig(state_size=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    shared_attention_every=6,    # one shared-weight attn block per 6 mamba layers
)
