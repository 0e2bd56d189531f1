"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA decoder-only.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 [arXiv:2412.08905; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    source="arXiv:2412.08905; hf",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    attention="full",
    tie_embeddings=True,
)
