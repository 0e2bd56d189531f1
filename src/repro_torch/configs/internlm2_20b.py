"""internlm2-20b [dense] — GQA decoder-only transformer.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544 [arXiv:2403.17297; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    source="arXiv:2403.17297; hf",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    attention="full",
    rope_theta=1_000_000.0,
    train_microbatches=2,     # fits train_4k under 16 GiB/chip on 256 chips
)
