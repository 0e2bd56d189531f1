"""mamba2-370m [ssm] — pure SSD (state-space duality), attention-free.

48L d_model=1024 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    source="arXiv:2405.21060; unverified",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm=SSMConfig(state_size=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    tie_embeddings=True,
)
