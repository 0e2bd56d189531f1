"""seamless-m4t-medium [audio] — encoder-decoder, audio frontend STUB.

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596; hf]

Encoder-decoder: 12 encoder + 12 decoder layers with cross-attention. The
speech frontend is a stub: the batch carries precomputed frame embeddings
at 1024 dims (``frames``, ``data/pipeline.py``).
"""
from repro_torch.configs.base import ArchConfig, FrontendConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596; hf",
    num_layers=12,                # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    attention="full",
    frontend=FrontendConfig(kind="audio", embed_dim=1024,
                            tokens_per_sample=1024),
)
