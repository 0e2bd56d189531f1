"""pixtral-12b [vlm] — pixtral-ViT frontend (STUB) + mistral-nemo backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified]

The vision frontend is a stub: the batch carries precomputed patch
embeddings (``patch_embeds``, 1024-dim, pixtral ViT hidden size); the model
owns only the multimodal projection into the backbone.
"""
from repro_torch.configs.base import ArchConfig, FrontendConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,                 # mistral-nemo fixed head_dim
    d_ff=14336,
    vocab_size=131072,
    attention="full",
    rope_theta=1_000_000_000.0,
    frontend=FrontendConfig(kind="vision", embed_dim=1024,
                            tokens_per_sample=256),
)
