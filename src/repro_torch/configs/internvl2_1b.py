"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2/Qwen2 backbone. [arXiv:2404.16821; hf]

Backbone only: the InternViT frontend is a stub — a batch holds
precomputed patch embeddings (B, P, d_model) placed ahead of the token
embeddings (the port's copy of ``repro/configs/internvl2_1b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    mlp_act="silu", rope_theta=1e6,
    frontend="vision_patches", num_patches=256,
    source="arXiv:2404.16821 / hf:OpenGVLab/InternVL2-1B",
)

TINY = ModelConfig(
    name="tiny-internvl2", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    mlp_act="silu", frontend="vision_patches", num_patches=16,
)
