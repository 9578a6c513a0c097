"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a stub — a batch holds precomputed
frame embeddings (B, S, d_model) in place of tokens (the port's copy of
``repro/configs/musicgen_medium.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    mlp_act="gelu", rope_theta=1e4,
    frontend="audio_frames",
    source="arXiv:2306.05284 / hf:facebook/musicgen-medium",
)

TINY = ModelConfig(
    name="tiny-musicgen", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=192, vocab_size=128, head_dim=16,
    mlp_act="gelu", frontend="audio_frames",
)
