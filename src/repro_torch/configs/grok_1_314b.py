"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig

# grok-1's experts are gated (three matrices an expert, which is what
# makes the total 314B); the gate is modelled with the silu-gated MLP
# path (the gating nonlinearity approximated, the widths exact)
CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072, head_dim=128,
    num_experts=8, experts_per_token=2,
    mlp_act="silu", rope_theta=1e4,
    source="hf:xai-org/grok-1",
)

TINY = ModelConfig(
    name="tiny-grok-1", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=256, head_dim=16,
    num_experts=4, experts_per_token=2,
    mlp_act="silu",
)
