"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-235B-A22B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    num_experts=128, experts_per_token=8,
    mlp_act="silu", rope_theta=1e6,
    source="hf:Qwen/Qwen3-235B-A22B",
)

TINY = ModelConfig(
    name="tiny-qwen3-moe", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=96, vocab_size=256, head_dim=16,
    num_experts=8, experts_per_token=2,
    mlp_act="silu",
)
