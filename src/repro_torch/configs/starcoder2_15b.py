"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE. [arXiv:2402.19173; hf] (the port's copy of
``repro/configs/starcoder2_15b.py``)"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    d_ff=24576, vocab_size=49152, head_dim=128,
    mlp_act="gelu", rope_theta=1e5,
    source="arXiv:2402.19173 / hf:bigcode/starcoder2-15b",
)

TINY = ModelConfig(
    name="tiny-starcoder2-15b", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, head_dim=16,
    mlp_act="gelu",
)
