"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE. [arXiv:2402.19173; hf] (the port's copy of
``repro/configs/starcoder2_7b.py``)"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152, head_dim=128,
    mlp_act="gelu", rope_theta=1e5,
    source="arXiv:2402.19173 / hf:bigcode/starcoder2-7b",
)

TINY = ModelConfig(
    name="tiny-starcoder2-7b", family="dense",
    num_layers=2, d_model=60, num_heads=3, num_kv_heads=1,
    d_ff=256, vocab_size=256, head_dim=20,
    mlp_act="gelu",
)
