"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified] (the
port's copy of ``repro/configs/nemotron_4_340b.py``)"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000, head_dim=192,
    mlp_act="relu2", rope_theta=1e4,
    source="arXiv:2402.16819",
)

TINY = ModelConfig(
    name="tiny-nemotron", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=256, head_dim=16,
    mlp_act="relu2",
)
