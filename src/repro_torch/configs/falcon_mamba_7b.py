"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16 — Mamba-1 architecture. [arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    source="arXiv:2410.05355 / hf:tiiuae/falcon-mamba-7b",
)

TINY = ModelConfig(
    name="tiny-falcon-mamba", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=256,
    ssm_state=8, ssm_conv=4, ssm_expand=2,
)
