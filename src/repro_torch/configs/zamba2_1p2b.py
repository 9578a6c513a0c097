"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (MHA kv=32) d_ff=8192,
ssm_state=64 — Mamba-2 blocks + one shared attention block interleaved.
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
    attn_every=6,                       # shared block re-invoked every 6 blocks
    mlp_act="gelu", rope_theta=1e4,
    source="arXiv:2411.15242 / hf:Zyphra/Zamba2-1.2B",
)

TINY = ModelConfig(
    name="tiny-zamba2", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=16,
    attn_every=2, mlp_act="gelu",
)
