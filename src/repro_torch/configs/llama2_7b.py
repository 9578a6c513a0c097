"""llama2-7b [dense] — the paper's Table-1 pruning target. 32L d_model=4096
32H (MHA) d_ff=11008 vocab=32000. [arXiv:2307.09288; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=32000, head_dim=128,
    mlp_act="silu", rope_theta=1e4,
    source="arXiv:2307.09288",
)

TINY = ModelConfig(
    name="tiny-llama2", family="dense",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=344, vocab_size=512, head_dim=32,
    mlp_act="silu",
)
