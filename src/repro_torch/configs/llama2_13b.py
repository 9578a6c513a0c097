"""llama2-13b [dense] — the paper's Table-2 pruning target. 40L d_model=5120
40H (MHA) d_ff=13824 vocab=32000. [arXiv:2307.09288; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-13b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=13824, vocab_size=32000, head_dim=128,
    mlp_act="silu", rope_theta=1e4,
    source="arXiv:2307.09288",
)

TINY = ModelConfig(
    name="tiny-llama2-13b", family="dense",
    num_layers=5, d_model=160, num_heads=5, num_kv_heads=5,
    d_ff=432, vocab_size=512, head_dim=32,
    mlp_act="silu",
)
