"""llama31-8b [dense] — the paper's Table-3/4 quantization target. 32L
d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256. [arXiv:2407.21783; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama31-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    mlp_act="silu", rope_theta=5e5,
    source="arXiv:2407.21783",
)

TINY = ModelConfig(
    name="tiny-llama31", family="dense",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=448, vocab_size=512, head_dim=32,
    mlp_act="silu",
)
