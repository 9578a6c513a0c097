"""llama32-1b [dense] — the paper's Table-5 joint-compression target. 16L
d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256. [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama32-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=64,
    mlp_act="silu", rope_theta=5e5, tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)

TINY = ModelConfig(
    name="tiny-llama32", family="dense",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
    d_ff=256, vocab_size=512, head_dim=32,
    mlp_act="silu", tie_embeddings=True,
)
