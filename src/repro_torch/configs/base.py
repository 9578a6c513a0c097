"""Model configuration (the port's copy of ``repro/configs/base.py``,
dense family only: the port runs ``llama32-1b``)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

_ARCH_IDS = ["llama32-1b"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense (the only family the port runs)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    mlp_act: str = "silu"       # silu (gated) | relu2 | gelu (non-gated)
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    frontend: Optional[str] = None
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/head rows padded to a multiple of 2048 (128 for small
        vocabularies); padded logit columns are masked out."""
        if self.vocab_size >= 2048:
            return -(-self.vocab_size // 2048) * 2048
        return -(-self.vocab_size // 128) * 128

    def param_count(self) -> int:
        """Total parameter count N of the dense family."""
        if self.family != "dense":
            raise ValueError(self.family)
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        attn = d * (self.num_heads * hd) * 2 + d * (self.num_kv_heads * hd) * 2
        gate = 3 if self.mlp_act == "silu" else 2
        n = L * (attn + gate * d * self.d_ff)
        n += d * self.vocab_size * (1 if self.tie_embeddings else 2)
        return int(n)


def _module_name(arch_id: str) -> str:
    return "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "p")


def _check(arch_id: str) -> None:
    if arch_id not in _ARCH_IDS:
        raise ValueError(f"arch {arch_id!r} is not ported; ported: "
                         f"{', '.join(_ARCH_IDS)}")


def get_config(arch_id: str) -> ModelConfig:
    _check(arch_id)
    return importlib.import_module(_module_name(arch_id)).CONFIG


def get_tiny_config(arch_id: str) -> ModelConfig:
    _check(arch_id)
    return importlib.import_module(_module_name(arch_id)).TINY


def list_archs():
    return list(_ARCH_IDS)


__all__ = ["ModelConfig", "get_config", "get_tiny_config", "list_archs"]
