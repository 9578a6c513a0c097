"""Model configuration (the port's copy of ``repro/configs/base.py``, for
the families the port runs: dense ``llama32-1b``, ``llama2-7b``,
``llama2-13b``, ``llama31-8b`` and ``granite-8b``, MoE
``qwen3-moe-235b-a22b``, SSM ``falcon-mamba-7b`` (Mamba-1) and hybrid
``zamba2-1.2b`` (Mamba-2 blocks and one shared attention block))."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

_ARCH_IDS = ["llama32-1b", "llama2-7b", "llama2-13b", "llama31-8b",
             "granite-8b", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
             "zamba2-1.2b"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                   # dense MLP dim; for moe = per-expert dim
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba1/mamba2) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64      # mamba2 only
    # --- hybrid (zamba2): one shared attention block every `attn_every` ---
    attn_every: int = 0
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

    @property
    def d_inner(self) -> int:        # ssm inner width
        return self.ssm_expand * self.d_model

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        return d * (self.num_heads * hd) * 2 + d * (self.num_kv_heads * hd) * 2

    def param_count(self) -> int:
        """Total parameter count N, as the reference counts it (for the
        SSM and hybrid families an estimate: it leaves out the norms and
        some small projections, kept so that both packages agree)."""
        d, L = self.d_model, self.num_layers
        gate = 3 if self.mlp_act == "silu" else 2
        if self.family == "dense":
            n = L * (self._attn_params() + gate * d * self.d_ff)
        elif self.family == "moe":
            mlp = (gate * d * self.d_ff * self.num_experts
                   + d * self.num_experts)
            n = L * (self._attn_params() + mlp)
        elif self.family == "ssm":
            di, N = self.d_inner, self.ssm_state
            n = L * (d * 2 * di + di * self.ssm_conv + di * (2 * N + 1) + di
                     + di * d)
        elif self.family == "hybrid":
            di = self.d_inner
            nh = di // self.ssm_head_dim
            n = L * (d * 2 * di + di * self.ssm_conv + 3 * nh + di + di * d)
            n += self._attn_params() + gate * d * self.d_ff
        else:
            raise ValueError(self.family)
        n += d * self.vocab_size * (1 if self.tie_embeddings else 2)
        return int(n)

    def active_param_count(self) -> int:
        """N_active: the parameters one token reads (MoE: its top-k
        experts); the whole count for the dense family."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        gate = 3 if self.mlp_act == "silu" else 2
        mlp = (gate * d * self.d_ff * self.experts_per_token
               + d * self.num_experts)
        return int(L * (self._attn_params() + mlp) + 2 * d * self.vocab_size)


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
