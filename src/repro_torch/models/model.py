"""Model registry: config → model instance (dense and MoE families)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoEModel
from repro_torch.models.transformer import DenseModel

_FAMILY = {"dense": DenseModel, "moe": MoEModel}


def build_model(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise ValueError(f"family {cfg.family!r} is not ported; ported: "
                         f"{', '.join(_FAMILY)}")
    return _FAMILY[cfg.family](cfg)


__all__ = ["build_model"]
