"""Model registry: config → model instance (dense, MoE, SSM and hybrid
families)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba import MambaModel
from repro_torch.models.mamba2 import Zamba2Model
from repro_torch.models.moe import MoEModel
from repro_torch.models.transformer import DenseModel

_FAMILY = {"dense": DenseModel, "moe": MoEModel, "ssm": MambaModel,
           "hybrid": Zamba2Model}


def build_model(cfg: ModelConfig, remat: bool = True):
    """The model of ``cfg``'s family; ``remat`` recomputes each block in
    backward (the reference's ``build_model(cfg, remat=...)``)."""
    if cfg.family not in _FAMILY:
        raise ValueError(f"family {cfg.family!r} is not ported; ported: "
                         f"{', '.join(_FAMILY)}")
    return _FAMILY[cfg.family](cfg, remat=remat)


__all__ = ["build_model"]
