from repro_torch.models.mamba import MambaModel
from repro_torch.models.mamba2 import Zamba2Model
from repro_torch.models.model import build_model
from repro_torch.models.moe import MoEModel
from repro_torch.models.transformer import DenseModel

__all__ = ["DenseModel", "MambaModel", "MoEModel", "Zamba2Model",
           "build_model"]
