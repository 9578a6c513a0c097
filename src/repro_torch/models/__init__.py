from repro_torch.models.model import build_model
from repro_torch.models.moe import MoEModel
from repro_torch.models.transformer import DenseModel

__all__ = ["DenseModel", "MoEModel", "build_model"]
