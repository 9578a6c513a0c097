from repro_torch.models.model import build_model
from repro_torch.models.transformer import DenseModel

__all__ = ["DenseModel", "build_model"]
