from repro_torch.models.mamba import MambaModel
from repro_torch.models.mamba2 import Zamba2Model
from repro_torch.models.model import batch_specs, build_model, make_batch
from repro_torch.models.moe import MoEModel
from repro_torch.models.transformer import DenseModel

__all__ = ["DenseModel", "MambaModel", "MoEModel", "Zamba2Model",
           "batch_specs", "build_model", "make_batch"]
