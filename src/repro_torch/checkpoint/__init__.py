from repro_torch.checkpoint.checkpoint import (latest_path, latest_step,
                                               load_packed_checkpoint,
                                               pack_params, save_checkpoint,
                                               save_packed_checkpoint)

__all__ = ["latest_path", "latest_step", "load_packed_checkpoint",
           "pack_params", "save_checkpoint", "save_packed_checkpoint"]
