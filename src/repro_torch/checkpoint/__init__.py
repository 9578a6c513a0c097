from repro_torch.checkpoint.checkpoint import (CheckpointManager, latest_path,
                                               latest_step,
                                               load_packed_checkpoint,
                                               pack_params, restore_checkpoint,
                                               save_checkpoint,
                                               save_packed_checkpoint)

__all__ = ["CheckpointManager", "latest_path", "latest_step",
           "load_packed_checkpoint", "pack_params", "restore_checkpoint",
           "save_checkpoint", "save_packed_checkpoint"]
