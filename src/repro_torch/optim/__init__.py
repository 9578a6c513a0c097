from repro_torch.optim.optimizers import (OptimizerConfig, adafactor_init,
                                          adafactor_update, adamw_init,
                                          adamw_update, lr_schedule,
                                          make_optimizer)

__all__ = ["OptimizerConfig", "make_optimizer", "adamw_init", "adamw_update",
           "adafactor_init", "adafactor_update", "lr_schedule"]
