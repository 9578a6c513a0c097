from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             make_train_step)

__all__ = ["TrainConfig", "make_train_step", "init_train_state"]
