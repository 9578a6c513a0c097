from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                      shapes_for, get_config,
                                      get_tiny_config, list_archs)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shapes_for", "get_config",
           "get_tiny_config", "list_archs"]
