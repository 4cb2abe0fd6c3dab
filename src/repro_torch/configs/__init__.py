"""Architecture configs: the reference's ten."""
from repro_torch.configs.base import (ARCH_IDS, ArchConfig, MoEConfig,
                                      ShapeCell, get_config,
                                      get_reduced_config)

__all__ = ["ARCH_IDS", "ArchConfig", "MoEConfig", "ShapeCell",
           "get_config", "get_reduced_config"]
