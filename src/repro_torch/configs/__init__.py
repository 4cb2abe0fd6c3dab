"""Architecture configs of the ported slices."""
from repro_torch.configs.base import (ARCH_IDS, PORTED_ARCH_IDS, ArchConfig,
                                      MoEConfig, get_config,
                                      get_reduced_config)

__all__ = ["ARCH_IDS", "PORTED_ARCH_IDS", "ArchConfig", "MoEConfig",
           "get_config", "get_reduced_config"]
