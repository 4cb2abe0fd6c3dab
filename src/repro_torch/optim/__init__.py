"""Optimizers, the flat layout, and the consensus-ADMM trainer."""
from repro_torch.optim.consensus import (ConsensusConfig, ConsensusTrainer,
                                         TrainState)

__all__ = ["ConsensusConfig", "ConsensusTrainer", "TrainState"]
