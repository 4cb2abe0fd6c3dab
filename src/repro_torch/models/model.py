"""Public model API (port of ``repro/models/model.py``, training path)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import torch_dtype
from repro_torch.models import params as plib
from repro_torch.models import transformer as tf


@dataclasses.dataclass(frozen=True, eq=False)
class Model:
    cfg: ArchConfig
    dtype: torch.dtype

    def param_defs(self) -> dict:
        return tf.stacked_defs(self.cfg, self.dtype)

    def init(self, gen: torch.Generator, device: torch.device | str) -> dict:
        return plib.materialize(gen, self.param_defs(), device)

    def param_count(self) -> int:
        return plib.count(self.param_defs())

    def loss(self, params: dict, batch: dict):
        return tf.loss_fn(self.cfg, params, batch)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg, dtype=torch_dtype(cfg.dtype))
