"""Public model API (port of ``repro/models/model.py``): init, loss,
prefill and decode."""
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

    def prefill(self, params: dict, batch: dict,
                use_kernel: bool = False) -> torch.Tensor:
        """Full-sequence logits of ``batch["tokens"]`` [B, S]; with
        ``use_kernel`` the attention or time-mix runs its kernel (see
        ``transformer.forward``)."""
        return tf.forward(self.cfg, params, tokens=batch["tokens"],
                          use_kernel=use_kernel)

    def init_decode_state(self, batch: int, max_len: int,
                          device: torch.device | str) -> tf.DecodeState:
        return tf.init_decode_state(self.cfg, batch, max_len, device)

    def decode_step(self, params: dict, state: tf.DecodeState,
                    token: torch.Tensor, *, max_len: int):
        return tf.decode_step(self.cfg, params, state, token,
                              max_len=max_len)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg, dtype=torch_dtype(cfg.dtype))
