"""AdamW, non-factored (port of ``repro/optim/adamw.py``).

The arithmetic follows the reference term for term: a global-norm clip over
every leaf, f32 moments and f32 bias corrections, decoupled weight decay.
``update`` works IN PLACE on the parameters and moments it is given (the
PyTorch habit; it keeps the f32 temporaries to one leaf at a time), and
returns them. On an in-pod mesh they are a rank's shards
(``distributed.fsdp``): the update is elementwise, and the clip reads the
global norm of the node's whole gradient (``global_norm`` with ``mesh``
and ``specs``: every rank's sum of squares added over the pod, each
element counted once), so that every rank clips alike.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor      # [] int32
    m: Any                  # tree of f32 first moments
    v: Any                  # tree of f32 second moments


def init(cfg: AdamWConfig, params: Any) -> AdamWState:
    del cfg
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_lib.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_lib.tree_map(zeros, params),
                      v=tree_lib.tree_map(zeros, params))


def global_norm(tree: Any, mesh=None, specs: Any = None) -> torch.Tensor:
    """The norm over every leaf; with an in-pod ``mesh``, of the node's
    gradient whose shards (or, on the one-process mesh, whole leaves)
    ``tree`` holds (``distributed.fsdp.grad_norm``)."""
    if mesh is not None:
        from repro_torch.distributed.fsdp import grad_norm
        return grad_norm(tree, specs, mesh)
    return torch.sqrt(sum(x.to(torch.float32).square().sum()
                          for x in tree_lib.leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, state: AdamWState, params: Any, grads: Any,
           lr_scale: float = 1.0, mesh=None, specs: Any = None
           ) -> tuple[Any, AdamWState, dict]:
    """One AdamW step; params, state.m and state.v are updated in place
    (with ``mesh``, a rank's shards under ``specs``, see above)."""
    step = state.step + 1
    f32 = torch.float32
    gnorm = global_norm(grads, mesh, specs)
    if cfg.grad_clip > 0:
        clip = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    else:
        clip = torch.ones((), dtype=f32, device=gnorm.device)
    stepf = step.to(f32)
    bc1 = 1.0 - torch.tensor(cfg.b1, dtype=f32, device=stepf.device) ** stepf
    bc2 = 1.0 - torch.tensor(cfg.b2, dtype=f32, device=stepf.device) ** stepf
    lr = cfg.lr * lr_scale

    for p, g, m, v in zip(tree_lib.leaves(params), tree_lib.leaves(grads),
                          tree_lib.leaves(state.m), tree_lib.leaves(state.v),
                          strict=True):
        g = g.to(f32) * clip
        # m' = b1 m + (1 - b1) g ;  v' = b2 v + ((1 - b2) g) g
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_(((1 - cfg.b2) * g).mul_(g))
        del g
        # upd = (m' / bc1) / (sqrt(v' / bc2) + eps)
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        p32 = p.to(f32)
        # p' = p - lr (upd + wd p)
        upd.add_(cfg.weight_decay * p32)
        p.copy_(p32.sub_(upd.mul_(lr)))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
