"""Which ranks hold which ADMM nodes: rank r of R holds the contiguous
block of nodes ``[r * J / R, (r + 1) * J / R)`` (``launch.mesh.init_ranks``
builds the grid of a run)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """This process's place among the ranks of a run.

    ``group`` is None for the trivial grid (one process, no process group):
    then the trainer runs as a single process always has. With a group,
    the rows move by ``repro_torch.distributed``, even at one rank.
    """

    world: int                      # ranks R
    rank: int                       # this rank, in [0, R)
    local_rank: int                 # this rank's index on its host
    nodes_per_rank: int             # J / R
    node_lo: int                    # first node of this rank
    node_hi: int                    # one past its last node
    device: torch.device
    backend: str = ""               # "" without a group
    group: Any = None               # the process group, or None

    @property
    def num_nodes(self) -> int:
        return self.world * self.nodes_per_rank

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def staged(self) -> bool:
        """Rows cross ranks through host memory (gloo on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def close(self) -> None:
        """Destroy the process group, if there is one."""
        if self.group is not None:
            dist.destroy_process_group()


def trivial_grid(num_nodes: int, device: torch.device | str) -> RankGrid:
    """One process holding every node, no process group."""
    return RankGrid(world=1, rank=0, local_rank=0, nodes_per_rank=num_nodes,
                    node_lo=0, node_hi=num_nodes, device=torch.device(device))
