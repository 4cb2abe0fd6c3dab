"""Which ranks hold which ADMM nodes (``launch.mesh.init_ranks`` builds the
grid of a run).

Without sharding, rank r of R holds the contiguous block of nodes
``[r * J / R, (r + 1) * J / R)``. With the consensus state sharded in-pod
(``ConsensusConfig.shard_consensus``), a run has R = J * S ranks: rank r
holds node ``r // S`` (its pod) and slab ``r % S`` of that node's flat
rows, as the reference's in-pod devices each hold a slab of their pod's
node. Without it but with an in-pod mesh (the reference's default,
``shard_consensus`` off), the S ranks of a pod each hold the node's whole
flat rows, the same bits on each (``RankGrid.replicated``): no rank holds
a slab. Either way the J ranks with the same in-pod index, one a pod, form
the exchange group (``shard_group``).

With an in-pod mesh (``RankGrid.mesh``, the reference's ``data`` and
``model`` axes inside each pod), the S = data * model ranks of a pod also
form a ``data x model`` grid: rank r is pod ``r // S``, at ``((r % S) //
model, (r % S) % model)``, and holds its shards of the node's parameters
and moments (``distributed.fsdp``). ``trivial_grid(J, shards=S,
mesh=(data, model))`` is one process computing such a run whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Mesh, local_mesh


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """This process's place among the ranks of a run.

    ``group`` is None for the trivial grid (one process, no process group):
    then the trainer runs as a single process always has. With a group,
    the rows move by ``repro_torch.distributed``, even at one rank.

    ``shards`` S > 1 shards each node's flat consensus rows in-pod: the S
    ranks of a pod (``inpod_group``) hold the same node, its parameters and
    moments whole, and slab ``shard`` of its flat rows each; the J ranks
    that hold slab s (``shard_group``, in node order) exchange and gather
    per node. The trivial grid with S > 1 is one process computing an
    S-way sharded run whole: the sharded layout and wire, every slab.

    ``replicated``: the S ranks of a pod share its node without cutting
    its flat rows: each holds them whole, with the same bits as its
    in-pod twins (the reference's consensus state replicated in-pod under
    an in-pod mesh). Its ``shard`` is its in-pod index, and its
    ``shard_group`` (the ranks of the same index across the pods) the
    group it exchanges and gathers over.
    """

    world: int                      # ranks R
    rank: int                       # this rank, in [0, R)
    local_rank: int                 # this rank's index on its host
    nodes_per_rank: int             # J / R, or 1 with shards
    node_lo: int                    # first node of this rank
    node_hi: int                    # one past its last node
    device: torch.device
    backend: str = ""               # "" without a group
    group: Any = None               # the process group, or None
    shards: int = 1                 # S: ranks sharing a node's flat rows
    shard: int = 0                  # this rank's slab, in [0, S)
    inpod_group: Any = None         # the S ranks of this rank's node
    shard_group: Any = None         # the J ranks holding slab ``shard``
    mesh: Mesh | None = None        # the pod's data x model mesh, if any
    replicated: bool = False        # the S ranks hold the rows whole

    @property
    def pod(self) -> int:
        """This rank's node, with shards (its first node without)."""
        return self.node_lo

    @property
    def node_ranks(self) -> int:
        """Ranks that split the nodes among them: R, or R / S with shards
        (the shard group); 1 for the trivial grid with S > 1."""
        return max(self.world // self.shards, 1)

    @property
    def node_rank(self) -> int:
        """This rank's place among them."""
        return self.rank // self.shards

    @property
    def node_group(self):
        """The group the node exchange and gathers run over."""
        return self.shard_group if self.shards > 1 else self.group

    @property
    def num_nodes(self) -> int:
        return self.node_ranks * self.nodes_per_rank

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def holds_slab(self) -> bool:
        """This rank holds one slab of its node's flat rows (not all)."""
        return (self.shards > 1 and self.inpod_group is not None
                and not self.replicated)

    @property
    def staged(self) -> bool:
        """Rows cross ranks through host memory (gloo on a card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def close(self) -> None:
        """Destroy the process group, if there is one."""
        if self.group is not None:
            dist.destroy_process_group()


def trivial_grid(num_nodes: int, device: torch.device | str,
                 shards: int = 1, mesh: tuple[int, int] | None = None
                 ) -> RankGrid:
    """One process holding every node (and, with ``shards`` S > 1, every
    slab of the S-way sharded layout), no process group. ``mesh`` ``(data,
    model)`` (S = data * model) is the one-process counterpart of the
    pods' in-pod mesh: every node's parameters whole, each local step
    computed shard by shard (``local_mesh``); whether its flat rows are
    sharded (the S slabs) or replicated in-pod (whole) is the trainer's
    ``shard_consensus``."""
    dev = torch.device(device)
    pod_mesh = None
    if mesh is not None:
        data, model = (int(v) for v in mesh)
        if shards not in (1, data * model):
            raise ValueError(f"a data {data} x model {model} mesh has "
                             f"{data * model} shards, not {shards}")
        shards = data * model
        pod_mesh = local_mesh(data, model, dev)
    return RankGrid(world=1, rank=0, local_rank=0, nodes_per_rank=num_nodes,
                    node_lo=0, node_hi=num_nodes, device=dev,
                    shards=int(shards), mesh=pod_mesh)
