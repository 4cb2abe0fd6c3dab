"""Ranks of a consensus run: which process holds which ADMM nodes (the role
of ``repro/launch/mesh.py``, without its XLA flags).

The reference lays the nodes on the ``pod`` axis of a device mesh and lets
GSPMD place them. The port runs R processes under ``torch.distributed``,
started by ``torchrun`` (``python -m torch.distributed.run``), and gives
each a contiguous block of ``J / R`` nodes: rank r holds nodes
``[r * J / R, (r + 1) * J / R)``.

With ``shard_consensus`` (the reference's ``--shard-consensus``: the flat
consensus state sharded over the in-pod devices of each node's pod) a run
has R = J * S ranks: rank r holds node ``r // S`` and slab ``r % S`` of
its flat rows (``RankGrid.shards``, ``shard``, the in-pod and the shard
process groups). S = 1 is the grid without sharding.

``init_ranks`` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), or
explicit arguments (the tests pass a ``file://`` store). The backend
follows the device: ``nccl`` for ``cuda``, ``gloo`` for ``cpu``. Ranks that
share one card run only when asked for, with ``gloo`` on ``cuda``: the
exchange then stages its rows through host memory. NCCL does not run two
ranks on one device, so that combination raises before any NCCL call, and
nothing picks another backend or device on its own.

With ``mesh=(data, model)`` (the reference's ``--mesh``: the in-pod
axes), the S = data * model ranks of each pod form a ``data x model``
mesh (``RankGrid.mesh``): rank r is pod ``r // S`` at ``((r % S) //
model, (r % S) % model)``, with the process groups of its pod's data and
model axes, and holds its shards of the node's parameters and moments.
With ``shard_consensus`` as well each also holds slab ``r % S`` of the
node's flat rows; without it (the reference's default) each holds them
whole (``RankGrid.replicated``).

``init_mesh`` does the same for a plain ``data x model`` mesh
(``distributed.sharding.Mesh``: expert-parallel serving and
``launch.steps.make_train_fns``).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.exchange import HostStaging
from repro_torch.distributed.grid import RankGrid, trivial_grid
from repro_torch.distributed.sharding import Mesh, local_mesh

BACKENDS = ("nccl", "gloo")


def check_backend(backend: str, device_type: str, local_world: int,
                  cards: int) -> None:
    """Raise for a backend the device cannot run: ``nccl`` off a card, or
    more ranks on this host than it has cards. Runs before any NCCL call."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; known: {BACKENDS}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError(f"the nccl backend needs device cuda, not "
                         f"{device_type!r} (use --dist-backend gloo on the "
                         "CPU)")
    if backend == "nccl" and local_world > cards:
        raise ValueError(
            f"the nccl backend needs one card a rank: {local_world} ranks "
            f"on this host, {cards} card(s); ranks that share a card run "
            "with --dist-backend gloo (rows staged through host memory)")
    if backend == "gloo" and device_type not in ("cpu", "cuda"):
        raise ValueError(f"no gloo path for device {device_type!r}")


def _world_size(world_size: int | None) -> int:
    """The world size from the argument or else torchrun's environment."""
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", "1"))
    if world < 1:
        raise ValueError(f"world size {world}")
    return world


def _join_world(world: int, device: str | torch.device, backend, init_method,
                world_size, rank, local_rank):
    """Join the process group of ``world`` ranks (shared by ``init_ranks``
    and ``init_mesh``): returns this process's ``(rank, local_rank,
    device, backend)``. The rank and local rank come from the arguments
    or else torchrun's environment; ``backend`` None follows the device;
    the backend is checked before any NCCL call; a rank on a card runs on
    ``cuda:{local_rank % cards}``. A process group already up over the
    same ranks (an earlier grid's, left open) is reused: the new grid's
    subgroups are made on it."""
    env = os.environ
    rank = int(rank if rank is not None else env.get("RANK", "0"))
    local_rank = int(local_rank if local_rank is not None
                     else env.get("LOCAL_RANK", str(rank)))
    local_world = world if world_size is not None \
        else int(env.get("LOCAL_WORLD_SIZE", str(world)))
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    check_backend(backend, dev.type, local_world, cards)
    if dev.type == "cuda":
        dev = resolve_device(f"cuda:{local_rank % max(cards, 1)}")
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(dev)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank(), dist.get_backend()) \
                != (world, rank, backend):
            raise ValueError(
                f"a process group of {dist.get_world_size()} ranks "
                f"({dist.get_backend()}) is up; this grid wants {world} "
                f"({backend})")
        return rank, local_rank, dev, backend
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank)
    return rank, local_rank, dev, backend


def _grid_groups(rows: int, cols: int, base: int = 0
                 ) -> tuple[list, list]:
    """The process groups of a ``rows x cols`` grid of ranks (rank ``base
    + r * cols + c`` at ``(r, c)``): each row's, then each column's. Every
    rank makes every group, in the same order."""
    row_groups = [dist.new_group([base + r * cols + c for c in range(cols)])
                  for r in range(rows)]
    col_groups = [dist.new_group([base + r * cols + c for r in range(rows)])
                  for c in range(cols)]
    return row_groups, col_groups


def init_ranks(num_nodes: int, device: str | torch.device, *,
               backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               local_rank: int | None = None, shard_consensus: bool = False,
               mesh: tuple[int, int] | None = None) -> RankGrid:
    """This process's ``RankGrid`` for ``num_nodes`` ADMM nodes.

    The world size, rank and local rank come from the arguments or else
    from torchrun's environment. With a world of one and no ``backend``
    asked for, no process group is made and the trivial grid returns. An
    explicit ``backend`` asks for a group even at one rank. ``backend``
    None follows the device (``nccl`` for ``cuda``, ``gloo`` for ``cpu``).
    Under NCCL the rank's device is ``cuda:{local_rank}``; under gloo on a
    card, ``cuda:{local_rank % cards}``.

    ``shard_consensus`` with R > 1 ranks needs R a multiple of J and gives
    each node S = R / J ranks. (One process computes an S-way sharded run
    whole on ``trivial_grid(J, device, shards=S)``.) Every round path runs
    on every grid: sync, dynamic and async rounds, pipelined or not.

    ``mesh`` ``(data, model)``: the pods' in-pod mesh, S = data * model,
    on a world of J * S ranks, or one process, which computes the run
    whole on ``trivial_grid(J, mesh=)``. Without ``shard_consensus`` the
    S ranks of a pod hold its flat rows whole (``RankGrid.replicated``).
    S > 1 ranks a node with neither a mesh nor ``shard_consensus`` is
    refused: the reference has no such grid.
    """
    world = _world_size(world_size)
    if mesh is not None:
        data, model = (int(v) for v in mesh)
        if world > 1 and world != num_nodes * data * model:
            raise ValueError(
                f"a data {data} x model {model} in-pod mesh over "
                f"{num_nodes} nodes needs {num_nodes * data * model} ranks, "
                f"not {world}")
        if world == 1 and backend is None:
            return trivial_grid(num_nodes,
                                resolve_device(torch.device(device)),
                                mesh=(data, model))
    n_shards = 1
    if (shard_consensus or mesh is not None) and world > 1:
        if world % num_nodes:
            raise ValueError(
                f"--shard-consensus: the world size {world} is not a "
                f"multiple of --nodes {num_nodes}: each node's S = R / J "
                "ranks hold a slab of its flat rows each")
        n_shards = world // num_nodes
    elif num_nodes % world:
        raise ValueError(f"--nodes {num_nodes} is not a multiple of the "
                         f"world size {world}: every rank holds J / R nodes")
    if world == 1 and backend is None:
        return trivial_grid(num_nodes, resolve_device(torch.device(device)))
    rank, local_rank, dev, backend = _join_world(
        world, device, backend, init_method, world_size, rank, local_rank)
    if n_shards > 1:
        pods, slabs = _grid_groups(num_nodes, n_shards)
        pod, shard = divmod(rank, n_shards)
        pod_mesh = None
        if mesh is not None:
            # every rank makes every pod's axis groups, in pod order
            axes = [_grid_groups(data, model, base=p * n_shards)
                    for p in range(num_nodes)]
            model_groups, data_groups = axes[pod]
            d, m = divmod(shard, model)
            staged = backend == "gloo" and dev.type == "cuda"
            pod_mesh = Mesh(data=data, model=model, device=dev, coords=(d, m),
                            backend=backend, data_group=data_groups[m],
                            model_group=model_groups[d],
                            staging=HostStaging() if staged else None,
                            group=pods[pod])
        return RankGrid(world=world, rank=rank, local_rank=local_rank,
                        nodes_per_rank=1, node_lo=pod, node_hi=pod + 1,
                        device=dev, backend=backend, group=dist.group.WORLD,
                        shards=n_shards, shard=shard,
                        inpod_group=pods[pod], shard_group=slabs[shard],
                        mesh=pod_mesh, replicated=not shard_consensus)
    per = num_nodes // world
    return RankGrid(world=world, rank=rank, local_rank=local_rank,
                    nodes_per_rank=per, node_lo=rank * per,
                    node_hi=(rank + 1) * per, device=dev, backend=backend,
                    group=dist.group.WORLD)


def init_mesh(data: int, model: int, device: str | torch.device, *,
              backend: str | None = None, init_method: str | None = None,
              world_size: int | None = None, rank: int | None = None,
              local_rank: int | None = None, stats=None) -> Mesh:
    """This process's ``Mesh`` in a ``data x model`` grid of ranks (the
    expert-parallel paths' counterpart of ``init_ranks``).

    The world size, rank and local rank come from the arguments or else
    from torchrun's environment, and the world must hold ``data * model``
    ranks: rank r sits at ``(r // model, r % model)``. With a world of one
    and no ``backend`` asked for, no process group is made and the
    one-process mesh returns (``local_mesh``: every shard computed in
    this process). ``backend`` None follows the device. Under NCCL the
    rank's device is ``cuda:{local_rank}``; under gloo on a card,
    ``cuda:{local_rank % cards}``, with the exchanges staged through
    pinned host buffers. NCCL with more ranks on this host than cards
    raises before any NCCL call. ``stats`` (an ``MeshStats``) collects what
    the expert-parallel paths report.
    """
    world = _world_size(world_size)
    if world == 1 and backend is None:
        return local_mesh(data, model, resolve_device(torch.device(device)),
                          stats=stats)
    if world != data * model:
        raise ValueError(f"a data {data} x model {model} mesh needs "
                         f"{data * model} ranks, not {world}")
    rank, local_rank, dev, backend = _join_world(
        world, device, backend, init_method, world_size, rank, local_rank)
    model_groups, data_groups = _grid_groups(data, model)
    d, m = divmod(rank, model)
    staged = backend == "gloo" and dev.type == "cuda"
    return Mesh(data=data, model=model, device=dev, coords=(d, m),
                backend=backend, data_group=data_groups[m],
                model_group=model_groups[d],
                staging=HostStaging() if staged else None, stats=stats,
                group=dist.group.WORLD)
