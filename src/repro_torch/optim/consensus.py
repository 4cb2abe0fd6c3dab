"""Consensus-ADMM training: the synchronous trainer, on a static or a
dynamic topology (port of ``repro/optim/consensus.py:ConsensusTrainer``).

Every node i of the ADMM graph holds its own parameter replica theta_i.
Between consensus rounds each node takes H local AdamW steps on its own
data (f_i = its local loss). A consensus round then

  1. packs the replicas into one flat ``[J, total]`` buffer and encodes it
     with the wire codec (native, int8 or fp8, ``repro_torch.wire``),
  2. exchanges it: one circulant shift of the node axis per graph offset,
  3. probes f_i(theta_j) on a held-out batch (eq. 7 kappas),
  4. runs ONE fused kernel call (``kernels.ops.consensus_round``): dequant,
     both neighbor means, the prox pull, the dual update and the eq. 5
     residual partials,
  5. updates the per-edge penalties with the paper's schemes
     (``repro_torch.core.penalty``).

The graph must be circulant (ring, complete, expander): its edges are the
offsets of node 0 applied to every node. The nodes run on R ranks
(``distributed.RankGrid``, one process each under ``torch.distributed``),
each holding a contiguous block of J / R node rows of the parameters, the
moments, the duals and the neighbour means; R = 1 (no process group) holds
all J on one device. The exchange is ``distributed.circulant_into`` per
graph offset: local row copies, and point-to-point transfers for rows of
other ranks. The penalties, the topology state, the step and the obs rings
stay replicated ``[J, ...]`` on every rank and are updated identically,
from per-node values all-gathered in node order (the probes, the
residuals' per-row partials, the local losses and grad norms), so that
every rank computes them from the same bits as one process would.

In-pod mesh (``RankGrid.mesh``, the reference's ``data`` and ``model``
axes inside each pod, ``launch.mesh.init_ranks(mesh=)``): the S = data *
model ranks of a node's pod hold only their shards of its parameters and
moments (``distributed.fsdp``, by the arch rules), and run its local step
and its probes under the pod's mesh with ``batch -> data``: rank ``(d,
m)`` on data index d's rows, the MoE's experts parallel over ``model``
with the reference's capacity and drops, the gradients reduce-scattered
onto the shards and the clip reading the pod's norm. A round packs the
node's whole flat row from its leaves gathered in-pod (a transient),
encodes its slab as below, and after the kernel each rank keeps only its
shards of the new parameters.

Replicated in-pod state (an in-pod mesh without ``shard_consensus``, the
reference's default, ``RankGrid.replicated``): each of the S ranks of a
pod holds its shards of the node's parameters and moments, as above, and
the node's whole flat rows (``lam`` and ``theta_bar_prev`` ``[1, total]``,
with ``async_exec`` the whole ledger rows ``[deg, 1, W]``), the same bits
as its in-pod twins, as the reference's GSPMD keeps rows sharded over
``pod`` only. A round packs the node's whole row from its leaves gathered
in-pod and encodes it whole, exchanges it with the rank of the same
in-pod coordinates in the neighbour pod (the shard group), probes the
received row under the pod's mesh with no in-pod gather of the payload,
makes the same kernel launch on the whole row as its twins, takes the
residuals from that row's partials with no in-pod sum, and keeps its
shards of the new parameters. Every replicated value is computed from
the same bits in the same order on each in-pod rank.

Sharded consensus state (``ConsensusConfig.shard_consensus``, a grid of
R = J * S ranks, ``RankGrid.shards``): the S ranks of a node's pod hold its
parameters and moments whole and step them alike, and each holds slab s
of the node's flat rows (``flatten.ShardedLayout``): ``lam`` and
``theta_bar_prev`` are ``[1, shard_total]``. A round packs the whole row,
encodes and exchanges slab s's message over the J ranks holding slab s,
all-gathers each live offset's received slabs in-pod into the whole
payload for the probe, runs the kernel on the slab with its block->leaf
table, and all-gathers in-pod the kernel's block partials (then summed as
one process sums them) and the new parameters' slabs. The residuals and
every replicated state then carry one process's bits.

Dynamic topology (``ConsensusConfig.dyn_topology``, ``repro_torch.topology``):
the round exchanges over the runtime's offset superset (graph offsets plus
churn spares), gates every edge by the state's mask — a gated edge gets
zero weight in the kernel's edge-gated round and the neighbor mean divides
by the active degree — absorbs the final force of newly gated edges into
the dual one round later (zero-kick), and skips the roll and the probe of
an offset with no active edge and no pending kick. A lost node becomes a
ghost row (``apply_churn``): every buffer keeps its shape. The default
``TopologyConfig()`` (static, no churn) keeps the ungated round.

Bounded-staleness async rounds (``ConsensusConfig.async_exec``,
``consensus_step_async``, driven by ``repro_torch.async_exec``): each
directed edge consumes the freshest payload that has landed, falling back
to the wire ledger's held row; an edge older than ``max_staleness`` rounds
is gated, with its last force absorbed into the dual; the penalties are
damped by age; nodes still computing keep their rows. The async round
always runs the edge-gated kernel. Each rank holds the ledger rows of its
own nodes (or its slab's message of its node) and merges the landed
payloads into them by the same exchange as the synchronous round.

The round pipeline (``ConsensusConfig.pipeline_offsets``, the depth):
both rounds issue up to ``depth`` offsets' exchanges
(``distributed.circulant_start``) ahead of the point where an offset's
payload is decoded and probed, and issue the next one after each probe.
Depth 1 is the sequential issue-wait-probe loop. Every value is the same
at every depth: only the time at which a transfer starts changes.

Observability (``ConsensusConfig.obs``, ``repro_torch.obs``): every round
path returns through ``_finish_round``, which unifies its metrics to
``obs.schema.ROUND_METRICS`` and, with obs on, appends one row to the
device metrics ring and one ``[J, n_cols]`` slab to the node ring in
place, with no host sync; ``record_function`` spans mark the round's
phases. With obs off the round runs the same launches as without it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch import wire as wire_lib
from repro_torch.async_exec.ledger import (AsyncConfig, WireLedger,
                                           init_wire_ledger)
from repro_torch.core.graph import Graph, build_graph
from repro_torch.core.penalty import (PenaltyConfig, PenaltyState,
                                      effective_eta, freeze_penalty,
                                      init_penalty_state, update_penalty)
from repro_torch.distributed import (HostStaging, RankGrid, circulant_start,
                                     gather_nodes, gather_pod, trivial_grid)
from repro_torch.distributed import fsdp, local_mesh
from repro_torch.kernels import ops as kops
from repro_torch.models.model import Model
from repro_torch.obs import node_ring as obs_node_ring
from repro_torch.obs import ring as obs_ring
from repro_torch.obs import schema as obs_schema
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.ring import ObsConfig
from repro_torch.optim import adamw as adamw_lib
from repro_torch.optim import flatten
from repro_torch.topology import (TopologyConfig, TopologyRuntime,
                                  TopologyState, active_edge_fraction,
                                  compose_mask, sym_age, tick_age)


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """The fields of the reference's ``ConsensusConfig`` that the port
    reads (same names and defaults). The round
    always goes through ``kops.consensus_round``, whose tensors' device picks
    the kernel or the plain version, and the flat layout's block size is
    always the reference's automatic one."""

    penalty: PenaltyConfig = PenaltyConfig(scheme="nap", eta0=1.0)
    topology: str = "ring"         # circulant: ring | complete | expander
    local_steps: int = 8           # H — local optimizer steps per round
    prox_step: float = 0.5         # alpha in the prox pull
    compression: str = "none"      # legacy spelling: none | int8
    wire_codec: str = ""           # native | int8 | fp8_e4m3 | fp8_e5m2;
    #                                empty => from compression
    # the default static scheduler without churn keeps the ungated round
    dyn_topology: TopologyConfig = TopologyConfig()
    # bounded-staleness async executor: None keeps the trainer synchronous;
    # max_staleness=0 makes consensus_step_async the synchronous round
    async_exec: AsyncConfig | None = None
    # observability: the device metrics rings and the round's spans. None
    # (or ObsConfig(enabled=False)) leaves the round as it is without them
    obs: ObsConfig | None = None
    # shard the flat consensus state (lam, theta_bar_prev, the wire) over
    # the S in-pod ranks of each node (RankGrid.shards); off, or S = 1,
    # keeps the unsharded round
    shard_consensus: bool = False
    # the round pipeline: how many offsets' exchanges may be in flight
    # ahead of the decode/probe consume point. 1 is the sequential loop;
    # the values, the ledger's included, are the same at every depth. The
    # reference's pipelined synchronous round also writes its received
    # rows, round + 1 and w_prev into a wire ledger, for a bounded-
    # staleness round interleaved with it. Nothing in the port reads that:
    # an async trainer takes this round only at max_staleness 0, and then
    # every round, so the ledger is never decoded. The port builds the
    # ledger only with async_exec and leaves it untouched here
    pipeline_offsets: int = 1
    # the reference's switch to reduce-scatter the gradients onto the
    # parameter shards. Under an in-pod mesh (RankGrid.mesh) the port's
    # gradients always land reduce-scattered on the shards, whatever it
    # says; without one there is nothing to scatter
    grad_rs: bool = False


class TrainState(NamedTuple):
    # per-rank rows: this rank's J / R nodes (all J at one rank)
    params: Any                    # tree of [J/R, ...] per-node replicas
    opt: adamw_lib.AdamWState      # moments [J/R, ...] f32, one shared step
    lam: torch.Tensor              # [J/R, total] f32 flat duals (a slab
    #                                rank's [1, shard_total]; a replicated
    #                                in-pod rank's whole [1, total])
    theta_bar_prev: torch.Tensor   # [J/R, total] f32 neighbor means (eq. 5)
    # replicated on every rank
    penalty: PenaltyState          # [J, J]
    step: torch.Tensor             # [] int32
    topo: TopologyState            # [J, J] dynamic-topology state
    ledger: Any = None             # WireLedger [deg, J/R, W] — async
    #                                only (a slab rank's [deg, 1, shard W])
    ring: Any = None               # obs.MetricsRing [cap, n_metrics]
    node_ring: Any = None          # obs.NodeRing [cap, J, n_node_cols]


# the TrainState fields replicated on every rank (a checkpoint's rank 0
# writes them once); every other leaf is a rank's own rows, slab or shards
REPLICATED_FIELDS = (("opt", "step"), ("penalty",), ("step",), ("topo",),
                     ("ledger", "round"), ("ledger", "w_prev"), ("ring",),
                     ("node_ring",))


def replicated_leaf(path: tuple[str, ...]) -> bool:
    """Whether the TrainState leaf at ``path`` is the same on every rank."""
    return any(tuple(path[:len(f)]) == f for f in REPLICATED_FIELDS)


class _Window:
    """Exchanges issued in ``order`` (offset indices, ascending), at most
    ``depth`` in flight ahead of their consumer, which takes them in the
    same order: ``wait(d)`` completes offset d's, ``fill()`` issues more.
    The k-th issue gets staging slot ``k % depth``, whose previous user,
    the issue ``depth`` before, has been waited on by then."""

    def __init__(self, order, depth: int, start):
        self._order = list(order)
        self._depth = depth
        self._start = start                 # (d, slot) -> Pending
        self._next = 0
        self._pending = {}
        self.fill()

    def fill(self) -> None:
        while (self._next < len(self._order)
               and len(self._pending) < self._depth):
            d = self._order[self._next]
            self._pending[d] = self._start(d, self._next % self._depth)
            self._next += 1
        if self._next == len(self._order):
            self._start = None      # all issued: let go of the wire

    def wait(self, d: int) -> None:
        self._pending.pop(d).wait()

    @property
    def in_flight(self) -> int:
        """Exchanges not yet issued or not yet waited on."""
        return len(self._order) - self._next + len(self._pending)


class ConsensusTrainer:
    """Local steps and consensus rounds for a model over J nodes, this
    rank's block of J / R of them held on ``device`` (all J without
    ``ranks``)."""

    def __init__(self, model: Model, *, num_nodes: int,
                 device: torch.device | str,
                 adamw: adamw_lib.AdamWConfig, consensus: ConsensusConfig,
                 ranks: RankGrid | None = None):
        self.model = model
        self.device = torch.device(device)
        self.acfg = adamw
        self.ccfg = consensus
        self.num_nodes = int(num_nodes)
        self.ranks = ranks or trivial_grid(self.num_nodes, self.device)
        if self.ranks.num_nodes != self.num_nodes:
            raise ValueError(f"the rank grid holds {self.ranks.num_nodes} "
                             f"nodes, the trainer {self.num_nodes}")
        if self.ranks.distributed and self.ranks.device != self.device:
            raise ValueError(f"rank {self.ranks.rank} runs on "
                             f"{self.ranks.device}, not {self.device}")
        n_shards = self.ranks.shards
        if n_shards > 1 and not consensus.shard_consensus \
                and self.ranks.mesh is None:
            raise ValueError(f"the rank grid shares each node among "
                             f"{n_shards} ranks with no in-pod mesh; set "
                             "ConsensusConfig.shard_consensus")
        if self.ranks.distributed and n_shards > 1 \
                and self.ranks.replicated == consensus.shard_consensus:
            raise ValueError(
                f"the rank grid holds each node's flat rows "
                f"{'whole' if self.ranks.replicated else 'in slabs'}, the "
                f"trainer's shard_consensus is {consensus.shard_consensus}")
        self.sharded = (consensus.shard_consensus and self.num_nodes > 1
                        and n_shards > 1)
        # the pods' in-pod mesh: each rank holds its shards of its node's
        # parameters and moments (the whole trees on the one-process mesh);
        # without one, each node's local step runs on a 1 x 1 mesh
        self.mesh = self.ranks.mesh
        if self.mesh is None:
            self.mesh = local_mesh(1, 1, self.device)
        elif self.mesh.size != n_shards:
            raise ValueError(f"the in-pod mesh has {self.mesh.size} ranks, "
                             f"the grid {n_shards} shards")
        self.specs, self.gather_specs = fsdp.specs_for(model, self.mesh)
        # a rank of a mesh holds shards (the one-process mesh whole trees)
        self.param_shards = not self.mesh.local
        # this rank's node rows
        self.n_local = self.ranks.nodes_per_rank
        self.pipeline_depth = max(1, int(consensus.pipeline_offsets))
        self.pipelined = self.pipeline_depth > 1 and self.num_nodes > 1
        # gloo on a card: pinned host pairs, one for the in-pod gathers and
        # one for each exchange in flight (at depth 1 the same pair: the
        # gathers run between exchanges)
        staged = self.ranks.staged
        self._staging = HostStaging() if staged else None
        self._xstaging = [None] * self.pipeline_depth
        if staged:
            self._xstaging = [self._staging] if self.pipeline_depth == 1 \
                else [HostStaging() for _ in range(self.pipeline_depth)]
        self.graph: Graph = build_graph(consensus.topology, self.num_nodes) \
            if self.num_nodes > 1 else build_graph("complete", 1)
        self._check_circulant()
        self.topo_cfg = consensus.dyn_topology
        self.topo_cfg.validate_penalty(consensus.penalty)
        self.async_cfg = consensus.async_exec
        # offsets come from the runtime's superset: the graph's circulant
        # offsets, plus spare offsets for churn repair
        self.topo_rt = TopologyRuntime(self.graph, self.topo_cfg)
        self.dynamic = self.topo_cfg.is_dynamic and self.num_nodes > 1
        self.offsets = self.topo_rt.offsets if self.num_nodes > 1 else []
        defs = model.param_defs()
        self.n_shards = n_shards if self.sharded else 1
        self.layout = flatten.FlatLayout.for_tree(
            defs, block_size=flatten.auto_block_size(defs), node_axis=False,
            shards=self.n_shards)
        self.slayout = self.layout.shard(self.n_shards) if self.sharded \
            else None
        self.codec_name = wire_lib.resolve_codec_name(
            consensus.wire_codec or consensus.compression)
        self.codec = wire_lib.get_codec(self.codec_name, self.layout,
                                        self.slayout)
        # per-leaf scales (native, int8) or per-block ones (fp8)
        self.dequant_spec = self.codec.kernel_dequant_spec()
        # the columns of the flat rows this rank holds: one slab, or all
        self.slab = self.sharded and self.ranks.holds_slab
        if self.slab:
            self.cols = self.slayout.columns(self.ranks.shard)
            table = self.slayout.block_leaf_shards[self.ranks.shard]
        else:
            self.cols = slice(0, self.layout.total)
            table = self.layout.block_leaf
        # the kernel indexes per-leaf scale rows by these ids unchecked, so
        # the table is checked here, once, against the layout's leaves
        if table.size and not (0 <= table.min()
                               and table.max() < self.layout.num_leaves):
            raise ValueError(f"block->leaf ids span [{table.min()}, "
                             f"{table.max()}], the layout has "
                             f"{self.layout.num_leaves} leaves")
        self.block_leaf = torch.as_tensor(table, dtype=torch.int32,
                                          device=self.device)
        self._adj = torch.as_tensor(self.graph.adj, device=self.device)
        self.obs_cfg = consensus.obs
        self.obs_on = self.obs_cfg is not None and self.obs_cfg.enabled
        self.node_ring_on = self.obs_on and self.obs_cfg.with_node_ring
        self._span = obs_trace.span_factory(
            self.obs_on and self.obs_cfg.with_spans)
        # the [J, J] pairs the offsets move payloads between: the async
        # node ring counts arrivals from it without a host copy per round
        self._covered = None
        if self.node_ring_on:
            covered = np.zeros((self.num_nodes, self.num_nodes), dtype=bool)
            for off in self.offsets:
                covered |= np.roll(np.eye(self.num_nodes, dtype=bool), off,
                                   axis=1)
            self._covered = torch.as_tensor(covered, device=self.device)

    def grid_spec(self) -> dict:
        """What this trainer's state is laid out by, as a checkpoint
        records it: the nodes J, the ranks R, the ranks S a node, the
        in-pod mesh, whether the flat rows are cut into slabs, the wire
        codec, the flat row's length and the arch."""
        mesh = self.ranks.mesh
        return {"nodes": self.num_nodes, "ranks": self.ranks.world,
                "shards": self.ranks.shards,
                "mesh": None if mesh is None else [mesh.data, mesh.model],
                "shard_consensus": bool(self.sharded),
                "codec": self.codec_name, "total": int(self.layout.total),
                "arch": self.model.cfg.arch_id}

    def _check_circulant(self):
        j = self.num_nodes
        u = np.zeros((j, j), dtype=bool)
        for off in self.graph.neighbor_offsets_ring():
            u[np.arange(j), (np.arange(j) + off) % j] = True
        if not np.array_equal(u, self.graph.adj):
            raise ValueError(
                f"topology {self.ccfg.topology!r} at J={j} is not circulant; "
                "the single-device engine rolls by node 0's offsets")

    # ------------------------------------------------------------ state ----
    def init_state(self, params1: dict) -> TrainState:
        """State with ``params1`` (one node's whole parameters) on every
        node; the per-node rows are this rank's (on a rank of an in-pod
        mesh, its shards)."""
        j, rows = self.num_nodes, self.n_local
        if self.param_shards:
            params1 = fsdp.cut(params1, self.specs, self.mesh,
                               self.mesh.coords)
        params = tree_lib.tree_map(
            lambda x: x.to(self.device)[None].expand(rows, *x.shape).clone(),
            params1)
        flat_shape = (rows, self.cols.stop - self.cols.start)
        ledger = None
        if j > 1 and self.async_cfg is not None:
            ledger = init_wire_ledger(self.layout, len(self.offsets), j,
                                      codec=self.codec, device=self.device,
                                      rows=rows, slab=self.slab)
        return TrainState(
            params=params, opt=adamw_lib.init(self.acfg, params),
            lam=torch.zeros(flat_shape, dtype=torch.float32,
                            device=self.device),
            theta_bar_prev=torch.zeros(flat_shape, dtype=torch.float32,
                                       device=self.device),
            penalty=init_penalty_state(self.ccfg.penalty, j,
                                       device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            topo=self.topo_rt.init_state(self.device), ledger=ledger,
            ring=(obs_ring.init_ring(self.obs_cfg.ring_capacity,
                                     self.device) if self.obs_on else None),
            node_ring=(obs_node_ring.init_node_ring(
                self.obs_cfg.ring_capacity, j, self.device)
                if self.node_ring_on else None))

    # ------------------------------------------------------- local steps ----
    def train_step(self, state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        """One local AdamW step on every node of this rank (no exchange);
        ``batch`` holds this rank's [J/R, ...] rows.

        Nodes run one after another — forward, backward and update — so the
        peak memory holds one node's gradients. The update is in place.
        The metrics cover all J nodes (gathered across ranks).
        """
        losses, gnorms = [], []
        for i in range(self.n_local):
            p_i = tree_lib.tree_map(lambda x: x[i], state.params)
            loss, grads = fsdp.loss_and_grads(
                self.model, self.mesh, p_i,
                {k: v[i] for k, v in batch.items()}, self.gather_specs)
            opt_i = adamw_lib.AdamWState(
                step=state.opt.step,
                m=tree_lib.tree_map(lambda x: x[i], state.opt.m),
                v=tree_lib.tree_map(lambda x: x[i], state.opt.v))
            _, _, mtr = adamw_lib.update(self.acfg, opt_i, p_i, grads,
                                         mesh=self.mesh, specs=self.specs)
            del grads
            losses.append(loss)
            gnorms.append(mtr["grad_norm"])
        new = state._replace(
            opt=state.opt._replace(step=state.opt.step + 1),
            step=state.step + 1)
        losses = gather_nodes(torch.stack(losses), self.ranks)
        gnorms = gather_nodes(torch.stack(gnorms), self.ranks)
        return new, {"loss": losses.mean(), "grad_norm": gnorms}

    def _whole_params(self, params: dict) -> dict:
        """This rank's node rows of the whole parameters: on a rank of an
        in-pod mesh its shards gathered in-pod (a transient, ``[1,
        ...]``), else ``params`` itself."""
        if not self.param_shards:
            return params
        one = fsdp.gather_whole(tree_lib.tree_map(lambda x: x[0], params),
                                self.specs, self.mesh)
        return tree_lib.tree_map(lambda x: x[None], one)

    def _own_slab(self, theta_flat: torch.Tensor) -> torch.Tensor:
        """The packed rows the round kernel runs on: a slab rank's own
        slab, copied out of its whole packed row once its message is
        encoded, so that the rest of the row is freed before the probes;
        else the rows themselves."""
        if not self.slab:
            return theta_flat
        return theta_flat[:, self.cols].clone()

    def _keep_params(self, params: dict, theta_new: torch.Tensor,
                     rows=None) -> None:
        """The round's new rows ``theta_new`` (whole flat rows) into the
        parameter rows ``rows`` (all of this rank's by default), in place;
        on a rank of an in-pod mesh, its shards of them."""
        new = self.layout.unpack(theta_new)
        leaves = tree_lib.leaves(params)
        specs = tree_lib.leaves(self.specs, is_leaf=lambda x: isinstance(
            x, tuple)) if self.param_shards else [None] * len(leaves)
        for dst, src, spec in zip(leaves, tree_lib.leaves(new), specs,
                                  strict=True):
            if spec is not None:         # the node axis leads
                src = fsdp.shard_of(src, (None,) + tuple(spec), self.mesh,
                                    self.mesh.coords)
            if rows is None:
                dst.copy_(src)
            else:
                for r in rows:
                    dst[r].copy_(src[r])

    def should_sync(self, step: int) -> bool:
        return self.num_nodes > 1 and (step + 1) % self.ccfg.local_steps == 0

    # --------------------------------------------------- consensus round ----
    def _finish_round(self, new: TrainState, metrics: dict,
                      node_metrics: dict | None = None
                      ) -> tuple[TrainState, dict]:
        """Every consensus round's single exit: the schema and the rings.

        Unifies ``metrics`` to the full ``obs.schema.ROUND_METRICS`` key set
        (every round path returns the same keys) and, with obs on, appends
        the round's row to the metrics ring and its per-node slab
        (``node_metrics``, ``[J]`` tensors; missing keys pad to the defined
        not-applicable values) to the node ring, in place on the device.
        """
        metrics = obs_schema.unify_round_metrics(metrics, self.device)
        if self.obs_on and new.ring is not None:
            obs_ring.ring_append(new.ring,
                                 obs_schema.metrics_row(new.step, metrics))
        if self.node_ring_on and new.node_ring is not None:
            obs_node_ring.node_ring_append(new.node_ring, obs_schema.node_row(
                new.step, node_metrics or {}, self.num_nodes))
        return new, metrics

    @torch.no_grad()
    def _probe_losses(self, params: dict, batch: dict) -> torch.Tensor:
        """[J/R] local objectives f_i at node i's row of ``params`` (whole
        rows), for this rank's nodes: under the in-pod mesh with ``batch ->
        data`` (on a 1 x 1 mesh, the node's whole batch)."""
        out = []
        for i in range(self.n_local):
            p_i = tree_lib.tree_map(lambda x: x[i], params)
            b_i = {k: v[i] for k, v in batch.items()}
            out.append(fsdp.node_loss(self.model, self.mesh, p_i, b_i))
        return torch.stack(out)

    def _gather_slabs(self, t: torch.Tensor) -> torch.Tensor:
        """The S slabs of a slab rank's pod, joined along the last dim:
        ``[..., n]`` -> ``[..., S * n]`` in slab order."""
        out = gather_pod(t, self.ranks, self._staging)     # [S, ..., n]
        return out.movedim(0, -2).reshape(tuple(t.shape[:-1]) + (-1,))

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a replicated [..., J] tensor (at one
        rank the tensor itself: the slice is whole and contiguous)."""
        return t[..., self.ranks.node_lo:self.ranks.node_hi].contiguous()

    def staging_bytes(self) -> int:
        """Pinned host bytes this rank holds for its staged exchanges and
        gathers (0 unless gloo on a card)."""
        pairs = {id(h): h for h in self._xstaging + [self._staging]
                 if h is not None}
        return sum(h.send.numel() + h.recv.numel() for h in pairs.values())

    def _window(self, order, dst_of, wire, keep=None) -> _Window:
        """Start the exchanges of the offsets in ``order`` into
        ``dst_of(d)`` (leaving the rows ``keep[d]`` marks as they are),
        ``pipeline_depth`` ahead of their consumer; offset d's P2P ops
        carry tag d."""
        def start(d, slot):
            off = self.offsets[d]
            with self._span(f"consensus/exchange/off{off}"):
                return circulant_start(
                    dst_of(d), wire, off, self.ranks, self._xstaging[slot],
                    tag=d, keep=None if keep is None else keep[d])
        return _Window(order, self.pipeline_depth, start)

    def _fused_round(self, window, theta_flat, state, wires, scales,
                     e_stack, alpha, sym_sum, eta_node, gated):
        """The round kernel on this rank's rows ``theta_flat`` (a slab
        rank's own slab of its packed row), then every node's block
        partials summed as one process sums its own, the same bits however
        the rows and the slabs are split. ``window`` holds the round's
        exchanges, each of which must have been waited on. Returns
        (theta_new of this rank's whole rows, lam', bar', r_sq [J], s_sq
        [J])."""
        if window.in_flight:
            raise RuntimeError(
                f"{window.in_flight} exchange(s) still in flight at the round "
                "kernel, which overwrites a native wire in place")
        with self._span("consensus/fused_round"):
            theta_new, lam_new, bar_new, r_sq, s_sq = kops.consensus_round(
                theta_flat, state.lam, state.theta_bar_prev,
                wires, scales,
                self._local(e_stack), self._local(alpha),
                self._local(sym_sum), self._local(eta_node),
                block_leaf=self.block_leaf,
                block_size=self.layout.block_size,
                scales_per_block=self.dequant_spec.per_block,
                partials=True,
                **{k: self._local(v) for k, v in gated.items()})
        rs = torch.stack([r_sq, s_sq], dim=1)          # [J/R, 2, blocks]
        if self.slab:
            with self._span("consensus/gather"):
                rs = self._gather_slabs(rs)
                theta_new = self._gather_slabs(theta_new)
        rs = gather_nodes(rs, self.ranks)
        return (theta_new, lam_new, bar_new, rs[:, 0].contiguous().sum(dim=1),
                rs[:, 1].contiguous().sum(dim=1))

    def _probe_row(self, row: torch.Tensor, probe_batch: dict
                   ) -> torch.Tensor:
        """[J/R] probes of this rank's nodes at one offset's raw wire rows
        (a slab rank's slab message: its pod's slabs gathered first)."""
        if self.slab:
            with self._span("consensus/gather"):
                row = self._gather_slabs(row)
        with self._span("wire/decode"):
            payload, sc = self.codec.decode(row)
        with self._span("consensus/probe"):
            return self._probe_losses(self.codec.unpack(payload, sc),
                                      probe_batch)

    @torch.no_grad()
    def consensus_step(self, state: TrainState, probe_batch: dict
                       ) -> tuple[TrainState, dict]:
        """One ADMM consensus round over the flat buffers."""
        dev = self.device
        f32 = torch.float32
        if self.num_nodes <= 1:
            return self._finish_round(state, {
                "r_max": torch.zeros((), device=dev),
                "eta_mean": torch.tensor(self.ccfg.penalty.eta0,
                                         device=dev)})
        j = self.num_nodes
        offsets = self.offsets
        deg = len(offsets)
        lay = self.layout
        idx = torch.arange(j, device=dev)
        dynamic = self.dynamic
        topo = state.topo
        # scheduler zero-kick: consume the kick weights parked when edges
        # gated at the END of the last round — their neighbors' parameters
        # are on THIS round's wire
        kick_on = dynamic and self.topo_cfg.can_gate

        # offsets to exchange: all of them, except (dynamic, with
        # skip_dead_offsets) those with no active edge and no pending kick,
        # from ONE host read of the mask (and kicks) per round
        live = [True] * deg
        if dynamic and self.topo_cfg.skip_dead_offsets:
            gates = topo.mask.to(f32)
            if kick_on:
                gates = gates + topo.kick
            gates = gates.cpu().numpy()
            rows = np.arange(j)
            live = [bool(gates[rows, (rows + off) % j].sum() > 0)
                    for off in offsets]

        # this rank's nodes' whole parameters: on a rank of an in-pod
        # mesh its shards gathered in-pod, a transient read by the own
        # probe and the pack
        whole = self._whole_params(state.params)
        with self._span("consensus/probe"):
            f_self = self._probe_losses(whole, probe_batch)  # [J/R]

        # pack in the params' float dtype (bf16 params -> bf16 wire); a
        # slab rank packs the whole row and encodes its slab's message
        with self._span("consensus/pack"):
            theta_flat = lay.pack(whole, dtype=lay.wire_dtype)
            del whole
            with self._span("wire/encode"):
                wire = (self.codec.encode_slab(theta_flat, self.ranks.shard)
                        if self.slab else self.codec.encode(theta_flat))
            theta_flat = self._own_slab(theta_flat)

        # exchange: rolled[d] = torch.roll(wire of all J, -off_d, 0), this
        # rank's rows. These are COPIES, never views of theta_flat: the
        # kernel updates theta_flat in place on the card, and it runs after
        # every exchange has been waited on. The live offsets' exchanges
        # are issued ``pipeline_depth`` ahead of their probes; a dead
        # offset moves nothing (on every rank: ``live`` is read from the
        # replicated state): its row is a zero payload with unit scales.
        rolled = torch.empty((deg,) + tuple(wire.shape), dtype=wire.dtype,
                             device=dev)
        for d in range(deg):
            if not live[d]:
                rolled[d].zero_()
        window = self._window([d for d in range(deg) if live[d]],
                              lambda d: rolled[d], wire)
        del wire               # the window holds it until all are issued
        # consume in offset order: wait, then probe this rank's nodes at
        # the offset's payload (one row decoded: the bytes the stacked
        # decode below gives the kernel), then issue the next offset
        f_live = []
        for d in range(deg):
            if live[d]:
                window.wait(d)
                f_live.append(self._probe_row(rolled[d], probe_batch))
                window.fill()
        with self._span("wire/decode"):
            payloads, dec_scales = (
                self.codec.decode_slab(rolled, self.ranks.shard) if self.slab
                else self.codec.decode(rolled))
        wires = payloads.contiguous()           # [deg, J/R, total or slab]
        del payloads, rolled
        # every node's probes, gathered
        f_all = gather_nodes(torch.stack([f_self] + f_live, dim=1),
                             self.ranks)                      # [J, 1 + live]
        f_self = f_all[:, 0].contiguous()
        f_live = iter([f_all[:, 1 + n].contiguous()
                       for n in range(len(f_live))])

        eta = state.penalty.eta
        sym_sum = torch.zeros((j,), dtype=f32, device=dev)
        f_nbr = torch.zeros((j, j), dtype=f32, device=dev)
        e_rows, w_rows, kick_rows = [], [], []
        if dynamic:
            mask_f = topo.mask.to(f32)
            act = torch.zeros((j,), dtype=f32, device=dev)
            # node ring: the offsets each node consumed a payload on
            rx = torch.zeros((j,), dtype=f32, device=dev) \
                if self.node_ring_on else None
        for d, off in enumerate(offsets):
            jidx = (idx + off) % j
            # a dead offset probes f_self (no forward)
            f_off = next(f_live) if live[d] else f_self
            e_sym = 0.5 * (eta[idx, jidx] + eta[jidx, idx])             # [J]
            if dynamic:
                # the gate flows into the edge weights: a gated edge costs
                # zero math in the kernel
                m_off = mask_f[idx, jidx]                               # [J]
                e_sym = e_sym * m_off
                act = act + m_off
                w_rows.append(m_off)
                if kick_on:
                    kick_rows.append(topo.kick[idx, jidx])
                if rx is not None and live[d]:
                    consumed = m_off + kick_rows[-1] if kick_on else m_off
                    rx = rx + (consumed > 0).to(f32)
            # F[i, (i+off) % J] through the static circulant mask
            mask = torch.as_tensor(np.roll(np.eye(j), off, axis=1),
                                   dtype=f32, device=dev)
            f_nbr = f_nbr + f_off[:, None] * mask
            sym_sum = sym_sum + e_sym
            e_rows.append(e_sym)
        e_stack = torch.stack(e_rows)                                  # [deg, J]
        scales = dec_scales.contiguous() if dec_scales is not None \
            else torch.ones((deg, self.n_local,
                             self.dequant_spec.scale_width),
                            dtype=f32, device=dev)
        for d in range(deg):
            if not live[d]:
                scales[d] = 1.0

        alpha = self.ccfg.prox_step / (1.0 + 2.0 * sym_sum)           # [J]
        gated = {}
        if dynamic:
            # active-degree neighbor mean; ghosts (degree 0) get bar = 0
            inv_deg = torch.where(act > 0, 1.0 / torch.clamp_min(act, 1.0),
                                  0.0)
            eta_node = sym_sum * inv_deg
            gated = dict(bar_w=torch.stack(w_rows), inv_deg=inv_deg)
            if kick_on:
                gated["kick_w"] = torch.stack(kick_rows)
        else:
            eta_node = sym_sum / deg
        theta_new, lam_new, bar_new, r_sq, s_sq = self._fused_round(
            window, theta_flat, state, wires, scales, e_stack, alpha,
            sym_sum, eta_node, gated)
        del wires

        # theta_new -> the parameter replicas (a rank's shards), in place
        self._keep_params(state.params, theta_new)
        del theta_flat, theta_new
        r_norm = torch.sqrt(r_sq)
        s_norm = torch.sqrt(s_sq)
        adj = self._adj
        if dynamic:
            # penalties keep adapting on gated GRAPH edges (the eq. 10
            # top-up must still see them to revive) and on repair edges,
            # but never on ghost rows/cols
            alive = topo.node_alive
            adj_pen = (adj & alive[:, None] & alive[None, :]) | topo.mask
        else:
            adj_pen = adj
        with self._span("consensus/penalty"):
            penalty_new = update_penalty(
                self.ccfg.penalty, state.penalty, adj=adj_pen,
                f_self=f_self, f_nbr=f_nbr, r_norm=r_norm, s_norm=s_norm)
            topo_new = self.topo_rt.update(topo, penalty=penalty_new,
                                           r_norm=r_norm) if dynamic else topo
        if kick_on:
            # edges the scheduler just gated: park their final consensus
            # force (the symmetrized weight applied THIS round) for the
            # kernel to absorb into the dual next round
            newly_off = (topo.mask & ~topo_new.mask).to(f32)
            topo_new = topo_new._replace(kick=0.5 * (eta + eta.T)
                                         * newly_off)
        new = state._replace(lam=lam_new, theta_bar_prev=bar_new,
                             penalty=penalty_new, topo=topo_new)
        if dynamic:
            # ghost and zero-active-degree rows have bar = 0, so their
            # "residual" is the full parameter norm; an isolated node has
            # no consensus constraint — exclude both from the extremes
            alive_f = topo.node_alive.to(f32) * (act > 0).to(f32)
            r_rep, s_rep = r_norm * alive_f, s_norm * alive_f
            f_rep = (f_self * alive_f).sum() / torch.clamp_min(
                alive_f.sum(), 1)
        else:
            r_rep, s_rep, f_rep = r_norm, s_norm, f_self.mean()
        metrics = {
            "r_max": r_rep.max(), "s_max": s_rep.max(),
            "f_mean": f_rep,
            "eta_mean": torch.where(adj, penalty_new.eta, 0.0).sum()
            / torch.clamp_min(adj.sum(), 1),
            "active_edges": (active_edge_fraction(topo, adj) if dynamic
                             else torch.ones((), device=dev)),
        }
        node_metrics = None
        if self.node_ring_on:
            if not dynamic:        # every offset's payload, every node
                rx = torch.full((j,), float(deg), device=dev)
            node_metrics = {
                "r": r_rep, "s": s_rep, "f_local": f_self,
                "eta_row_mean": self._eta_row_mean(penalty_new.eta),
                "alive": (topo.node_alive.to(f32) if dynamic
                          else torch.ones((j,), dtype=f32, device=dev)),
                "wire_rx_bytes": rx * float(self.codec.wire_bytes()),
            }
        return self._finish_round(new, metrics, node_metrics)

    def _eta_row_mean(self, eta: torch.Tensor) -> torch.Tensor:
        """[J] mean penalty over each node's graph row."""
        adj = self._adj
        return torch.where(adj, eta, 0.0).sum(dim=1) \
            / torch.clamp_min(adj.sum(dim=1), 1)

    # --------------------------------------------- async consensus round ----
    @torch.no_grad()
    def consensus_step_async(self, state: TrainState, probe_batch: dict,
                             arrivals, advance=None
                             ) -> tuple[TrainState, dict]:
        """One bounded-staleness consensus round (``repro_torch.async_exec``).

        Each directed edge consumes the freshest payload that has landed,
        else the wire ledger's held row (the payload it consumed last). An
        edge whose symmetrized age exceeds ``AsyncConfig.max_staleness`` is
        gated (zero math in the edge-gated kernel) and the edge that has
        just aged out absorbs its final force into the dual at the weight
        it applied last round (``ledger.w_prev``); a fresh arrival revives
        it the same round. Applied penalties are damped by age.

        Args:
          arrivals: [deg, J] bool host array — ``arrivals[d, i]``: the
            payload from node ``(i + off_d) % J`` reached node i this tick
            (the executor's round clock).
          advance: optional [J] bool host array — the nodes running a round
            this tick. A frozen node keeps its parameter, dual and
            neighbour-mean rows and its penalty edges to other frozen nodes;
            its clocks tick.

        The clock's bits pick on the host which rows to copy and which to
        keep, and go to the device once. Both are replicated: every rank
        makes the same exchanges and gathers, and updates its own nodes'
        rows. With ``max_staleness=0`` this is ``consensus_step`` itself.
        """
        if self.async_cfg is None:
            raise ValueError("consensus_step_async needs ConsensusConfig."
                             "async_exec=AsyncConfig(...)")
        dev = self.device
        f32 = torch.float32
        if self.num_nodes <= 1:
            return self._finish_round(state, {
                "r_max": torch.zeros((), device=dev),
                "eta_mean": torch.tensor(self.ccfg.penalty.eta0,
                                         device=dev)})
        acfg = self.async_cfg
        if acfg.max_staleness == 0:
            return self.consensus_step(state, probe_batch)
        if state.ledger is None:
            raise ValueError("the state has no wire ledger: build it with "
                             "init_state of an async trainer")
        j = self.num_nodes
        offsets = self.offsets
        deg = len(offsets)
        lay = self.layout
        adj = self._adj
        idx = torch.arange(j, device=dev)
        ledger: WireLedger = state.ledger
        n_stale = acfg.max_staleness
        arr_np = np.asarray(arrivals, dtype=bool)                # [deg, J]
        adv_np = None if advance is None else np.asarray(advance, dtype=bool)

        # ---- staleness clocks: tick, then gate -------------------------
        # arrivals [deg, J] -> the [J, J] grid through the static circulant
        # masks; pairs outside the offset superset never move a payload and
        # stay fresh instead of counting phantom staleness
        covered = np.zeros((j, j), dtype=bool)
        fresh_np = np.zeros((j, j), dtype=bool)
        for d, off in enumerate(offsets):
            circ = np.roll(np.eye(j, dtype=bool), off, axis=1)
            covered |= circ
            fresh_np |= arr_np[d][:, None] & circ
        fresh = torch.as_tensor(fresh_np | ~covered, device=dev)
        prev_live = sym_age(state.topo) <= n_stale           # pre-tick view
        topo = tick_age(state.topo, fresh)
        age_s = sym_age(topo)
        live = age_s <= n_stale
        if self.topo_cfg.scheduler == "stale":
            # staleness is the mask's only gating source: gate on the mask
            # composed from THIS round's clocks, so that a fresh arrival
            # revives the edge the same round
            base_mask = compose_mask(adj, topo, adj)
            prev_base = compose_mask(adj, state.topo, adj)
        else:
            base_mask = prev_base = topo.mask
        gate_m = base_mask & live
        gate_f = gate_m.to(f32)
        eta_eff = effective_eta(self.ccfg.penalty, state.penalty, gate_m,
                                age=age_s, stale_gamma=acfg.stale_gamma)
        w_applied = 0.5 * (eta_eff + eta_eff.T)                   # [J, J]
        # zero-kick: (a) edges that just aged past the bound absorb now,
        # from the ledger, at the weight they applied last round; (b) edges
        # the scheduler gated last round ride in topo.kick
        newly_stale = prev_base & prev_live & ~live
        kick_m = torch.where(newly_stale, ledger.w_prev, 0.0) + topo.kick
        # one host read per round: which offsets' payloads are consumed
        gk = torch.stack([gate_f, kick_m]).cpu().numpy()
        rows = np.arange(j)
        probed = [bool(gk[0][rows, (rows + off) % j].sum()
                       + gk[1][rows, (rows + off) % j].sum() > 0)
                  for off in offsets]

        whole = self._whole_params(state.params)
        with self._span("consensus/probe"):
            f_self = self._probe_losses(whole, probe_batch)  # [J/R]
        with self._span("consensus/pack"):
            theta_flat = lay.pack(whole, dtype=lay.wire_dtype)
            del whole
            with self._span("wire/encode"):
                wire = (self.codec.encode_slab(theta_flat, self.ranks.shard)
                        if self.slab else self.codec.encode(theta_flat))
            theta_flat = self._own_slab(theta_flat)
        # merge: every rank exchanges each offset where any payload landed
        # (the replicated arrivals) into its ledger rows, keeping the held
        # row of each receiver whose payload did not land (a COPY: a native
        # wire is theta_flat, which the kernel overwrites). An offset where
        # nothing landed moves nothing. The merges are issued
        # ``pipeline_depth`` ahead of the probes.
        lo, hi = self.ranks.node_lo, self.ranks.node_hi
        merged = [d for d in range(deg) if arr_np[d].any()]
        window = self._window(merged, lambda d: ledger.wires[d], wire,
                              keep=~arr_np[:, lo:hi])
        del wire               # the window holds it until all are issued
        # consume in offset order: the merge, then this rank's probes of
        # the payload actually consumed (a held one included; a fully
        # gated, kick-free offset skips the forward pass)
        f_probed = []
        for d in range(deg):
            if d in merged:
                window.wait(d)
            if probed[d]:
                f_probed.append(self._probe_row(ledger.wires[d],
                                                probe_batch))
            window.fill()
        with self._span("wire/decode"):
            payloads, dec_scales = (
                self.codec.decode_slab(ledger.wires, self.ranks.shard)
                if self.slab else self.codec.decode(ledger.wires))
        wires = payloads.contiguous()     # native: the ledger itself
        del payloads
        f_all = gather_nodes(torch.stack([f_self] + f_probed, dim=1),
                             self.ranks)                  # [J, 1 + probed]
        f_self = f_all[:, 0].contiguous()
        f_probed = iter([f_all[:, 1 + n].contiguous()
                         for n in range(len(f_probed))])

        sym_sum = torch.zeros((j,), dtype=f32, device=dev)
        act = torch.zeros((j,), dtype=f32, device=dev)
        f_nbr = torch.zeros((j, j), dtype=f32, device=dev)
        e_rows, w_rows, kick_rows = [], [], []
        for d, off in enumerate(offsets):
            jidx = (idx + off) % j
            g_off = gate_f[idx, jidx]
            f_off = next(f_probed) if probed[d] else f_self
            e_sym = w_applied[idx, jidx]
            mask = torch.as_tensor(np.roll(np.eye(j), off, axis=1),
                                   dtype=f32, device=dev)
            f_nbr = f_nbr + f_off[:, None] * mask
            sym_sum = sym_sum + e_sym
            act = act + g_off
            e_rows.append(e_sym)
            w_rows.append(g_off)
            kick_rows.append(kick_m[idx, jidx])
        scales = dec_scales.contiguous() if dec_scales is not None \
            else torch.ones((deg, self.n_local,
                             self.dequant_spec.scale_width),
                            dtype=f32, device=dev)
        alpha = self.ccfg.prox_step / (1.0 + 2.0 * sym_sum)
        inv_deg = torch.where(act > 0, 1.0 / torch.clamp_min(act, 1.0), 0.0)
        eta_node = sym_sum * inv_deg

        # the kernel writes every row in place, a frozen one too (with all
        # gates 0 it still pulls theta by the dual and zeroes bar): keep a
        # copy of this rank's frozen rows only
        adv_mine = None if adv_np is None else adv_np[lo:hi]
        frozen = None if adv_mine is None or adv_mine.all() else \
            torch.as_tensor(np.nonzero(~adv_mine)[0], device=dev)
        held = None if frozen is None else (
            state.lam.index_select(0, frozen),
            state.theta_bar_prev.index_select(0, frozen))
        theta_new, lam_new, bar_new, r_sq, s_sq = self._fused_round(
            window, theta_flat, state, wires, scales, torch.stack(e_rows),
            alpha, sym_sum, eta_node, dict(bar_w=torch.stack(w_rows),
                                           inv_deg=inv_deg,
                                           kick_w=torch.stack(kick_rows)))
        del wires, scales

        # theta_new -> the parameter replicas of this rank's advancing nodes
        adv_rows = range(self.n_local) if adv_mine is None \
            else np.nonzero(adv_mine)[0]
        self._keep_params(state.params, theta_new,
                          None if len(adv_rows) == self.n_local
                          else adv_rows)
        del theta_flat, theta_new
        r_norm = torch.sqrt(r_sq)
        s_norm = torch.sqrt(s_sq)

        # penalties keep adapting on stale- and scheduler-gated graph edges
        # (the eq. 10 top-up revives them), never on ghost rows
        alive = topo.node_alive
        adj_pen = (adj & alive[:, None] & alive[None, :]) | topo.mask
        with self._span("consensus/penalty"):
            penalty_new = update_penalty(
                self.ccfg.penalty, state.penalty, adj=adj_pen,
                f_self=f_self, f_nbr=f_nbr, r_norm=r_norm, s_norm=s_norm)
            topo_new = self.topo_rt.update(topo, penalty=penalty_new,
                                           r_norm=r_norm) \
                if self.dynamic else topo
        if self.dynamic and self.topo_cfg.can_gate:
            # park kicks only for edges ACTIVE this round (mask and within
            # the bound): an edge that aged out was absorbed in-round, and
            # the scheduler mirroring it out of the mask must not absorb it
            # twice
            kick_next = w_applied * (gate_m & ~topo_new.mask).to(f32)
        else:
            kick_next = torch.zeros_like(topo.kick)
        new = state._replace(
            lam=lam_new, theta_bar_prev=bar_new, penalty=penalty_new,
            topo=topo_new._replace(kick=kick_next),
            ledger=WireLedger(wires=ledger.wires, round=ledger.round + 1,
                              w_prev=w_applied))
        adv_f = torch.ones((j,), dtype=f32, device=dev)
        if adv_np is not None:
            adv_t = torch.as_tensor(adv_np, device=dev)
            new = self._freeze_rows(adv_t, new, state.penalty, frozen, held)
            adv_f = adv_t.to(f32)

        # frozen nodes ran no real round: keep them out of the extremes,
        # with ghost and isolated rows
        alive_f = topo.node_alive.to(f32) * (act > 0).to(f32) * adv_f
        r_rep, s_rep = r_norm * alive_f, s_norm * alive_f
        f_rep = (f_self * alive_f).sum() / torch.clamp_min(alive_f.sum(), 1)
        mask_edges = torch.clamp_min(base_mask.to(f32).sum(), 1.0)
        metrics = {
            "r_max": r_rep.max(), "s_max": s_rep.max(),
            "f_mean": f_rep,
            "eta_mean": torch.where(adj, penalty_new.eta, 0.0).sum()
            / torch.clamp_min(adj.sum(), 1),
            "active_edges": (active_edge_fraction(topo, adj) if self.dynamic
                             else torch.ones((), device=dev)),
            "stale_edges": (base_mask & ~live).to(f32).sum() / mask_edges,
            "age_max": torch.where(base_mask, age_s, 0).max(),
        }
        node_metrics = None
        if self.node_ring_on:
            # fresh wire bytes per node: the offsets whose payload landed
            # this tick (held ledger rows are not paid again), read off the
            # clock grid on the device
            rx = (fresh & self._covered).sum(dim=1).to(f32)
            node_metrics = {
                "r": r_rep, "s": s_rep, "f_local": f_self,
                "eta_row_mean": self._eta_row_mean(penalty_new.eta),
                "age_max": torch.where(base_mask, age_s, 0).amax(dim=1),
                "alive": topo.node_alive.to(f32),
                "advance": adv_f,
                "wire_rx_bytes": rx * float(self.codec.wire_bytes()),
            }
        return self._finish_round(new, metrics, node_metrics)

    def _freeze_rows(self, advance: torch.Tensor, new: TrainState,
                     old_penalty: PenaltyState, frozen, held) -> TrainState:
        """Put back the rows of the nodes that did not advance this tick.

        ``frozen`` holds their rows among this rank's (None: none) and
        ``held`` the copies of their dual and neighbour-mean rows taken
        before the kernel wrote them; their parameter rows were never
        written. The penalty freezes per edge
        (``core.penalty.freeze_penalty``). The clocks, the topology and the
        ledger always advance: they model the network, not the node.
        """
        if frozen is not None:
            new.lam.index_copy_(0, frozen, held[0])
            new.theta_bar_prev.index_copy_(0, frozen, held[1])
        return new._replace(penalty=freeze_penalty(advance, new.penalty,
                                                   old_penalty))

    # ------------------------------------------------------------- churn ----
    def apply_churn(self, state: TrainState, victim: int) -> TrainState:
        """Host-side layout-preserving node drop — a topology epoch, not a
        crash: every buffer keeps its [J, ...] shape, only ``state.topo``
        (liveness, mask, repair edges) is rewritten, and the victim becomes
        a ghost row whose edges cost zero math. Needs a dynamic topology
        config (``churn=True`` or a non-static scheduler)."""
        if not self.dynamic:
            raise ValueError(
                "node churn needs ConsensusConfig.dyn_topology with "
                "churn=True (or a non-static scheduler)")
        return state._replace(topo=self.topo_rt.drop_node(state.topo,
                                                          victim))
