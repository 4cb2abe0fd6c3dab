"""Runtime fault tolerance: retries, straggler detection, elastic rescale
(port of ``repro/runtime/fault_tolerance.py``). Wall-clock straggler
detection serves the synchronous launcher; ``aged_out_nodes`` reads the
async executor's staleness clocks instead.

Consensus ADMM tolerates a missing neighbor: dropping an edge or a node
leaves a smaller but still valid consensus problem. Two elastic paths use
that:

  * **layout-preserving** (``ElasticController.drop_preserving``): the lost
    node becomes a masked ghost row in the dynamic-topology state
    (``repro_torch.topology``) — every buffer keeps its shape; the runtime
    rewires the survivors through the exchange's offset superset and
    checks connectivity. A node loss is a topology epoch, not a crash.
  * **shrinking** (``ElasticController.drop``): rebuild the graph at J-1
    (``core.graph.drop_node``) and remap the surviving penalty edges — a
    restart into the smaller problem.

Wall-clock monitoring takes its durations as arguments, so the straggler
logic is testable without slow hosts. Across ranks each node's duration is
its rank's step time, all-gathered (``node_durations``), so that every
rank flags the same nodes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.graph import Graph, drop_node
from repro_torch.core.penalty import PenaltyState


@dataclasses.dataclass
class RetryPolicy:
    max_retries: int = 3
    backoff_s: float = 0.5
    backoff_mult: float = 2.0
    retryable: tuple = (RuntimeError, OSError)


def with_retries(fn: Callable, policy: RetryPolicy,
                 *, on_retry: Callable[[int, Exception], None] | None = None,
                 sleep: Callable[[float], None] = time.sleep):
    """Wrap a step function in bounded retry-with-backoff."""
    def wrapped(*args, **kwargs):
        delay = policy.backoff_s
        for attempt in range(policy.max_retries + 1):
            try:
                return fn(*args, **kwargs)
            except policy.retryable as e:
                if attempt == policy.max_retries:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(delay)
                delay *= policy.backoff_mult
        raise AssertionError("unreachable")
    return wrapped


class StragglerMonitor:
    """EMA step-time tracker with outlier flagging per node.

    ``observe`` takes the per-node durations of one step. A node whose EMA
    exceeds ``threshold`` x the fleet median for ``patience`` steps running
    is flagged; the caller decides what to do with it.
    """

    def __init__(self, num_nodes: int, *, alpha: float = 0.3,
                 threshold: float = 2.0, patience: int = 3):
        self.ema = np.zeros(num_nodes)
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.strikes = np.zeros(num_nodes, dtype=int)
        self._initialized = False

    def observe(self, durations: np.ndarray) -> list[int]:
        durations = np.asarray(durations, dtype=float)
        if not self._initialized:
            self.ema = durations.copy()
            self._initialized = True
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * durations
        med = float(np.median(self.ema))
        slow = self.ema > self.threshold * max(med, 1e-9)
        self.strikes = np.where(slow, self.strikes + 1, 0)
        return [int(i) for i in np.nonzero(
            self.strikes >= self.patience)[0]]


def node_durations(rank_seconds, nodes_per_rank: int) -> np.ndarray:
    """Per-node durations [J] from each rank's step seconds [R]: a rank's
    nodes run in its process one after another, so each takes its rank's
    time (one rank: the one step time for every node)."""
    return np.repeat(np.asarray(rank_seconds, dtype=float), nodes_per_rank)


def aged_out_nodes(topo_state, *, max_staleness: int,
                   patience: int = 4) -> list[int]:
    """Nodes whose EVERY active edge has aged past ``patience x bound``.

    An edge older than ``max_staleness`` is already gated by the async
    round; a live node whose freshest active edge is ``patience`` times
    older than the bound is gone, not late — return it for a
    layout-preserving ghost drop. Ages are symmetrized (max of both
    directions), so a half-broken link counts as broken.
    """
    age, mask, alive = (x.cpu().numpy() for x in (
        topo_state.age, topo_state.mask, topo_state.node_alive))
    age = np.maximum(age, age.T)
    cutoff = patience * max(max_staleness, 1)
    out = []
    for i in range(age.shape[0]):
        if not alive[i]:
            continue
        edges = mask[i] & alive
        edges[i] = False
        if edges.any() and age[i][edges].min() > cutoff:
            out.append(i)
    return out


def shrink_penalty_state(state: PenaltyState, victim: int) -> PenaltyState:
    """Remove a node's rows/cols from the [J, J] penalty state; surviving
    edges keep their eta, spent budget and top-up counters."""
    keep = torch.as_tensor([i for i in range(state.eta.shape[0])
                            if i != victim], device=state.eta.device)

    def cut(x):
        if x.dim() == 2:
            return x[keep][:, keep]
        if x.dim() == 1:
            return x[keep]
        return x

    return PenaltyState(eta=cut(state.eta), cum_tau=cut(state.cum_tau),
                        budget=cut(state.budget), n_incr=cut(state.n_incr),
                        f_prev=cut(state.f_prev), t=state.t)


@dataclasses.dataclass
class ElasticEvent:
    step: int
    victim: int
    old_nodes: int
    new_nodes: int
    mode: str = "shrink"          # shrink | preserve


class ElasticController:
    """Decides the new consensus problem when a node is lost: ``drop``
    shrinks the graph and penalty state to J-1; with a ``topology`` runtime
    attached, ``drop_preserving`` ghosts the victim in the TopologyState
    instead, and training continues with every shape unchanged."""

    def __init__(self, graph: Graph, *, topology=None):
        self.graph = graph
        self.topology = topology          # optional TopologyRuntime
        self.events: list[ElasticEvent] = []

    def drop(self, victim: int, penalty: PenaltyState, step: int
             ) -> tuple[Graph, PenaltyState]:
        old = self.graph.num_nodes
        self.graph = drop_node(self.graph, victim)
        new_pen = shrink_penalty_state(penalty, victim)
        self.events.append(ElasticEvent(step=step, victim=victim,
                                        old_nodes=old,
                                        new_nodes=self.graph.num_nodes))
        return self.graph, new_pen

    def drop_preserving(self, victim: int, topo_state, step: int):
        """Layout-preserving drop -> new TopologyState (no shapes change).

        The penalty state is not shrunk: the trainer masks ghost rows/cols
        out of the penalty adjacency, so surviving edges keep their history
        at the original [J, J] layout.
        """
        if self.topology is None:
            raise ValueError("drop_preserving needs a TopologyRuntime "
                             "(ElasticController(graph, topology=...))")
        new_state = self.topology.drop_node(topo_state, victim)
        alive = int(new_state.node_alive.sum())
        self.events.append(ElasticEvent(step=step, victim=victim,
                                        old_nodes=self.graph.num_nodes,
                                        new_nodes=alive, mode="preserve"))
        return new_state
