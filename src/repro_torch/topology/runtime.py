"""Host-side orchestration of the dynamic topology (port of
``repro/topology/runtime.py``).

``TopologyRuntime`` owns what is fixed for a graph and a config: the
spanning backbone (the connectivity guarantee), the round-robin rotation
masks, the circulant offset superset the trainer exchanges over, and the
churn repair that turns a lost node into a topology epoch instead of a
crash.

Churn model (layout-preserving): every buffer keeps its [J, ...] shape.
Losing node v flips ``node_alive[v]`` off, masks all its edges, and — when
that breaks the backbone — activates *repair* edges drawn from the edge
universe (for the trainer: the circulant offset superset, which is why
``spare_offsets`` exist; otherwise any node pair). The surviving subgraph
is checked connected on the host before the new mask goes back to the
device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph, connected_components
from repro_torch.core.penalty import PenaltyState
from repro_torch.topology.schedulers import TopologyConfig, update_topology
from repro_torch.topology.state import TopologyState, init_topology_state


def spanning_backbone(g: Graph) -> np.ndarray:
    """[J, J] bool — a minimal never-gated spanning subgraph of ``g``.

    Graphs that contain the unit-offset ring get that ring (it stays inside
    the exchange's offsets); anything else gets a BFS spanning tree.
    """
    j = g.num_nodes
    bb = np.zeros((j, j), dtype=bool)
    if j <= 1:
        return bb
    ring_ok = all(g.adj[i, (i + 1) % j] for i in range(j))
    if ring_ok and j > 2:
        for i in range(j):
            bb[i, (i + 1) % j] = bb[(i + 1) % j, i] = True
        return bb
    # BFS tree from node 0
    seen = {0}
    frontier = [0]
    while frontier:
        i = frontier.pop(0)
        for nb in g.neighbors(i):
            nb = int(nb)
            if nb not in seen:
                seen.add(nb)
                bb[i, nb] = bb[nb, i] = True
                frontier.append(nb)
    return bb


def rotation_masks(g: Graph) -> np.ndarray:
    """[R, J, J] bool — one symmetric mask per permutation round
    (``Graph.permutation_rounds``, a greedy edge coloring)."""
    j = g.num_nodes
    rounds = g.permutation_rounds()
    if not rounds:
        return np.zeros((1, j, j), dtype=bool)
    masks = np.zeros((len(rounds), j, j), dtype=bool)
    for r, pairs in enumerate(rounds):
        for (a, b) in pairs:
            masks[r, a, b] = masks[r, b, a] = True
    return masks


def _components(adj: np.ndarray, alive: np.ndarray) -> list[list[int]]:
    """Connected components of the alive-induced subgraph."""
    masked = np.asarray(adj, bool) & alive[:, None] & alive[None, :]
    return [c for c in connected_components(masked) if alive[c[0]]]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class TopologyRuntime:
    """Builds and advances ``TopologyState`` for one graph and config.

    ``update`` runs on the state's device; ``init_state`` and ``drop_node``
    are host-side.
    """

    def __init__(self, graph: Graph, cfg: TopologyConfig, *,
                 edge_universe: np.ndarray | None = None):
        self.graph = graph
        self.cfg = cfg
        self.backbone = spanning_backbone(graph)
        self.rotation = rotation_masks(graph)
        j = graph.num_nodes
        self.offsets = self._offset_superset()
        if edge_universe is not None:
            self.edge_universe = np.asarray(edge_universe, dtype=bool)
        elif self.offsets:                       # trainer: circulant superset
            u = np.zeros((j, j), dtype=bool)
            for off in self.offsets:
                for i in range(j):
                    u[i, (i + off) % j] = True
            np.fill_diagonal(u, False)
            self.edge_universe = u | u.T
        else:                                    # dense path: any pair
            self.edge_universe = ~np.eye(j, dtype=bool)
        self._consts: dict = {}

    # ------------------------------------------------------------ static ----
    def _offset_superset(self) -> list[int]:
        """Graph circulant offsets + churn spares (the exchange's offsets)."""
        j = self.graph.num_nodes
        if j <= 1:
            return []
        offs = set(self.graph.neighbor_offsets_ring())
        if self.cfg.churn:
            spares = self.cfg.spare_offsets or (2, j - 2)
            offs |= {o % j for o in spares if 0 < o % j < j}
        return sorted(offs)

    def expected_active_fraction(self) -> float:
        """Static estimate of |mask| / |adj| for edge-level accounting:
        budget's steady state is the backbone alone; random mixes the keep
        rate with the backbone floor; round_robin averages its phases."""
        adj_n = max(int(self.graph.adj.sum()), 1)
        bb_frac = self.backbone.sum() / adj_n
        cfg = self.cfg
        if cfg.scheduler in ("static", "stale"):
            return 1.0
        if cfg.scheduler == "budget":
            return float(bb_frac)
        if cfg.scheduler == "random":
            p = cfg.activation_p
            return float(p + (1.0 - p) * bb_frac)
        per_phase = [((m | self.backbone) & self.graph.adj).sum()
                     for m in self.rotation]
        return float(np.mean(per_phase) / adj_n)

    def expected_active_offsets(self) -> float:
        """Expected superset offsets that move per round (wire units): an
        offset is skipped only when every one of its edges is dead."""
        j = self.graph.num_nodes
        if j <= 1 or not self.offsets:
            return 0.0
        cfg = self.cfg
        if cfg.scheduler == "budget":
            patterns = [self.backbone]
        elif cfg.scheduler == "round_robin":
            patterns = [m | self.backbone for m in self.rotation]
        else:                                   # static, random
            patterns = [self.graph.adj]
        idx = np.arange(j)

        def alive_offsets(pattern):
            return sum(1 for off in self.offsets
                       if pattern[idx, (idx + off) % j].any())

        return float(np.mean([alive_offsets(p) for p in patterns]))

    # ------------------------------------------------------------- state ----
    def init_state(self, device: torch.device | str) -> TopologyState:
        return init_topology_state(self.graph.adj, self.backbone,
                                   device=device, seed=self.cfg.seed)

    def _device_consts(self, device: torch.device):
        c = self._consts.get(device)
        if c is None:
            c = self._consts[device] = (
                torch.as_tensor(self.graph.adj, device=device),
                torch.as_tensor(self.rotation, device=device))
        return c

    def update(self, state: TopologyState, *,
               penalty: PenaltyState | None = None,
               r_norm=None) -> TopologyState:
        """One scheduler epoch on the state's device."""
        adj, rotation = self._device_consts(state.mask.device)
        return update_topology(self.cfg, state, adj=adj, penalty=penalty,
                               r_norm=r_norm, rotation=rotation)

    # ------------------------------------------------------------- churn ----
    def drop_node(self, state: TopologyState, victim: int) -> TopologyState:
        """Host-side layout-preserving node drop -> new TopologyState.

        Ghosts the victim (liveness off, all its edges masked), then — if
        the backbone no longer spans the survivors — activates repair edges
        from the edge universe, preferring the victim's former neighbors.
        Raises if the survivors cannot be reconnected. Every tensor of the
        new state lies on the old one's device, with the old shape.
        """
        j = self.graph.num_nodes
        if not 0 <= victim < j:
            raise ValueError(f"victim {victim} out of range [0, {j})")
        alive = _host(state.node_alive).copy()
        if not alive[victim]:
            return state
        alive[victim] = False
        alive2 = alive[:, None] & alive[None, :]
        backbone = _host(state.backbone) & alive2
        repair = _host(state.repair) & alive2
        core = backbone | repair
        comps = _components(core, alive)
        if len(comps) > 1:
            repair = repair | self._bridge(comps, victim, alive)
            core = backbone | repair
            comps = _components(core, alive)
        if alive.sum() > 1 and len(comps) != 1:
            raise RuntimeError(
                f"edge universe cannot reconnect survivors after dropping "
                f"node {victim} (components: {comps}); widen spare_offsets")
        old_mask = _host(state.mask)
        mask = (old_mask & alive2) | core
        flipped = (mask != old_mask).astype(np.int32)
        # the ghost's staleness clocks and pending kicks die with it: its
        # last payload is not trusted for absorption, so churn gating is
        # kick-free
        epoch = _host(state.epoch) + flipped
        age = _host(state.age) * alive2.astype(np.int32)
        kick = _host(state.kick) * alive2.astype(np.float32)

        def like(new: np.ndarray, old: torch.Tensor) -> torch.Tensor:
            return torch.as_tensor(new, device=old.device).to(old.dtype)

        return state._replace(
            mask=like(mask, state.mask),
            backbone=like(backbone, state.backbone),
            repair=like(repair, state.repair),
            node_alive=like(alive, state.node_alive),
            epoch=like(epoch, state.epoch), age=like(age, state.age),
            kick=like(kick, state.kick))

    def _bridge(self, comps: list[list[int]], victim: int,
                alive: np.ndarray) -> np.ndarray:
        """Spanning chain over components through the edge universe.

        Greedy: repeatedly merge the first component with any other it can
        reach through a universe edge, preferring endpoints that were the
        victim's neighbors. The caller re-checks connectivity.
        """
        j = self.graph.adj.shape[0]
        nbrs = set(int(x) for x in self.graph.neighbors(victim))
        bridge = np.zeros((j, j), dtype=bool)
        comps = [list(c) for c in comps]
        merged = comps[0]
        rest = comps[1:]
        progress = True
        while rest and progress:
            progress = False
            for k, comp in enumerate(rest):
                pairs = [(a, b) for a in merged for b in comp
                         if self.edge_universe[a, b]]
                if not pairs:
                    continue
                pairs.sort(key=lambda ab: (ab[0] not in nbrs)
                           + (ab[1] not in nbrs))
                a, b = pairs[0]
                bridge[a, b] = bridge[b, a] = True
                merged = merged + comp
                rest.pop(k)
                progress = True
                break
        return bridge
