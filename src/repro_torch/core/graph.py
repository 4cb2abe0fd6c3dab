"""Communication-graph topologies for consensus ADMM (the port's copy of
``repro/core/graph.py``, numpy only).

The paper (AAAI'16, §2) formulates consensus optimization on a connected graph
G = (V, E); the penalty schemes of §3 attach state to *directed* edges e_ij.
This module builds the topologies used in the paper's experiments (complete,
ring, cluster — §5.1) plus extras needed at production scale (star, chain,
expander, torus) and exposes them in two forms:

  * a dense boolean adjacency matrix ``adj[J, J]`` (the penalty state's
    edge mask), and
  * circulant neighbor offsets (the trainer rolls its ``[J, total]`` wire
    buffer once per offset).

Everything here is static Python/NumPy; only penalties and parameters are
tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np

TOPOLOGIES = (
    "complete",
    "ring",
    "cluster",
    "star",
    "chain",
    "torus",
    "expander",
)


@dataclasses.dataclass(frozen=True, eq=False)
class Graph:
    """A static, connected, undirected communication graph.

    Attributes:
      num_nodes: J, the number of ADMM nodes.
      adj: (J, J) bool ndarray, symmetric, zero diagonal.
      name: topology name for logging.
    """

    num_nodes: int
    adj: np.ndarray
    name: str = "custom"

    def __post_init__(self):
        a = np.asarray(self.adj, dtype=bool)
        if a.shape != (self.num_nodes, self.num_nodes):
            raise ValueError(f"adjacency shape {a.shape} != J={self.num_nodes}")
        if np.any(np.diag(a)):
            raise ValueError("self-loops not allowed")
        if not np.array_equal(a, a.T):
            raise ValueError("graph must be undirected (symmetric adjacency)")
        if self.num_nodes > 1 and not self.is_connected():
            raise ValueError(f"topology {self.name!r} is not connected")

    # -- structure queries ---------------------------------------------------
    def neighbors(self, i: int) -> np.ndarray:
        return np.nonzero(self.adj[i])[0]

    @property
    def degrees(self) -> np.ndarray:
        return self.adj.sum(axis=1).astype(np.int32)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.num_nodes > 1 else 0

    @property
    def num_edges(self) -> int:
        return int(self.adj.sum()) // 2

    def directed_edges(self) -> list[tuple[int, int]]:
        """All ordered pairs (i, j) with e_ij in E — one per eta_ij."""
        ii, jj = np.nonzero(self.adj)
        return list(zip(ii.tolist(), jj.tolist()))

    def is_connected(self) -> bool:
        reach = np.zeros(self.num_nodes, dtype=bool)
        reach[0] = True
        frontier = [0]
        while frontier:
            i = frontier.pop()
            for j in np.nonzero(self.adj[i])[0]:
                if not reach[j]:
                    reach[j] = True
                    frontier.append(int(j))
        return bool(reach.all())

    def laplacian(self) -> np.ndarray:
        return np.diag(self.degrees.astype(np.float64)) - self.adj.astype(np.float64)

    def algebraic_connectivity(self) -> float:
        """Fiedler value — the paper observes VP degrades as this shrinks."""
        evals = np.linalg.eigvalsh(self.laplacian())
        return float(evals[1]) if self.num_nodes > 1 else 0.0

    # -- collective-friendly views -------------------------------------------
    def permutation_rounds(self) -> list[list[tuple[int, int]]]:
        """Decompose directed edges into rounds of disjoint-source permutations.

        Each round is a list of (src, dst) pairs where every src appears at
        most once — directly usable as a point-to-point send schedule.  Greedy
        edge coloring; at most ``max_degree`` rounds for the topologies here
        (each round sends in one direction, the reverse direction is the same
        round with pairs swapped, also a valid permutation).
        """
        rounds: list[list[tuple[int, int]]] = []
        remaining = {(i, j) for i, j in self.directed_edges()}
        while remaining:
            used_src: set[int] = set()
            used_dst: set[int] = set()
            round_pairs: list[tuple[int, int]] = []
            for (i, j) in sorted(remaining):
                if i not in used_src and j not in used_dst:
                    round_pairs.append((i, j))
                    used_src.add(i)
                    used_dst.add(j)
            remaining -= set(round_pairs)
            rounds.append(round_pairs)
        return rounds

    def neighbor_offsets_ring(self) -> list[int]:
        """For circulant graphs: neighbor index offsets (mod J)."""
        offs = set()
        for j in self.neighbors(0):
            offs.add((int(j) - 0) % self.num_nodes)
        return sorted(offs)


# --- constructors -------------------------------------------------------------


def complete_graph(j: int) -> Graph:
    adj = ~np.eye(j, dtype=bool)
    if j == 1:
        adj = np.zeros((1, 1), dtype=bool)
    return Graph(j, adj, "complete")


def ring_graph(j: int) -> Graph:
    adj = np.zeros((j, j), dtype=bool)
    for i in range(j):
        adj[i, (i + 1) % j] = True
        adj[(i + 1) % j, i] = True
    np.fill_diagonal(adj, False)
    return Graph(j, adj, "ring")


def chain_graph(j: int) -> Graph:
    adj = np.zeros((j, j), dtype=bool)
    for i in range(j - 1):
        adj[i, i + 1] = adj[i + 1, i] = True
    return Graph(j, adj, "chain")


def star_graph(j: int) -> Graph:
    adj = np.zeros((j, j), dtype=bool)
    adj[0, 1:] = adj[1:, 0] = True
    return Graph(j, adj, "star")


def cluster_graph(j: int) -> Graph:
    """Two complete graphs of sizes ceil(J/2), floor(J/2) linked by one edge.

    This is the paper's "cluster" topology (§5.1): "a connected graph consists
    of two complete graphs linked with an edge".
    """
    if j < 2:
        return complete_graph(j)
    a = (j + 1) // 2
    adj = np.zeros((j, j), dtype=bool)
    adj[:a, :a] = ~np.eye(a, dtype=bool)
    adj[a:, a:] = ~np.eye(j - a, dtype=bool)
    # bridge between node a-1 and node a
    adj[a - 1, a] = adj[a, a - 1] = True
    return Graph(j, adj, "cluster")


def torus_graph(rows: int, cols: int) -> Graph:
    j = rows * cols
    adj = np.zeros((j, j), dtype=bool)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for (dr, dc) in ((0, 1), (1, 0)):
                n = ((r + dr) % rows) * cols + (c + dc) % cols
                if n != i:
                    adj[i, n] = adj[n, i] = True
    return Graph(j, adj, "torus")


def expander_graph(j: int, degree: int = 4, seed: int = 0) -> Graph:
    """Circulant pseudo-expander: ring + power-of-two chords.

    Deterministic (seed picks chord phase), degree-bounded, diameter
    O(log J) — the topology we recommend for J in the hundreds-of-pods
    regime where complete is too chatty and ring mixes too slowly.
    """
    del seed
    adj = ring_graph(j).adj.copy()
    hop = 2
    added = 2
    while added < degree and hop < j:
        for i in range(j):
            adj[i, (i + hop) % j] = adj[(i + hop) % j, i] = True
        added += 2
        hop *= 2
    np.fill_diagonal(adj, False)
    return Graph(j, adj, "expander")


def build_graph(name: str, j: int, **kw) -> Graph:
    if name == "complete":
        return complete_graph(j)
    if name == "ring":
        return ring_graph(j)
    if name == "cluster":
        return cluster_graph(j)
    if name == "star":
        return star_graph(j)
    if name == "chain":
        return chain_graph(j)
    if name == "torus":
        rows = kw.get("rows") or int(np.sqrt(j))
        if j % rows:
            raise ValueError(f"torus: J={j} not divisible by rows={rows}")
        return torus_graph(rows, j // rows)
    if name == "expander":
        return expander_graph(j, degree=kw.get("degree", 4))
    raise ValueError(f"unknown topology {name!r}; options: {TOPOLOGIES}")


def connected_components(adj: np.ndarray) -> list[list[int]]:
    """Connected components of a boolean adjacency (sorted node lists)."""
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    seen = np.zeros(n, dtype=bool)
    comps: list[list[int]] = []
    for s in range(n):
        if seen[s]:
            continue
        comp = [s]
        seen[s] = True
        frontier = [s]
        while frontier:
            i = frontier.pop()
            for j in np.nonzero(adj[i])[0]:
                if not seen[j]:
                    seen[j] = True
                    comp.append(int(j))
                    frontier.append(int(j))
        comps.append(sorted(comp))
    return comps


def drop_node(g: Graph, node: int) -> Graph:
    """Elastic-rescale helper: remove a failed node, keep the graph connected.

    If removal disconnects the graph, repair with a spanning chain over the
    resulting components (one bridge edge per adjacent component pair),
    choosing each bridge endpoint among the dropped node's former neighbors
    when possible. ``Graph.__post_init__`` asserts the result connected.
    """
    keep = [i for i in range(g.num_nodes) if i != node]
    adj = g.adj[np.ix_(keep, keep)].copy()
    if len(keep) > 1:
        comps = connected_components(adj)
        if len(comps) > 1:
            old_nbrs = {keep.index(i) for i in g.neighbors(node)
                        if i != node}
            # one representative per component, preferring former neighbors
            reps = [min(set(c) & old_nbrs) if set(c) & old_nbrs else c[0]
                    for c in comps]
            for a, b in zip(reps[:-1], reps[1:]):
                adj[a, b] = adj[b, a] = True
    return Graph(len(keep), adj, g.name)
