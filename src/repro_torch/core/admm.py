"""Generic consensus-ADMM engine over parameter trees, all nodes stacked on
a leading axis (port of ``repro/core/admm.py``).

Solves  min_theta  sum_i f_i(theta_i)  s.t. theta_i = rho_ij, rho_ij = theta_j
on a graph, with any of the six penalty schedules of the paper, in the
fully-decentralized form in which the edge auxiliaries are eliminated
(rho_ij = (theta_i + theta_j)/2) and each node keeps one multiplier lam_i.
One outer iteration (paper Algorithm 1, the PPCA specifics abstracted away):

  1. theta_i^{t+1} = argmin_th  f_i(th) + 2 <lam_i, th>
                       + sum_{j in B_i} eta_ij^t ||th - (theta_i^t+theta_j^t)/2||^2
  2. broadcast theta_i^{t+1} to neighbors
  3. lam_i^{t+1} = lam_i^t + 1/2 sum_j eta_ij^t (theta_i^{t+1} - theta_j^{t+1})
  4. update eta_ij (and budget T_ij) per the configured scheme

The argmin in (1) is a ``local_solver`` (closed form, for quadratic losses)
or K steps of steepest descent with an exact line search, vmapped over the
nodes with ``torch.func``. The line search's Hessian-vector product is the
vjp of the gradient where the reference takes its jvp (the same product,
H being symmetric): in ``torch.func`` forward mode over the gradient costs
5-7x the host time of reverse mode, and the vjp returns the gradient too. The user's ``objective(data_i, theta_i)`` is
written in torch ops for one node; ``data`` and ``theta`` are trees whose
leaves carry the node axis.

Dtypes follow the reference's promotion: the penalty state, the degree
compensation and the residual norms are float32 whatever theta's dtype,
and a product of a float32 weight matrix with float64 parameters is taken
in float64 (``torch.matmul`` does not promote, so ``_mm`` casts).
``step`` runs eagerly, except that on the card the gradient inner solver
replays a CUDA graph of its own eager kernels (``_solve_graphed``); ``run``
reads the device once per iteration.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch
from torch.func import grad, vjp, vmap
from torch.utils import _pytree as pytree

from repro_torch import tree as tree_lib
from repro_torch.core import residuals as res_lib
from repro_torch.core.graph import Graph
from repro_torch.core.penalty import (PenaltyConfig, PenaltyState,
                                      init_penalty_state, update_penalty)

Tree = Any
# f(data_i, theta_i) -> scalar local objective for one node (unbatched).
ObjectiveFn = Callable[[Tree, Tree], torch.Tensor]
# local_solver(data, theta, lam, eta_eff, adj) -> new theta (all nodes).
LocalSolver = Callable[..., Tree]


class ConsensusState(NamedTuple):
    theta: Tree            # leaves [J, ...]: per-node parameter estimates
    lam: Tree              # leaves [J, ...]: per-node multipliers lam_i
    theta_bar: Tree        # leaves [J, ...]: previous neighbor average
    penalty: PenaltyState
    t: torch.Tensor        # [] int32
    topo: Any = None       # TopologyState when a topology_cfg is configured


def _mm(w: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """``w @ flat`` in the promoted dtype, as ``jnp.matmul`` computes it."""
    dt = torch.promote_types(w.dtype, flat.dtype)
    return w.to(dt) @ flat.to(dt)


def _laplacian(w: torch.Tensor, wsum: torch.Tensor,
               leaf: torch.Tensor) -> torch.Tensor:
    """sum_j w_ij (theta_i - theta_j) per node, for one [J, ...] leaf."""
    flat = leaf.reshape(leaf.shape[0], -1)
    return (wsum[:, None] * flat - _mm(w, flat)).reshape(leaf.shape)


def _dot(a: Tree, b: Tree) -> torch.Tensor:
    return sum((x * y).sum() for x, y in zip(tree_lib.leaves(a),
                                             tree_lib.leaves(b)))


@dataclasses.dataclass(frozen=True, eq=False)
class ConsensusADMM:
    """Configurable consensus-ADMM driver.

    Attributes:
      objective: local objective f_i (same fn for all nodes; data differs).
      penalty_cfg: which of the six schedules to run.
      graph: static communication graph.
      inner_steps / inner_lr: gradient inner solver settings (used when no
        closed-form ``local_solver`` is supplied).
      probe_midpoint: evaluate kappa at rho_ij=(theta_i+theta_j)/2 (the
        paper's locality remark in §3.2) instead of at theta_j directly.
      degree_normalize: scale each edge's applied penalty by
        (J-1)/sqrt(deg_i deg_j), so a node's total consensus pull matches
        the complete graph's regardless of topology (complete graphs are
        unchanged). Symmetric, so the sum_i lam_i = 0 dual invariant
        survives. False gives the paper's literal weighting.
      topology_cfg: optional ``repro_torch.topology.TopologyConfig``: runs
        the dynamic-topology schedulers on the dense path; the edge mask
        replaces the static adjacency everywhere in the step.
    """

    objective: ObjectiveFn
    penalty_cfg: PenaltyConfig
    graph: Graph
    inner_steps: int = 10
    inner_lr: float = 0.05
    probe_midpoint: bool = False
    local_solver: LocalSolver | None = None
    degree_normalize: bool = True
    topology_cfg: Any = None

    def __post_init__(self):
        if self.topology_cfg is not None:
            self.topology_cfg.validate_penalty(self.penalty_cfg)

    @cached_property
    def _topo_rt(self):
        """TopologyRuntime, or None without a topology_cfg. The dense path
        has no permute schedule, so churn repair may draw from any node
        pair."""
        if self.topology_cfg is None:
            return None
        from repro_torch.topology import TopologyRuntime
        j = self.graph.num_nodes
        return TopologyRuntime(self.graph, self.topology_cfg,
                               edge_universe=~np.eye(j, dtype=bool))

    @cached_property
    def _edge_scale(self) -> np.ndarray:
        """[J, J] float32 symmetric degree-compensation factors (ones when
        off)."""
        j = self.graph.num_nodes
        if not self.degree_normalize or j <= 1:
            return np.ones((j, j), np.float32)
        deg = np.maximum(self.graph.degrees.astype(np.float64), 1.0)
        return ((j - 1) / np.sqrt(deg[:, None] * deg[None, :])).astype(
            np.float32)

    @cached_property
    def _consts(self) -> dict:
        return {}

    def _device_consts(self, device: torch.device):
        """(static adjacency, edge scale) on ``device``, made once."""
        c = self._consts.get(device)
        if c is None:
            c = self._consts[device] = (
                torch.as_tensor(self.graph.adj, device=device),
                torch.as_tensor(self._edge_scale, device=device))
        return c

    # -- initialization --------------------------------------------------------
    def init(self, theta0: Tree) -> ConsensusState:
        """theta0: tree with leading node axis [J, ...] on every leaf; the
        state lies on its device."""
        j = self.graph.num_nodes
        leaves = tree_lib.leaves(theta0)
        if not all(leaf.shape[0] == j for leaf in leaves):
            raise ValueError(f"every leaf must have leading node axis {j}")
        device = leaves[0].device
        adj, _ = self._device_consts(device)
        return ConsensusState(
            theta=theta0, lam=tree_lib.tree_map(torch.zeros_like, theta0),
            theta_bar=res_lib.neighbor_mean(theta0, adj),
            penalty=init_penalty_state(self.penalty_cfg, j, device=device),
            t=torch.zeros((), dtype=torch.int32, device=device),
            topo=(None if self._topo_rt is None
                  else self._topo_rt.init_state(device)))

    # -- inner solvers ----------------------------------------------------------
    def _solve_gradient(self, data, theta, lam, eta, adj):
        """K steps of steepest descent on each node's augmented objective,
        vmapped over the nodes."""
        w = eta * adj.to(torch.float32)            # [J, J]
        wsum = res_lib.row_sums(w)                 # [J]

        # the eta-weighted neighbor pull, constant during the solve:
        #   sum_j eta_ij (theta_i^t + theta_j^t)/2
        def pull_leaf(leaf):
            flat = leaf.reshape(leaf.shape[0], -1)
            return (0.5 * (_mm(w, flat) + wsum[:, None] * flat)).reshape(
                leaf.shape)

        pull = tree_lib.tree_map(pull_leaf, theta)
        objective, inner_lr = self.objective, self.inner_lr

        def one_node(data_i, th0, lam_i, pull_i, wsum_i):
            def aug(th):
                # sum_j eta ||th - mid||^2 = wsum ||th||^2 - 2 <th, pull> + c
                quad = 0.0
                for th_l, p_l in zip(tree_lib.leaves(th),
                                     tree_lib.leaves(pull_i)):
                    quad = quad + wsum_i * th_l.square().sum() \
                        - 2.0 * (th_l * p_l).sum()
                return objective(data_i, th) + 2.0 * _dot(lam_i, th) + quad

            g = grad(aug)
            th = th0
            for _ in range(self.inner_steps):
                # exact line search along -g with a Hessian-vector product:
                # step* = <g,g> / <g, H g>, exact for quadratic objectives.
                # H is symmetric, so H g is the vjp of the gradient, which
                # also returns g itself
                gr, hvp = vjp(g, th)
                hg, = hvp(gr)
                gg = _dot(gr, gr)
                # the consensus term guarantees curvature >= 2 wsum; fall
                # back to it where f_i is locally concave
                safe = torch.maximum(_dot(gr, hg), 2.0 * wsum_i * gg + 1e-12)
                lr = inner_lr * gg / (safe + 1e-30)
                th = tree_lib.tree_map(lambda a, b: a - lr * b, th, gr)
            return th

        return vmap(one_node)(data, theta, lam, pull, wsum)

    @cached_property
    def _graphs(self) -> dict:
        return {}

    def _solve_graphed(self, data, theta, lam, eta, adj):
        """``_solve_gradient`` on the card, replayed from a CUDA graph of
        its own eager kernels (the same kernels, so the same bits).

        Eagerly the vmapped grad/vjp loop is some 2,000 small launches per
        call and the host, not the card, sets its time. The graph is
        captured once per data tensors and shapes (one graph at a time: it
        pins the data), with theta, lam, eta and adj copied into its
        inputs at every call; ``objective`` must not synchronize with the
        host.
        """
        args = (theta, lam, {"eta": eta, "adj": adj})
        key = (tuple((t.data_ptr(), t.shape, t.dtype)
                     for t in pytree.tree_leaves(data)),
               tuple((t.shape, t.dtype) for a in args
                     for t in tree_lib.leaves(a)))
        rec = self._graphs.get(key)
        if rec is None:
            self._graphs.clear()
            static = tuple(tree_lib.tree_map(torch.clone, a) for a in args)

            def solve():
                return self._solve_gradient(data, static[0], static[1],
                                            static[2]["eta"],
                                            static[2]["adj"])

            side = torch.cuda.Stream(eta.device)
            side.wait_stream(torch.cuda.current_stream(eta.device))
            with torch.cuda.stream(side):         # warm up off the graph
                solve()
            torch.cuda.current_stream(eta.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = solve()
            rec = self._graphs[key] = (graph, static, out)
        graph, static, out = rec
        for a, s in zip(args, static):
            tree_lib.tree_map(lambda dst, src: dst.copy_(src), s, a)
        graph.replay()
        return tree_lib.tree_map(torch.clone, out)

    # -- churn -----------------------------------------------------------------
    def apply_churn(self, state: ConsensusState, victim: int
                    ) -> ConsensusState:
        """Host-side layout-preserving node drop: ghosts the victim in the
        topology state (shapes survive; the runtime rewires the survivors
        and checks that they stay connected). Needs a ``topology_cfg``."""
        if self._topo_rt is None:
            raise ValueError("node churn needs a topology_cfg")
        return state._replace(topo=self._topo_rt.drop_node(state.topo,
                                                           victim))

    # -- one outer iteration ----------------------------------------------------
    def step(self, state: ConsensusState, data: Tree
             ) -> tuple[ConsensusState, dict]:
        """data: tree with leading node axis [J, ...] (local observations)."""
        adj_static, edge_scale = self._device_consts(state.penalty.eta.device)
        # dynamic topology: the mask IS the adjacency this round
        adj = state.topo.mask if state.topo is not None else adj_static
        eta = state.penalty.eta
        # degree compensation applies where eta is consumed; the schedule
        # keeps adapting the raw eta around eta0
        eta_eff = eta * edge_scale

        # (1) local argmin
        solve = self.local_solver or (
            self._solve_graphed if eta.device.type == "cuda"
            else self._solve_gradient)
        theta_new = solve(data, state.theta, state.lam, eta_eff, adj)

        # (2)+(3) exchange and dual update with the SYMMETRIZED penalty:
        # directed eta would break the sum_i lam_i = 0 invariant
        w = 0.5 * (eta_eff + eta_eff.T) * adj.to(eta.dtype)
        wsum = res_lib.row_sums(w)
        lam_new = tree_lib.tree_map(
            lambda lam, th: lam + 0.5 * _laplacian(w, wsum, th).to(lam.dtype),
            state.lam, theta_new)

        # (eq. 5) local residuals, with the applied (scaled) penalties
        rr = res_lib.local_residuals(theta_new, state.theta_bar, adj,
                                     res_lib.node_eta(eta_eff, adj))

        # objective probes for the AP/NAP-family schedules: F[i, j] =
        # f_i(theta_j); the inner vmap batches node i's data against every
        # theta_j, so one pass over data_i serves all neighbors
        pcfg = self.penalty_cfg
        f_self = vmap(self.objective)(data, theta_new)
        f_nbr = None
        if pcfg.uses_objective_probes:
            def probe(data_i, th_i, th_all):
                def at_j(th_j):
                    pt = tree_lib.tree_map(lambda a, b: 0.5 * (a + b), th_i,
                                           th_j) \
                        if self.probe_midpoint else th_j
                    return self.objective(data_i, pt)
                return vmap(at_j)(th_all)

            f_nbr = vmap(probe, in_dims=(0, 0, None))(data, theta_new,
                                                      theta_new)

        if state.topo is not None:
            # gated GRAPH edges keep adapting (the eq. 10 top-up must see
            # them to revive); ghost rows and columns never do
            alive = state.topo.node_alive
            adj_pen = (adj_static & alive[:, None] & alive[None, :]) | adj
        else:
            adj_pen = adj_static
        penalty_new = update_penalty(
            pcfg, state.penalty, adj=adj_pen, f_self=f_self, f_nbr=f_nbr,
            r_norm=rr.r_norm, s_norm=rr.s_norm)

        topo_new = state.topo
        if state.topo is not None:
            topo_new = self._topo_rt.update(state.topo, penalty=penalty_new,
                                            r_norm=rr.r_norm)
            # zero-kick gating: absorb each newly gated edge's last
            # consensus force into the dual (one dual-ascent step on those
            # edges only), so removing the edge leaves every node's
            # augmented stationarity unchanged at the current iterate.
            # Antisymmetric per edge pair: sum_i lam_i = 0 survives.
            newly_off = (state.topo.mask & ~topo_new.mask).to(w.dtype)
            w_off = w * newly_off
            woff_sum = res_lib.row_sums(w_off)
            lam_new = tree_lib.tree_map(
                lambda lam, th: lam + 0.5 * _laplacian(
                    w_off, woff_sum, th).to(lam.dtype),
                lam_new, theta_new)

        new_state = ConsensusState(theta=theta_new, lam=lam_new,
                                   theta_bar=rr.theta_bar,
                                   penalty=penalty_new, t=state.t + 1,
                                   topo=topo_new)
        inf = torch.tensor(float("inf"), dtype=penalty_new.eta.dtype,
                           device=adj.device)
        metrics = {
            "objective": f_self.sum(),
            "r_norm": rr.r_norm,
            "s_norm": rr.s_norm,
            "eta_mean": res_lib.node_eta(penalty_new.eta, adj).mean(),
            "eta_min": torch.where(adj, penalty_new.eta, inf).min(),
            "eta_max": torch.where(adj, penalty_new.eta, -inf).max(),
        }
        if state.topo is not None:
            from repro_torch.topology import active_edge_fraction
            metrics["active_edges"] = active_edge_fraction(state.topo,
                                                           adj_static)
        return new_state, metrics

    # -- convergence-driven run -------------------------------------------------
    def run(self, state: ConsensusState, data: Tree, *, max_iters: int,
            rel_tol: float = 1e-3) -> tuple[ConsensusState, dict]:
        """Python-loop driver with the paper's relative-change criterion
        (§5); one read of the device per iteration.

        Returns the final state and a history dict (objective trace,
        iterations).
        """
        hist = {"objective": [], "r_norm": [], "eta_mean": []}
        prev_obj = None
        iters = max_iters
        for it in range(max_iters):
            state, m = self.step(state, data)
            obj, r_max, eta_mean = torch.stack([
                m["objective"].double(), m["r_norm"].max().double(),
                m["eta_mean"].double()]).tolist()
            hist["objective"].append(obj)
            hist["r_norm"].append(r_max)
            hist["eta_mean"].append(eta_mean)
            if prev_obj is not None:
                rel = abs(obj - prev_obj) / (abs(prev_obj) + 1e-12)
                if rel < rel_tol:
                    iters = it + 1
                    break
            prev_obj = obj
        hist["iterations"] = iters
        return state, hist


def consensus_error(theta: Tree) -> torch.Tensor:
    """Max pairwise L2 disagreement across nodes (float32): a convergence
    diagnostic."""
    errs = []
    for leaf in tree_lib.leaves(theta):
        flat = leaf.reshape(leaf.shape[0], -1).to(torch.float32)
        mean = flat.mean(dim=0, keepdim=True)
        errs.append(torch.linalg.vector_norm(flat - mean, dim=1).max())
    return torch.stack(errs).max()


def state_from_numpy(np_state: Mapping[str, np.ndarray],
                     device: torch.device | str) -> ConsensusState:
    """The reference's ``ConsensusState`` flattened to numpy -> the port's
    state on ``device``.

    Keys join a field and a leaf's path with ``/``: ``theta/w``,
    ``lam/w``, ``theta_bar/w`` (``theta`` alone for a bare-array theta),
    ``penalty/<PenaltyState field>``, ``t``, and ``topo/<TopologyState
    field>`` when the run has a topology. Dtypes are kept.
    """
    from repro_torch.topology import from_numpy as topo_from_numpy

    def conv(v):
        return torch.as_tensor(np.array(v, copy=True), device=device)

    fields = {name: tree_lib.from_flat(np_state, name, conv)
              for name in ("theta", "lam", "theta_bar")}
    penalty = PenaltyState(*(conv(np_state[f"penalty/{f}"])
                             for f in PenaltyState._fields))
    topo = None
    if any(k.startswith("topo/") for k in np_state):
        topo = topo_from_numpy({k[5:]: v for k, v in np_state.items()
                                if k.startswith("topo/")}, device)
    return ConsensusState(**fields, penalty=penalty, t=conv(np_state["t"]),
                          topo=topo)
