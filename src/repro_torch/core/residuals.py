"""Local primal/dual residuals for fully-decentralized ADMM, paper eq. 5
(port of ``repro/core/residuals.py``).

    ||r_i||^2 = ||theta_i - theta_bar_i||^2
    ||s_i||^2 = eta_i^2 ||theta_bar_i - theta_bar_i^{t-1}||^2
    theta_bar_i = (1/|B_i|) sum_{j in B_i} theta_j

Unlike the global residuals of Boyd et al. used by He-Yang-Wang (eq. 4), these
are computable at node i from one neighbor exchange, which is what makes the
VP schedule fully decentralized (§3.1).

Parameters are nested-dict trees (``repro_torch.tree``) or bare tensors with
a leading node axis ``[J, ...]`` on every leaf. ``adj`` may be a
dynamic-topology mask instead of the static adjacency. A row with no active
edges (a gated-out or ghost node) gets theta_bar = 0 (the degree clamps to
1), so its "residual" equals its parameter norm.

The neighbor mean and both norms are rounded to float32 whatever the
leaves' dtype, as the reference's are: in a float64 run theta_bar carries
float32-rounded values and r_norm / s_norm are float32, and the VP schemes'
ratio tests read them so. Each is accumulated in float64 from the float32
values and rounded once, where the reference sums in float32: the float32
sums of cuBLAS, MKL and XLA each round in their own order, and near
consensus one ulp of theta_bar is a large part of a residual, enough to
flip a VP decision between a run on the card and one on the CPU.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as tree_lib


class Residuals(NamedTuple):
    r_norm: torch.Tensor     # [J]  primal residual norm per node
    s_norm: torch.Tensor     # [J]  dual residual norm per node
    theta_bar: Any           # [J, ...] tree: neighbor average, for t+1


def _f32_in_f64(leaf: torch.Tensor) -> torch.Tensor:
    """The leaf rounded to float32, held in float64, one row per node."""
    return leaf.reshape(leaf.shape[0], -1).to(torch.float32).to(
        torch.float64)


def _tree_sq_norm_per_node(tree: Any) -> torch.Tensor:
    """Sum of squares of the float32-rounded leaves, keeping the node axis,
    rounded to float32."""
    total = None
    for leaf in tree_lib.leaves(tree):
        sq = _f32_in_f64(leaf).square().sum(dim=1)
        total = sq if total is None else total + sq
    if total is None:
        raise ValueError("empty tree")
    return total.to(torch.float32)


def neighbor_mean(theta: Any, adj: torch.Tensor) -> Any:
    """theta_bar_i = mean_{j in B_i} theta_j per leaf, rounded to float32
    and cast back to the leaf's dtype. theta leaves: [J, ...]."""
    adj_d = adj.to(torch.float64)
    deg = torch.clamp_min(adj_d.sum(dim=1), 1.0)        # [J]

    def per_leaf(leaf):
        bar = (adj_d @ _f32_in_f64(leaf)) / deg[:, None]
        return bar.to(torch.float32).reshape(leaf.shape).to(leaf.dtype)

    return tree_lib.tree_map(per_leaf, theta)


def local_residuals(theta: Any, theta_bar_prev: Any, adj: torch.Tensor,
                    eta_node: torch.Tensor) -> Residuals:
    """eq. (5) for all nodes at once.

    Args:
      theta: tree with leading node axis [J, ...] on every leaf.
      theta_bar_prev: same structure: theta_bar of the previous iteration.
      adj: [J, J] bool adjacency (or mask).
      eta_node: [J] per-node penalty entering the dual residual (for
        edge-based schemes the mean eta over the node's edges).
    """
    theta_bar = neighbor_mean(theta, adj)
    diff_primal = tree_lib.tree_map(lambda a, b: a - b, theta, theta_bar)
    diff_dual = tree_lib.tree_map(lambda a, b: a - b, theta_bar,
                                  theta_bar_prev)
    r = torch.sqrt(_tree_sq_norm_per_node(diff_primal))
    s = eta_node.to(torch.float32) * torch.sqrt(
        _tree_sq_norm_per_node(diff_dual))
    return Residuals(r_norm=r, s_norm=s, theta_bar=theta_bar)


def row_sums(w: torch.Tensor) -> torch.Tensor:
    """Each row's sum of a [J, J] matrix, added in column order: the order
    in which XLA reduces a row, so that the float32 sums of per-edge
    weights round as the reference's do."""
    out = w[:, 0]
    for k in range(1, w.shape[1]):
        out = out + w[:, k]
    return out


def node_eta(eta_edges: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Collapse per-edge eta_ij to a per-node eta_i (mean over own edges)."""
    adj_f = adj.to(eta_edges.dtype)
    deg = torch.clamp_min(adj_f.sum(dim=1), 1.0)
    return row_sums(eta_edges * adj_f) / deg
