"""Quickstart: the paper's adaptive-penalty consensus ADMM (port of
``examples/quickstart.py``).

Solves a distributed least-squares problem on 8 nodes with each of the six
penalty schedules, on a complete graph and a ring, and prints
iterations-to-convergence: the paper's headline comparison, on a problem
small enough to eyeball.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (SCHEMES, ConsensusADMM, PenaltyConfig,
                              build_graph, consensus_error)
from repro_torch.device import resolve_device


def lsq_problem(j: int = 8, d: int = 5, n: int = 20, *, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cpu"):
    """The example's data (the reference's numpy draws): ``(A, b)`` on
    ``device``, ``theta0 = {"w": [J, d]}`` and the pooled least-squares
    solution ``w_star``."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(j, n, d)).astype(np.float32)
    w_true = rng.normal(size=d).astype(np.float32)
    b = A @ w_true + 0.05 * rng.normal(size=(j, n)).astype(np.float32)
    w_star = np.linalg.lstsq(A.reshape(-1, d), b.reshape(-1), rcond=None)[0]
    theta0 = rng.normal(size=(j, d)).astype(np.float32)

    def put(a):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return (put(A), put(b)), {"w": put(theta0)}, w_star


def objective(data, theta):
    """f_i(w) = ||A_i w - b_i||^2 for one node."""
    Ai, bi = data
    return (Ai @ theta["w"] - bi).square().sum()


def run_schemes(data, theta0, w_star, *, topologies=("complete", "ring"),
                schemes=SCHEMES, max_iters: int = 400,
                rel_tol: float = 1e-8) -> list[dict]:
    """One ``ConsensusADMM.run`` per topology and scheme; each row holds
    the iterations, max|w - w*|, the consensus error and the final w."""
    j = theta0["w"].shape[0]
    rows = []
    for topo in topologies:
        graph = build_graph(topo, j)
        for scheme in schemes:
            engine = ConsensusADMM(
                objective=objective,
                penalty_cfg=PenaltyConfig(scheme=scheme, eta0=1.0),
                graph=graph, inner_steps=30, inner_lr=1.0)
            state, hist = engine.run(engine.init(theta0), data,
                                     max_iters=max_iters, rel_tol=rel_tol)
            w = state.theta["w"].detach().cpu().double().numpy()
            rows.append({"scheme": scheme, "topology": topo,
                         "iterations": hist["iterations"],
                         "err": float(np.abs(w - w_star).max()),
                         "consensus": float(consensus_error(state.theta)),
                         "w": w})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--max-iters", type=int, default=400)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    data, theta0, w_star = lsq_problem(device=device)
    print(f"{'scheme':10s} {'topology':10s} {'iters':>6s} {'max|w-w*|':>10s} "
          f"{'consensus':>10s}")
    for r in run_schemes(data, theta0, w_star, max_iters=args.max_iters):
        print(f"{r['scheme']:10s} {r['topology']:10s} {r['iterations']:6d} "
              f"{r['err']:10.4f} {r['consensus']:10.5f}")


if __name__ == "__main__":
    main()
