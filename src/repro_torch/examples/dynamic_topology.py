"""Dynamic topology: edge gating, shedding, and surviving a node loss (port
of ``examples/dynamic_topology.py``).

Three acts on a distributed least-squares problem (12 nodes, expander):

  1. run NAP with the §4 budget scheduler to convergence;
  2. keep iterating past convergence: exhausted edges detach one by one
     (the active-edge fraction falls) while the solution stays put;
  3. kill a node mid-run: the topology runtime ghosts it, rewires the
     survivors, and the run keeps going.

Run:  PYTHONPATH=src python -m repro_torch.examples.dynamic_topology \\
          --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import ConsensusADMM, PenaltyConfig, build_graph
from repro_torch.device import resolve_device
from repro_torch.examples.quickstart import lsq_problem, objective
from repro_torch.topology import TopologyConfig

J = 12
VICTIM = 7


def _err(state, w_star) -> float:
    w = state.theta["w"].detach().cpu().double().numpy()
    return float(np.abs(w - w_star).max())


def three_acts(*, dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cpu", shed_epochs: int = 100,
               churn_epochs: int = 30) -> dict:
    """The three acts; returns what each prints, with the edge mask at
    every print (host arrays)."""
    data, theta0, w_star = lsq_problem(J, dtype=dtype, device=device)
    graph = build_graph("expander", J)
    engine = ConsensusADMM(
        objective=objective,
        penalty_cfg=PenaltyConfig(scheme="nap", eta0=1.0),
        graph=graph, inner_steps=30, inner_lr=1.0,
        topology_cfg=TopologyConfig(scheduler="budget", churn=True))

    # act 1: converge under the paper's §5 criterion
    state, hist = engine.run(engine.init(theta0), data, max_iters=400,
                             rel_tol=1e-3)
    out = {"iterations": hist["iterations"], "err": _err(state, w_star),
           "mask": state.topo.mask.cpu().numpy(), "shed": []}

    # act 2: §4 shedding; exhausted edges detach, the iterate holds
    for epoch in range(0, shed_epochs, 20):
        for _ in range(20):
            state, m = engine.step(state, data)
        out["shed"].append({"epochs": epoch + 20,
                            "active_edges": float(m["active_edges"]),
                            "err": _err(state, w_star),
                            "mask": state.topo.mask.cpu().numpy()})

    # act 3: lose a node; ghosted, rewired, no restart
    state = engine.apply_churn(state, VICTIM)
    for _ in range(churn_epochs):
        state, m = engine.step(state, data)
    alive = state.topo.node_alive.cpu().numpy()
    w = state.theta["w"].detach().cpu().double().numpy()[alive]
    out["churn"] = {"alive": int(alive.sum()),
                    "spread": float(np.abs(w - w.mean(axis=0)).max()),
                    "active_edges": float(m["active_edges"]),
                    "mask": state.topo.mask.cpu().numpy()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--shed-epochs", type=int, default=100)
    ap.add_argument("--churn-epochs", type=int, default=30)
    args = ap.parse_args(argv)
    out = three_acts(device=resolve_device(args.device),
                     shed_epochs=args.shed_epochs,
                     churn_epochs=args.churn_epochs)
    print(f"converged in {out['iterations']} iterations, "
          f"max|w - w*| = {out['err']:.4f}")
    for rec in out["shed"]:
        print(f"  +{rec['epochs']:3d} epochs: active edges "
              f"{rec['active_edges']:.2f}, max|w - w*| = {rec['err']:.4f}")
    c = out["churn"]
    print(f"dropped node {VICTIM}: {c['alive']}/{J} alive, "
          f"survivor consensus spread {c['spread']:.5f}, "
          f"active edges {c['active_edges']:.2f}")


if __name__ == "__main__":
    main()
