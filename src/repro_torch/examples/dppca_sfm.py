"""Distributed structure-from-motion with D-PPCA + ADMM-NAP, paper §5.2
(port of ``examples/dppca_sfm.py``).

Five cameras on a turntable scene reach consensus on the 3D structure
without ever pooling their measurements. Compares the fixed-penalty
baseline against the paper's NAP schedule, in float64 as the reference
example runs.

Run:  PYTHONPATH=src python -m repro_torch.examples.dppca_sfm --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import PenaltyConfig, build_graph
from repro_torch.device import resolve_device
from repro_torch.ppca import DPPCA, fit_svd, max_subspace_angle, turntable_sfm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--max-iters", type=int, default=400)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sfm = turntable_sfm(num_cameras=5, frames=30, points=90, seed=0)
    x = torch.as_tensor(sfm.x_nodes, device=device)  # [5 cams, 2F_i, N]
    ref = fit_svd(torch.as_tensor(sfm.measurements, device=device), 3)
    print(f"scene: {sfm.structure.shape[0]} points, 30 frames, 5 cameras "
          f"(transposed PPCA layout: consensus W == 3D structure)")

    for topo in ("ring", "complete"):
        graph = build_graph(topo, 5)
        for scheme in ("fixed", "nap"):
            eng = DPPCA(latent_dim=3, graph=graph,
                        penalty_cfg=PenaltyConfig(scheme=scheme, eta0=10.0))
            st = eng.init(x, torch.Generator().manual_seed(0))
            st, hist = eng.run(st, x, max_iters=args.max_iters,
                               rel_tol=1e-5, min_iters=10)
            ang = float(max_subspace_angle(st.W, ref.W))
            print(f"  {topo:9s} {scheme:6s}: {hist['iterations']:4d} iters, "
                  f"structure angle vs centralized SVD = {ang:5.2f} deg")


if __name__ == "__main__":
    main()
