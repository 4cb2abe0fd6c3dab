"""Synthetic data generators for the reproduction experiments (the port's
own copy of ``repro/ppca/synth.py``: numpy only, bit-identical arrays).

``subspace_data``  — §5.1: 500 samples, 20-dim observations from a 5-dim
subspace with N(0, I) latents and N(0, 0.2 I) measurement noise, split
evenly across J nodes.

``turntable_sfm``  — §5.2-style distributed affine structure-from-motion:
a rigid 3D point cloud observed by an orthographic turntable camera over F
frames; frames are split evenly across J camera nodes (Fig. 4: 30 frames,
5 cameras). The Caltech/Hopkins images are not available offline, so we
generate matched-dimension synthetic tracks; the claims under test are
relative-convergence claims, which survive the swap (DESIGN.md §7).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SubspaceData(NamedTuple):
    x: np.ndarray        # [J, N_i, D]  per-node observations
    W_true: np.ndarray   # [D, M]       generating subspace
    x_all: np.ndarray    # [N, D]       pooled (for the centralized baseline)


def subspace_data(num_nodes: int, *, n: int = 500, d: int = 20, m: int = 5,
                  noise_std: float = np.sqrt(0.2), seed: int = 0
                  ) -> SubspaceData:
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(d, m))
    z = rng.normal(size=(n, m))
    x = z @ W.T + noise_std * rng.normal(size=(n, d))
    n_i = n // num_nodes
    x_nodes = x[: n_i * num_nodes].reshape(num_nodes, n_i, d)
    return SubspaceData(x=x_nodes.astype(np.float64),
                        W_true=W.astype(np.float64),
                        x_all=x.astype(np.float64))


class SfMData(NamedTuple):
    measurements: np.ndarray  # [2F, N] stacked affine image measurements
    x_nodes: np.ndarray       # [J, 2F_i, N] per-camera rows (transposed PPCA
                              #   layout: samples = frame-rows, dim = points)
    structure: np.ndarray     # [N, 3] ground-truth 3D points
    motion: np.ndarray        # [2F, 3] ground-truth affine motion


def turntable_sfm(num_cameras: int = 5, *, frames: int = 30, points: int = 90,
                  noise_std: float = 0.01, seed: int = 0) -> SfMData:
    """Orthographic turntable: object rotates about the vertical axis.

    Per Yoon & Pavlovic's SfM setup we run PPCA on the *transposed*
    measurement matrix: each camera's samples are its own 2*F_i frame-rows
    (dimension = N points), so the consensus parameter W in R^{N x 3} *is*
    the reconstructed 3D structure — matching the paper's metric, the
    subspace angle of the reconstructed structure vs. centralized SVD.
    """
    rng = np.random.default_rng(seed)
    # rigid object: random cloud in a unit box, non-degenerate
    s3d = rng.uniform(-1.0, 1.0, size=(points, 3))
    angles = np.linspace(0.0, 2.0 * np.pi * (frames - 1) / frames, frames)
    rows = []
    for ang in angles:
        c, s = np.cos(ang), np.sin(ang)
        rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        proj = rot[:2]                      # orthographic: keep x, y rows
        rows.append(proj)
    motion = np.concatenate(rows, axis=0)                     # [2F, 3]
    meas = motion @ s3d.T                                     # [2F, N]
    meas = meas + noise_std * rng.normal(size=meas.shape)
    f_i = frames // num_cameras
    x_nodes = np.stack([meas[2 * f_i * i: 2 * f_i * (i + 1)]
                        for i in range(num_cameras)])         # [J, 2F_i, N]
    return SfMData(measurements=meas.astype(np.float64),
                   x_nodes=x_nodes.astype(np.float64),
                   structure=s3d.astype(np.float64),
                   motion=motion.astype(np.float64))
