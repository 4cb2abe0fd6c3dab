"""Inputs of one fused consensus round, shared by the CPU parity tests and
the card's tests (this module imports no JAX, so it also runs on a machine
without it)."""
import numpy as np
import torch

NAMES = ("theta", "lam", "bar", "r_sq", "s_sq")
ARGS = ("theta", "lam", "barp", "wires", "scales", "e_sym", "alpha",
        "eta_sum", "eta_node")


def round_case(rng, *, j, deg, nleaves, bs):
    """The reference's ``tests/test_kernels.py::_round_case`` generator."""
    sizes = [int(rng.integers(1, 4 * bs)) for _ in range(nleaves)]
    padded = [-(-s // bs) * bs for s in sizes]
    total = sum(padded)
    block_leaf, pieces = [], []
    for li, (s, p) in enumerate(zip(sizes, padded)):
        block_leaf += [li] * (p // bs)
        seg = np.zeros((j, p), np.float32)
        seg[:, :s] = rng.normal(size=(j, s))
        pieces.append(seg)
    theta = np.concatenate(pieces, axis=1)
    lam = rng.normal(size=(j, total)).astype(np.float32)
    barp = rng.normal(size=(j, total)).astype(np.float32)
    wires = rng.integers(-127, 128, size=(deg, j, total)).astype(np.int8)
    scales = rng.uniform(1e-3, 0.1, size=(deg, j, nleaves)).astype(np.float32)
    e_sym = rng.uniform(0.1, 3.0, size=(deg, j)).astype(np.float32)
    eta_sum = e_sym.sum(axis=0)
    alpha = (0.5 / (1.0 + 2.0 * eta_sum)).astype(np.float32)
    eta_node = (eta_sum / deg).astype(np.float32)
    return dict(theta=theta, lam=lam, barp=barp, wires=wires, scales=scales,
                e_sym=e_sym, alpha=alpha, eta_sum=eta_sum, eta_node=eta_node,
                block_leaf=np.asarray(block_leaf, np.int32))


def torch_args(case):
    out = []
    for k in ARGS:
        a = np.ascontiguousarray(case[k])
        if a.dtype.name == "bfloat16":      # same bits through int16
            out.append(torch.from_numpy(a.view(np.int16).copy())
                       .view(torch.bfloat16))
        else:
            out.append(torch.from_numpy(a))
    return out
