"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card. The module
imports no JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: rtol 1e-5 / atol 1e-5 in float32 (the block partial sums are
taken in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from torch_round_cases import NAMES, round_case, torch_args


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["native", "int8"])
def test_cuda_kernel_matches_plain_version(wire):
    """The CUDA kernel against the plain version on the card (skips
    without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    rng = np.random.default_rng(3)
    case = round_case(rng, j=4, deg=2, nleaves=5, bs=64)
    args = torch_args(case)
    if wire == "native":
        args[3] = torch.from_numpy(
            rng.normal(size=case["wires"].shape).astype(np.float32))
        args[4] = torch.ones_like(args[4])
    dev = torch.device("cuda")
    args = [a.to(dev) for a in args]
    bl = torch.from_numpy(case["block_leaf"]).to(dev)
    want = ref.consensus_round_ref(*args, block_leaf=bl, block_size=64)
    before = ops.consensus_round.launches
    got = ops.consensus_round(*[a.clone() for a in args[:3]], *args[3:],
                              block_leaf=bl, block_size=64)
    torch.cuda.synchronize()
    assert ops.consensus_round.launches == before + 1
    for a, b, name in zip(got, want, NAMES):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
