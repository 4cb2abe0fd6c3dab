"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card. The module
imports no JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: rtol 1e-5 / atol 1e-5 in float32 (the block partial sums are
taken in another order). The edge-gated kernel's theta', lam' and bar equal
the plain version's bit for bit (both round after every multiply and add,
over the offsets in the same order); its r^2 and s^2 hold to rtol 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from torch_round_cases import (NAMES, masked_round_case, masked_torch_args,
                               round_case, torch_args)


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


@pytest.mark.cuda
@pytest.mark.parametrize("kick", [False, True])
@pytest.mark.parametrize("theta_dtype,wire", [
    ("float32", "int8"), ("float32", "native"), ("bfloat16", "native"),
    ("bfloat16", "int8")])
def test_cuda_masked_kernel_matches_plain_version(theta_dtype, wire, kick):
    """The edge-gated kernel (ghost row, dead offset, kicks on gated
    edges) against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    case = masked_round_case(np.random.default_rng(17), j=4, deg=3,
                             nleaves=5, bs=64, wire=wire,
                             theta_dtype=theta_dtype, kick=kick)
    dev = torch.device("cuda")
    args, kw = masked_torch_args(case, dev)
    bl = torch.from_numpy(case["block_leaf"]).to(dev)
    want = ref.consensus_round_ref(*args, block_leaf=bl, block_size=64, **kw)
    before = (ops.consensus_round.launches,
              ops.consensus_round.masked_launches)
    got = ops.consensus_round(*[a.clone() for a in args[:3]], *args[3:],
                              block_leaf=bl, block_size=64, **kw)
    torch.cuda.synchronize()
    assert (ops.consensus_round.launches,
            ops.consensus_round.masked_launches) == (before[0],
                                                     before[1] + 1)
    for a, b, name in zip(got[:3], want[:3], NAMES):
        assert torch.equal(a, b), name
    for a, b, name in zip(got[3:], want[3:], NAMES[3:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("drop", ["inv_deg", "bar_w"])
def test_cuda_masked_kernel_refuses_partial_gates(drop):
    """kick_w without bar_w, and bar_w without inv_deg, are refused before
    anything is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    case = masked_round_case(np.random.default_rng(2), j=3, deg=2,
                             nleaves=2, bs=64)
    args, kw = masked_torch_args(case, torch.device("cuda"))
    bl = torch.from_numpy(case["block_leaf"]).cuda()
    kw.pop(drop)
    if drop == "bar_w":
        kw.pop("inv_deg")
    before = ops.consensus_round.masked_launches
    with pytest.raises(ValueError, match="travel together|needs the gated"):
        ops.consensus_round(*args, block_leaf=bl, block_size=64, **kw)
    assert ops.consensus_round.masked_launches == before
