"""The port's fused consensus round against the reference.

On the CPU ``repro_torch.kernels.ops.consensus_round`` runs its plain
PyTorch version; it is held against the reference oracle
(``repro.kernels.ref.consensus_round_ref``) and the Pallas kernel in
interpret mode (``repro.kernels.ops.consensus_round``) on the same
numpy-seeded inputs. The CUDA kernel itself is held against the plain
version on the card in ``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: rtol 1e-5 / atol 1e-5 in float32, as the reference's own kernel
test uses (the block partial sums are taken in another order); for a bf16
theta, theta' within one bf16 ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from torch_round_cases import ARGS, NAMES, round_case, torch_args


def _reference(case, bs, which):
    args = [jnp.asarray(case[k]) for k in ARGS]
    if which == "oracle":
        out = jref.consensus_round_ref(*args, block_leaf=case["block_leaf"],
                                       block_size=bs)
    else:                                   # Pallas, interpret mode
        out = jops.consensus_round(*args, block_leaf=tuple(
            case["block_leaf"].tolist()), block_size=bs)
    return [np.asarray(x, dtype=np.float32) for x in out]


def _port(case, bs):
    out = ops.consensus_round(*torch_args(case),
                              block_leaf=case["block_leaf"], block_size=bs)
    return [x.float().numpy() for x in out]


@pytest.mark.parametrize("which", ["oracle", "pallas"])
@pytest.mark.parametrize("j,deg,nleaves,bs", [
    (2, 1, 3, 128), (4, 2, 5, 64), (3, 3, 1, 256),
])
def test_round_int8_wire_matches_reference(j, deg, nleaves, bs, which):
    case = round_case(np.random.default_rng(11), j=j, deg=deg,
                       nleaves=nleaves, bs=bs)
    launches = ops.consensus_round.launches
    for a, b, name in zip(_port(case, bs), _reference(case, bs, which),
                          NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
    # the CPU path is the plain version: no kernel launch is counted
    assert ops.consensus_round.launches == launches


@pytest.mark.parametrize("which", ["oracle", "pallas"])
def test_round_float_wire_unit_scales_matches_reference(which):
    rng = np.random.default_rng(23)
    case = round_case(rng, j=3, deg=2, nleaves=3, bs=64)
    case["wires"] = rng.normal(size=case["wires"].shape).astype(np.float32)
    case["scales"] = np.ones_like(case["scales"])
    for a, b, name in zip(_port(case, 64), _reference(case, 64, which),
                          NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)             # bf16: 8 significand bits


@pytest.mark.parametrize("which", ["oracle", "pallas"])
def test_round_bf16_theta_matches_reference(which):
    """bf16 theta with a bf16 (native) wire, as the trainer runs it."""
    rng = np.random.default_rng(5)
    case = round_case(rng, j=2, deg=1, nleaves=4, bs=128)
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))
    case["theta"] = bf(case["theta"])
    case["wires"] = bf(rng.normal(size=case["wires"].shape))
    case["scales"] = np.ones_like(case["scales"])
    port = ops.consensus_round(*torch_args(case),
                               block_leaf=case["block_leaf"], block_size=128)
    assert port[0].dtype == torch.bfloat16
    refd = _reference(case, 128, which)
    got = port[0].float().numpy()
    assert np.all(np.abs(got - refd[0]) <= _bf16_ulp(refd[0])), "theta"
    for a, b, name in zip(port[1:], refd[1:], NAMES[1:]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
