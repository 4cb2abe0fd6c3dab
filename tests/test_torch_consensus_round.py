"""The port's fused consensus round against the reference.

On the CPU ``repro_torch.kernels.ops.consensus_round`` runs its plain
PyTorch version; it is held against the reference oracle
(``repro.kernels.ref.consensus_round_ref``) and the Pallas kernel in
interpret mode (``repro.kernels.ops.consensus_round``) on the same
numpy-seeded inputs. The CUDA kernel itself is held against the plain
version on the card in ``test_torch_cuda.py`` and ``chip_smoke.py``.

The reference runs once per module in a fresh process
(``_reference_outputs``, through ``torch_round_cases.run_reference``); its
Pallas kernel runs there in interpret mode, as the reference's own kernel
tests run it on the CPU.

Tolerances: rtol 1e-5 / atol 1e-5 in float32, as the reference's own kernel
test uses (the block partial sums are taken in another order); for a bf16
theta, theta' within one bf16 ulp.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from torch_round_cases import (ARGS, NAMES, bf16_round, round_case,
                               run_reference, torch_args)
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

WHICH = ("oracle", "pallas")
INT8_SHAPES = ((2, 1, 3, 128), (4, 2, 5, 64), (3, 3, 1, 256))


def _int8_case(j, deg, nleaves, bs):
    return round_case(np.random.default_rng(11), j=j, deg=deg,
                      nleaves=nleaves, bs=bs)


def _float_wire_case():
    rng = np.random.default_rng(23)
    case = round_case(rng, j=3, deg=2, nleaves=3, bs=64)
    case["wires"] = rng.normal(size=case["wires"].shape).astype(np.float32)
    case["scales"] = np.ones_like(case["scales"])
    return case


def _bf16_case():
    """bf16 theta with a bf16 (native) wire, as the trainer runs it; the
    values are rounded to bf16 and kept as float32 (see ``bf16_round``)."""
    rng = np.random.default_rng(5)
    case = round_case(rng, j=2, deg=1, nleaves=4, bs=128)
    case["theta"] = bf16_round(case["theta"])
    case["wires"] = bf16_round(rng.normal(size=case["wires"].shape))
    case["scales"] = np.ones_like(case["scales"])
    return case


def _cases():
    """name -> (case, block size, bf16 theta and wire)."""
    out = {f"int8/{j}/{deg}/{nleaves}/{bs}":
           (_int8_case(j, deg, nleaves, bs), bs, False)
           for j, deg, nleaves, bs in INT8_SHAPES}
    out["float"] = (_float_wire_case(), 64, False)
    out["bf16"] = (_bf16_case(), 128, True)
    return out


def _reference_outputs():
    """The reference oracle's and Pallas kernel's outputs for every case
    (runs with JAX)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    out = {}
    for name, (case, bs, bf16) in _cases().items():
        args = [jnp.asarray(case[k]) for k in ARGS]
        if bf16:
            args[0] = args[0].astype(jnp.bfloat16)
            args[3] = args[3].astype(jnp.bfloat16)
        for which in WHICH:
            if which == "oracle":
                res = jref.consensus_round_ref(
                    *args, block_leaf=case["block_leaf"], block_size=bs)
            else:                                 # Pallas, interpret mode
                res = jops.consensus_round(
                    *args, block_leaf=tuple(case["block_leaf"].tolist()),
                    block_size=bs)
            for k, x in zip(NAMES, res):
                out[f"{name}/{which}/{k}"] = np.asarray(x, dtype=np.float32)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_consensus_round", tmp_path_factory)


def _want(reference, name, which):
    return [reference[f"{name}/{which}/{k}"] for k in NAMES]


def _port(case, bs):
    out = ops.consensus_round(*torch_args(case),
                              block_leaf=case["block_leaf"], block_size=bs)
    return [x.float().numpy() for x in out]


@pytest.mark.parametrize("which", WHICH)
@pytest.mark.parametrize("j,deg,nleaves,bs", INT8_SHAPES)
def test_round_int8_wire_matches_reference(reference, j, deg, nleaves, bs,
                                           which):
    case = _int8_case(j, deg, nleaves, bs)
    launches = ops.consensus_round.launches
    want = _want(reference, f"int8/{j}/{deg}/{nleaves}/{bs}", which)
    for a, b, name in zip(_port(case, bs), want, NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
    # the CPU path is the plain version: no kernel launch is counted
    assert ops.consensus_round.launches == launches


@pytest.mark.parametrize("which", WHICH)
def test_round_float_wire_unit_scales_matches_reference(reference, which):
    for a, b, name in zip(_port(_float_wire_case(), 64),
                          _want(reference, "float", which), NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)             # bf16: 8 significand bits


@pytest.mark.parametrize("which", WHICH)
def test_round_bf16_theta_matches_reference(reference, which):
    """bf16 theta with a bf16 (native) wire, as the trainer runs it."""
    case = _bf16_case()
    args = torch_args(case)
    args[0] = args[0].to(torch.bfloat16)
    args[3] = args[3].to(torch.bfloat16)
    port = ops.consensus_round(*args, block_leaf=case["block_leaf"],
                               block_size=128)
    assert port[0].dtype == torch.bfloat16
    refd = _want(reference, "bf16", which)
    got = port[0].float().numpy()
    assert np.all(np.abs(got - refd[0]) <= _bf16_ulp(refd[0])), "theta"
    for a, b, name in zip(port[1:], refd[1:], NAMES[1:]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
