"""The port's flat consensus update against the reference.

On the CPU ``repro_torch.kernels.ops.consensus_update`` runs its plain
PyTorch version (``ref.consensus_update_ref``); it is held against the
reference's Pallas kernel in interpret mode
(``repro.kernels.ops.consensus_update``) and its oracle
(``repro.kernels.ref.consensus_update_ref``) on the same numpy-seeded
inputs: N a multiple of the block size, N not one (the kernel's zero
padding), and N below one block; f32 and bf16 theta and lam. The CUDA
kernel is held against the plain version on the card in
``test_torch_cuda.py`` and ``chip_smoke.py``.

The reference runs once per module in a fresh process
(``_reference_outputs``, through ``torch_round_cases.run_reference``).

Tolerances: theta' and lam' to 1e-6 (rtol and atol) in float32 — the same
f32 operations on both sides; a bf16 theta' or lam' within one bf16 ulp;
r^2 and s^2 to rtol 1e-5 (sums over the block taken in another order, and
the oracle sums the whole vector at once).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import consensus_update as cu
from repro_torch.kernels import ops, ref
from torch_round_cases import bf16_round, run_reference
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

BS = 1024
SIZES = (8 * BS, 5000, 777)
DTYPES = ("float32", "bfloat16")
WHICH = ("pallas", "oracle")
SCALARS = dict(eta_sum=0.7, eta_node=0.35, step_size=0.2)
NAMES = ("theta", "lam", "r_sq", "s_sq")


def _case(n, dtype):
    """theta, lam, nbr_avg, bar, bar_prev as float32 numpy ([N]); with a
    bf16 ``dtype`` theta and lam hold bf16 values."""
    rng = np.random.default_rng(n)
    theta, lam, nbr, bar, barp = (rng.normal(size=n).astype(np.float32)
                                  for _ in range(5))
    if dtype == "bfloat16":
        theta, lam = bf16_round(theta), bf16_round(lam)
    return theta, lam, nbr, bar, barp


def _reference_outputs():
    """The reference kernel's (interpret mode) and oracle's outputs for
    every case (runs with JAX)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    out = {}
    for n in SIZES:
        for dtype in DTYPES:
            args = [jnp.asarray(x) for x in _case(n, dtype)]
            args[0] = args[0].astype(jnp.dtype(dtype))
            args[1] = args[1].astype(jnp.dtype(dtype))
            for which in WHICH:
                if which == "pallas":
                    res = jops.consensus_update(*args, block_size=BS,
                                                **SCALARS)
                else:
                    res = jref.consensus_update_ref(*args, **SCALARS)
                for name, x in zip(NAMES, res):
                    out[f"{n}/{dtype}/{which}/{name}"] = np.asarray(
                        x, np.float32)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_consensus_update", tmp_path_factory)


def _port_args(n, dtype):
    args = [torch.from_numpy(x) for x in _case(n, dtype)]
    args[0] = args[0].to(getattr(torch, dtype))
    args[1] = args[1].to(getattr(torch, dtype))
    return args


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)             # bf16: 8 significand bits


@pytest.mark.parametrize("which", WHICH)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_flat_update_matches_reference(reference, n, dtype, which):
    args = _port_args(n, dtype)
    before = ops.consensus_update.launches
    port = ops.consensus_update(*args, block_size=BS, **SCALARS)
    # the CPU path is the plain version: no kernel launch is counted
    assert ops.consensus_update.launches == before
    want = [reference[f"{n}/{dtype}/{which}/{name}"] for name in NAMES]
    for x, w, name in zip(port[:2], want[:2], NAMES):
        assert x.dtype == getattr(torch, dtype) and x.shape == (n,), name
        got = x.float().numpy()
        if dtype == "bfloat16":
            assert np.all(np.abs(got - w) <= _bf16_ulp(w)), name
        else:
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    for x, w, name in zip(port[2:], want[2:], NAMES[2:]):
        assert x.shape == ()
        np.testing.assert_allclose(float(x), float(w), rtol=1e-5,
                                   err_msg=name)


def test_flat_update_plain_version_leaves_inputs_untouched():
    args = _port_args(5000, "float32")
    before = [a.clone() for a in args]
    ref.consensus_update_ref(*args, block_size=BS, **SCALARS)
    for a, b in zip(args, before):
        assert torch.equal(a, b)


def test_flat_update_sums_blocks_first():
    """r^2 and s^2 are sums of per-block partials over blocks of
    min(block_size, N): a block size of N or more gives one block."""
    args = _port_args(5000, "float32")
    whole = ops.consensus_update(*args, block_size=8 * BS, **SCALARS)
    theta_new = whole[0]
    bar = args[3]
    r = ((theta_new - bar) ** 2).sum()
    assert torch.equal(whole[2], r)
    blocked = ops.consensus_update(*args, block_size=BS, **SCALARS)
    parts = torch.nn.functional.pad((theta_new - bar) ** 2, (0, 120))
    assert torch.equal(blocked[2], parts.reshape(5, BS).sum(dim=1).sum())
    for a, b in zip(blocked[:2], whole[:2]):
        assert torch.equal(a, b)


def test_flat_update_has_no_fallback():
    """A tensor off the CPU never reaches the plain version, and the launch
    path refuses a CPU tensor instead of computing anything."""
    x = torch.zeros(128, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.consensus_update(x, x, x, x, x, **SCALARS)
    c = torch.zeros(128)
    with pytest.raises(ValueError, match="not on a CUDA card"):
        cu.launch_update(c, c.clone(), c.clone(), c.clone(), c.clone(),
                         **SCALARS)
