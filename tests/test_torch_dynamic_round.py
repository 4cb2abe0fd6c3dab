"""The port's edge-gated consensus round against the reference.

On the CPU ``repro_torch.kernels.ops.consensus_round`` with ``bar_w`` /
``inv_deg`` (and ``kick_w``) runs its plain PyTorch version; it is held
against the reference's Pallas kernel in interpret mode
(``repro.kernels.ops.consensus_round``), in both of its tilings (whole rows,
and the TPU's (node, block) grid), and against the reference oracle, on the
same numpy-seeded inputs (``torch_round_cases.masked_round_case``): a ghost
row, a dead offset, mixed gates, kicks on gated edges. The reference runs
once per module in a fresh process (``_reference_outputs``).

Tolerances: theta', lam' and bar to 1e-6 (rtol and atol) in float32 — both
sides round after every multiply and add and sum the offsets in the same
order; r^2 and s^2 to rtol 1e-5 (block partials summed in another order);
for a bf16 theta, theta' within one bf16 ulp. With every gate 1 and
``inv_deg = 1/deg`` the gated plain version equals the ungated one bit for
bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from torch_round_cases import (ARGS, NAMES, masked_round_case,
                               masked_torch_args, round_case, run_reference,
                               torch_args)
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

BS = 64
WHICH = ("rows", "blocks", "oracle")
KINDS = (("float32", "int8"), ("float32", "native"), ("bfloat16", "native"),
         ("bfloat16", "int8"))


def _case(theta_dtype, wire, kick):
    return masked_round_case(np.random.default_rng(31), j=4, deg=3,
                             nleaves=4, bs=BS, wire=wire,
                             theta_dtype=theta_dtype, kick=kick)


def _reference_outputs():
    """The reference's outputs for every case (runs with JAX)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    out = {}
    for theta_dtype, wire in KINDS:
        for kick in (False, True):
            case = _case(theta_dtype, wire, kick)
            args = [jnp.asarray(case[k]) for k in ARGS]
            if theta_dtype == "bfloat16":
                args[0] = args[0].astype(jnp.bfloat16)
                if wire == "native":
                    args[3] = args[3].astype(jnp.bfloat16)
            kw = {k: jnp.asarray(case[k])
                  for k in ("bar_w", "inv_deg", "kick_w") if k in case}
            for which in WHICH:
                if which == "oracle":
                    res = jref.consensus_round_ref(
                        *args, block_leaf=case["block_leaf"], block_size=BS,
                        **kw)
                else:                             # Pallas, interpret mode
                    res = jops.consensus_round(
                        *args, block_leaf=tuple(case["block_leaf"].tolist()),
                        block_size=BS, whole_rows=(which == "rows"), **kw)
                for name, x in zip(NAMES, res):
                    out[f"{theta_dtype}/{wire}/{kick}/{which}/{name}"] = \
                        np.asarray(x, dtype=np.float32)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_dynamic_round", tmp_path_factory)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)             # bf16: 8 significand bits


@pytest.mark.parametrize("which", WHICH)
@pytest.mark.parametrize("kick", [False, True])
@pytest.mark.parametrize("theta_dtype,wire", KINDS)
def test_masked_round_matches_reference(reference, theta_dtype, wire, kick,
                                        which):
    case = _case(theta_dtype, wire, kick)
    args, kw = masked_torch_args(case)
    launches = (ops.consensus_round.launches,
                ops.consensus_round.masked_launches)
    port = ops.consensus_round(*args, block_leaf=case["block_leaf"],
                               block_size=BS, **kw)
    # the CPU path is the plain version: no kernel launch is counted
    assert (ops.consensus_round.launches,
            ops.consensus_round.masked_launches) == launches
    want = [reference[f"{theta_dtype}/{wire}/{kick}/{which}/{name}"]
            for name in NAMES]
    got = [x.float().numpy() for x in port]
    if theta_dtype == "bfloat16":
        assert port[0].dtype == torch.bfloat16
        assert np.all(np.abs(got[0] - want[0]) <= _bf16_ulp(want[0])), \
            "theta"
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6,
                                   err_msg="theta")
    for a, b, name in zip(got[1:3], want[1:3], NAMES[1:3]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)
    for a, b, name in zip(got[3:], want[3:], NAMES[3:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=name)
    # the ghost row has no neighbor mean, the dead offset added nothing
    assert not got[2][-1].any()


@pytest.mark.parametrize("wire", ["int8", "native"])
@pytest.mark.parametrize("j,deg,nleaves", [(2, 1, 3), (4, 2, 5), (5, 4, 2)])
def test_all_open_gates_equal_the_ungated_round(j, deg, nleaves, wire):
    """Every gate 1 and inv_deg = 1/deg: the gated plain version is the
    ungated one, bit for bit."""
    rng = np.random.default_rng(7 + j)
    case = round_case(rng, j=j, deg=deg, nleaves=nleaves, bs=BS)
    if wire == "native":
        case["wires"] = rng.normal(size=case["wires"].shape).astype(
            np.float32)
        case["scales"] = np.ones_like(case["scales"])
    args = torch_args(case)
    ungated = ops.consensus_round(*args, block_leaf=case["block_leaf"],
                                  block_size=BS)
    inv = torch.full((j,), 1.0 / deg, dtype=torch.float32)
    gated = ops.consensus_round(*args, block_leaf=case["block_leaf"],
                                block_size=BS,
                                bar_w=torch.ones(deg, j), inv_deg=inv)
    for a, b, name in zip(gated[:4], ungated[:4], NAMES):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("drop", ["inv_deg", "bar_w"])
def test_partial_gates_are_refused(drop):
    """kick_w without bar_w, and bar_w without inv_deg, are errors (the
    reference's rules); per-block scales (the fp8 wires' granularity) are
    taken, and per-block rows made from the per-leaf ones through the
    block->leaf table give the per-leaf round bit for bit."""
    case = masked_round_case(np.random.default_rng(2), j=3, deg=2,
                             nleaves=2, bs=BS)
    args, kw = masked_torch_args(case)
    full = dict(kw)
    kw.pop(drop)
    if drop == "bar_w":
        kw.pop("inv_deg")
    with pytest.raises(ValueError, match="travel together|needs the gated"):
        ops.consensus_round(*args, block_leaf=case["block_leaf"],
                            block_size=BS, **kw)
    per_leaf = ops.consensus_round(*args, block_leaf=case["block_leaf"],
                                   block_size=BS, **full)
    blocks = list(args)
    blocks[4] = args[4][..., torch.from_numpy(case["block_leaf"]).long()]
    per_block = ops.consensus_round(*blocks, block_leaf=case["block_leaf"],
                                    block_size=BS, scales_per_block=True,
                                    **full)
    for a, b, name in zip(per_block, per_leaf, NAMES):
        assert torch.equal(a, b), name


def test_plain_version_leaves_inputs_untouched():
    case = masked_round_case(np.random.default_rng(3), j=4, deg=3,
                             nleaves=3, bs=BS)
    args, kw = masked_torch_args(case)
    before = [a.clone() for a in args]
    ref.consensus_round_ref(*args, block_leaf=case["block_leaf"],
                            block_size=BS, **kw)
    for a, b in zip(args, before):
        assert torch.equal(a, b)
