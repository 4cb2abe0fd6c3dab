"""The port's MoE FFN (``models/moe.py``) against the reference's.

The reference runs once per module in a fresh process
(``_reference_outputs``, through ``torch_round_cases.run_reference``) on
inputs and weights both sides draw from the numpy generators below, at
reduced moonshot-v1-16b-a3b's widths (d_model 64, 8 experts, top 2,
expert d_ff 96).

Tolerances:
* routing ids exactly, weights to rtol 1e-5 in float32 (the logits'
  matmul round-off through a softmax and a division) and to one bf16 ulp
  in bf16; with ties on purpose, ids exactly: ``jax.lax.top_k`` takes the
  lower expert id first among equal gates, and so must the port;
* ``moe_ref`` in float32 to rtol/atol 1e-5 of max|y| (matmul round-off,
  and the port sums experts and hidden units in one product where the
  reference combines per-expert outputs); in bf16 to 4 bf16 ulps of
  max|y| (4 * 2^-8): the reference rounds each expert's output to bf16
  before the weighted combine, the port rounds the weighted hidden
  activations, one rounding of a few terms either way (measured on this
  case: 0.0064 of max|y|, 1.6 ulps).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import build_model, moe
from torch_round_cases import bf16_round, run_reference

ARCH = "moonshot-v1-16b-a3b"
COUNT_ARCHS = ("moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "qwen3-4b")
DTYPES = ("float32", "bfloat16")
SHAPE = (2, 12)                  # batch, sequence: 24 tokens


def _cfg(dtype="float32"):
    return dataclasses.replace(get_reduced_config(ARCH), dtype=dtype)


def _weights(dtype):
    """router, wg, wu, wd and x as float32 numpy (bf16-exact for bf16)."""
    cfg = _cfg()
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    rng = np.random.default_rng(5)
    out = {"router": 0.3 * rng.normal(size=(d, e)),
           "wg": rng.normal(size=(e, d, f)) / np.sqrt(d),
           "wu": rng.normal(size=(e, d, f)) / np.sqrt(d),
           "wd": rng.normal(size=(e, f, d)) / np.sqrt(f),
           "x": rng.normal(size=SHAPE + (d,))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    return {k: bf16_round(v) for k, v in out.items()} \
        if dtype == "bfloat16" else out


def _tie_inputs():
    """One-hot tokens (so each logit row is a router row, exactly) and a
    router of a few repeated values: every row has ties, some at the top."""
    cfg = _cfg()
    d, e = cfg.d_model, cfg.moe.num_experts
    rng = np.random.default_rng(8)
    router = rng.choice(np.array([-1.0, 0.0, 0.5, 1.0], np.float32),
                        size=(d, e))
    router[:, [1, 4, 6]] = 1.5          # a three-way tie at the top
    router[::3, 2] = 2.0                # one clear winner, then a tie
    x = np.eye(d, dtype=np.float32)[np.arange(40) % d]
    return router, x


def _reference_outputs():
    """The reference's routing, moe_ref and parameter counts (runs with
    JAX)."""
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import get_reduced_config as jget_reduced
    from repro.models import build_model as jbuild
    from repro.models import moe as jmoe

    out = {}
    for dtype in DTYPES:
        jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=dtype)
        w = {k: jnp.asarray(v, getattr(jnp, dtype))
             for k, v in _weights(dtype).items()}
        x = w.pop("x")
        ids, wts = jmoe._route(jcfg, w["router"], x.reshape(-1, x.shape[-1]))
        out[f"route/{dtype}/ids"] = np.asarray(ids)
        out[f"route/{dtype}/w"] = np.asarray(wts, np.float32)
        out[f"moe/{dtype}"] = np.asarray(jmoe.moe_ref(jcfg, w, x),
                                         np.float32)
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype="float32")
    router, x = _tie_inputs()
    ids, wts = jmoe._route(jcfg, jnp.asarray(router), jnp.asarray(x))
    out["tie/ids"] = np.asarray(ids)
    out["tie/w"] = np.asarray(wts)
    for arch in COUNT_ARCHS:
        for name, cfg in (("full", jget(arch)), ("reduced",
                                                 jget_reduced(arch))):
            m = jbuild(cfg)
            out[f"count/{arch}/{name}"] = np.asarray(
                [m.param_count(), m.active_param_count()], np.int64)
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One CPU thread per test process while this module runs: the
    reference's JAX processes and the other pytest workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_moe", tmp_path_factory)


def _torch_weights(dtype):
    w = {k: torch.from_numpy(v).to(getattr(torch, dtype))
         for k, v in _weights(dtype).items()}
    return w, w.pop("x")


@pytest.mark.parametrize("dtype", DTYPES)
def test_route_matches_reference(reference, dtype):
    w, x = _torch_weights(dtype)
    ids, wts = moe._route(_cfg(dtype), w["router"], x.reshape(-1, 64))
    assert wts.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(ids.numpy(),
                                  reference[f"route/{dtype}/ids"])
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(wts.float().numpy(),
                               reference[f"route/{dtype}/w"], rtol=rtol)


def test_route_takes_tied_gates_lower_id_first(reference):
    router, x = _tie_inputs()
    ids, wts = moe._route(_cfg(), torch.from_numpy(router),
                          torch.from_numpy(x))
    want = reference["tie/ids"]
    np.testing.assert_array_equal(ids.numpy(), want)
    # the construction did tie: rows whose two picks share one gate
    assert (want[:, 0] == 1).any() and ((want == [1, 4]).all(1)).any()
    np.testing.assert_allclose(wts.numpy(), reference["tie/w"], rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_ref_matches_reference(reference, dtype):
    w, x = _torch_weights(dtype)
    got = moe.moe_ref(_cfg(dtype), w, x)
    assert got.dtype == x.dtype and got.shape == x.shape
    want = reference[f"moe/{dtype}"]
    scale = float(np.abs(want).max())
    tol = 1e-5 if dtype == "float32" else 4 * 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * scale)
    # moe_apply is moe_ref on one device
    assert torch.equal(moe.moe_apply(_cfg(dtype), w, x), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_ref_in_expert_groups(reference, monkeypatch, dtype):
    """Where all experts' intermediates would not fit at once, moe_ref runs
    them a group at a time and sums the groups in float32: the same
    function (here groups of 3, 3 and 2 experts), within the whole
    product's bounds."""
    w, x = _torch_weights(dtype)
    whole = moe.moe_ref(_cfg(dtype), w, x)
    monkeypatch.setattr(moe, "_GROUP_ELEMS", 3 * 24 * 96)
    got = moe.moe_ref(_cfg(dtype), w, x)
    assert got.dtype == x.dtype and got.shape == x.shape
    want = reference[f"moe/{dtype}"]
    scale = float(np.abs(want).max())
    tol = 1e-5 if dtype == "float32" else 4 * 2.0 ** -8
    for y in (got, whole):
        np.testing.assert_allclose(y.float().numpy(), want, rtol=0,
                                   atol=tol * scale)


def test_moe_ref_drops_no_token():
    """Every token gets its top-k experts' full weight: with identical
    experts the output is that expert's FFN, whatever the routing."""
    cfg = _cfg()
    w, x = _torch_weights("float32")
    for k in ("wg", "wu", "wd"):
        w[k] = w[k][:1].expand_as(w[k]).contiguous()
    got = moe.moe_ref(cfg, w, x)
    h = torch.nn.functional.silu(x @ w["wg"][0]) * (x @ w["wu"][0])
    np.testing.assert_allclose(got.numpy(), (h @ w["wd"][0]).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", COUNT_ARCHS)
def test_param_counts_match_reference(reference, arch):
    """param_count and active_param_count (MoE: routed experts only, top_k
    of E) at full and reduced size, from the definitions alone."""
    for name, cfg in (("full", get_config(arch)),
                      ("reduced", get_reduced_config(arch))):
        m = build_model(cfg)
        got = [m.param_count(), m.active_param_count()]
        np.testing.assert_array_equal(got, reference[f"count/{arch}/{name}"])
        if cfg.moe is None:
            assert got[0] == got[1]
        else:
            assert got[1] < got[0]
