"""The port's selective SSM head (``models/ssm.py``, hymba's SSM half)
against the reference's.

The reference runs once per module in a fresh process
(``_reference_outputs``, through ``torch_round_cases.run_reference``) at
reduced hymba-1.5b's widths (d_model 64, 4 heads of 16, state 8) on weights
and inputs both sides draw from the numpy generators below (dt_bias, a_log
and d_skip away from their zero and one inits, so that they matter).

Tolerances: float32 y and final state to rtol/atol 1e-5 of their largest
magnitude (matmul and exp round-off carried through 24 steps of the
recurrence); bf16 y to 4 bf16 ulps of max|y| (4 * 2^-8: y passes five
bf16 roundings, the projections, the skip sum, the gate and the output
product, which the frameworks place differently; 2 ulps were seen) and the
float32 state to 1e-2 of max|h| (its inputs are those bf16 projections).
``ssm_decode`` one token at a time against ``ssm_apply`` on the whole
sequence is the same recurrence on projections that the matmul computes
by other paths for one row and for many: 1e-5 of the largest magnitude in
float32.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.models import ssm
from torch_round_cases import bf16_round, run_reference

DTYPES = ("float32", "bfloat16")
B, S = 2, 24


def _cfg(dtype="float32"):
    return dataclasses.replace(get_reduced_config("hymba-1.5b"), dtype=dtype)


def _inputs(dtype):
    """(params, x, h0) as float32 numpy (bf16-exact for the bf16 leaves;
    the state is float32 in either)."""
    cfg = _cfg()
    d, di, n, hh = cfg.d_model, cfg.q_dim, cfg.ssm_state, cfg.n_heads
    rng = np.random.default_rng(11)

    def mat(*shape):
        return rng.normal(size=shape) / np.sqrt(shape[0])

    p = {"w_x": mat(d, di), "w_z": mat(d, di), "w_b": mat(d, n),
         "w_c": mat(d, n), "w_dt": mat(d, hh),
         "dt_bias": rng.normal(size=hh) - 1.0,
         "a_log": 0.5 * rng.normal(size=hh),
         "d_skip": 1.0 + 0.3 * rng.normal(size=hh), "w_out": mat(di, d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    h0 = (0.3 * rng.normal(size=(B, hh, cfg.head_dim, n))).astype(np.float32)
    if dtype == "bfloat16":
        p = {k: bf16_round(v) for k, v in p.items()}
        x = bf16_round(x)
    return p, x, h0


def _reference_outputs():
    """The reference's ssm_apply from zero and from a given state, and its
    ssm_decode (runs with JAX)."""
    import jax.numpy as jnp
    from repro.configs import get_reduced_config as jget_reduced
    from repro.models import ssm as jssm

    out = {}
    for dtype in DTYPES:
        jcfg = dataclasses.replace(jget_reduced("hymba-1.5b"), dtype=dtype)
        p, x, h0 = _inputs(dtype)
        p = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in p.items()}
        x = jnp.asarray(x, getattr(jnp, dtype))
        for name, state in (("zero", None),
                            ("h0", jssm.SSMState(h=jnp.asarray(h0)))):
            y, st = jssm.ssm_apply(jcfg, p, x, state)
            out[f"{dtype}/{name}/y"] = np.asarray(y, np.float32)
            out[f"{dtype}/{name}/h"] = np.asarray(st.h)
        y, st = jssm.ssm_decode(jcfg, p, x[:, :1],
                                jssm.SSMState(h=jnp.asarray(h0)))
        out[f"{dtype}/decode/y"] = np.asarray(y, np.float32)
        out[f"{dtype}/decode/h"] = np.asarray(st.h)
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
    return run_reference("test_torch_ssm", tmp_path_factory)


def _torch_inputs(dtype):
    p, x, h0 = _inputs(dtype)
    dt = getattr(torch, dtype)
    return ({k: torch.from_numpy(v).to(dt) for k, v in p.items()},
            torch.from_numpy(x).to(dt), torch.from_numpy(h0))


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def test_defs_match_the_reference_inits():
    defs = ssm.ssm_defs(_cfg(), torch.float32)
    assert {k: d.init for k, d in defs.items() if d.init != "normal"} == {
        "dt_bias": "zeros", "a_log": "zeros", "d_skip": "ones"}
    assert defs["w_x"].shape == (64, 64) and defs["w_b"].shape == (64, 8)


@pytest.mark.parametrize("start", ["zero", "h0"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_apply_matches_reference(reference, dtype, start):
    p, x, h0 = _torch_inputs(dtype)
    state = ssm.SSMState(h=h0) if start == "h0" else None
    y, st = ssm.ssm_apply(_cfg(dtype), p, x, state)
    assert y.dtype == x.dtype and st.h.dtype == torch.float32
    assert tuple(st.h.shape) == (B, 4, 16, 8)
    tol_y, tol_h = (1e-5, 1e-5) if dtype == "float32" else (4 * 2.0 ** -8,
                                                           1e-2)
    _close(y, reference[f"{dtype}/{start}/y"], tol_y, "y")
    _close(st.h, reference[f"{dtype}/{start}/h"], tol_h, "state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_decode_matches_reference(reference, dtype):
    p, x, h0 = _torch_inputs(dtype)
    y, st = ssm.ssm_decode(_cfg(dtype), p, x[:, :1], ssm.SSMState(h=h0))
    tol = 1e-5 if dtype == "float32" else 4 * 2.0 ** -8
    _close(y, reference[f"{dtype}/decode/y"], tol, "y")
    _close(st.h, reference[f"{dtype}/decode/h"], 1e-5 if dtype == "float32"
           else 1e-2, "state")


def test_decode_steps_equal_the_full_scan():
    """``ssm_decode`` token by token, carrying the state, is the same
    recurrence as ``ssm_apply`` over the sequence."""
    cfg = _cfg()
    p, x, h0 = _torch_inputs("float32")
    y_full, st_full = ssm.ssm_apply(cfg, p, x, ssm.SSMState(h=h0))
    st, ys = ssm.SSMState(h=h0), []
    for t in range(S):
        y, st = ssm.ssm_decode(cfg, p, x[:, t:t + 1], st)
        ys.append(y)
    _close(torch.cat(ys, 1), y_full.numpy(), 1e-5, "y")
    _close(st.h, st_full.h.numpy(), 1e-5, "state")
