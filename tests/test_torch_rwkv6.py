"""The port's RWKV6 scan and block against the reference.

The reference runs once per module in a fresh process
(``_reference_outputs``, through ``torch_round_cases.run_reference``): its
Pallas ``rwkv6_scan`` in interpret mode, its oracle
``kernels.ref.rwkv6_scan_ref``, its model-layout ``ops.rwkv6_scan``, its
``wkv_chunked``, and its ``time_mix``, ``channel_mix`` and rwkv block on
reduced rwkv6-7b (float32), all on inputs both sides draw from the numpy
generators below.

Tolerances: the scan holds to ``3e-5 * max|y|`` in float32 and
``8e-3 * max|y|`` in bf16 (the reference's ``tests/test_kernels.py``), its
state to ``max(that, 1e-3)``; the chunked formulation to atol 2e-4, the
reference's chunk-invariance bound (its factors e^{ls - c} and e^{c - ls'}
magnify round-off). The block's functions hold to rtol 1e-4 /
atol 1e-5 in float32 (round-off of matmuls and transcendentals; with
``use_kernel`` the decay also passes through log and exp).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as rw_kernel
from repro_torch.models import rwkv6, transformer
from repro_torch.models.params import from_jax, is_def
from torch_round_cases import bf16_round, run_reference
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

# (b, h, t, hd, chunk): the reference's tests/test_kernels.py cases
CASES = [(1, 2, 64, 16, 16), (2, 3, 128, 32, 32), (1, 1, 96, 8, 32),
         (1, 4, 256, 64, 64)]
DTYPES = ("float32", "bfloat16")
RTOL = {"float32": 3e-5, "bfloat16": 8e-3}
BLOCK_SEQ = 64          # two 32-step chunks of the kernel path


def _case_id(case):
    return "-".join(str(x) for x in case)


def _scan_inputs(n, case, dtype):
    """r, k, v (bf16-exact for bfloat16), log_w, u, s0 as float32 numpy,
    head-major, the reference test's distributions."""
    b, h, t, hd, _ = case
    rng = np.random.default_rng(n)
    f = np.float32
    r = rng.normal(size=(b, h, t, hd)).astype(f)
    k = (rng.normal(size=(b, h, t, hd)) * 0.5).astype(f)
    v = rng.normal(size=(b, h, t, hd)).astype(f)
    if dtype == "bfloat16":
        r, k, v = map(bf16_round, (r, k, v))
    lw = (-np.exp(rng.normal(size=(b, h, t, hd)) * 0.5)).astype(f)
    u = (rng.normal(size=(h, hd)) * 0.1).astype(f)
    s0 = (rng.normal(size=(b, h, hd, hd)) * 0.1).astype(f)
    return r, k, v, lw, u, s0


def _model_scan_inputs(dtype):
    """Model layout [B, T, H, hd] with w = decay in (0, 1); u in the model
    dtype, as time_mix passes its bonus."""
    rng = np.random.default_rng(7)
    b, t, h, hd = 2, 64, 3, 16
    f = np.float32
    r, k, v = (rng.normal(size=(b, t, h, hd)).astype(f) for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(b, t, h, hd)) * 0.5)).astype(f)
    u = (rng.normal(size=(h, hd)) * 0.1).astype(f)
    s0 = (rng.normal(size=(b, h, hd, hd)) * 0.1).astype(f)
    if dtype == "bfloat16":
        r, k, v, u = map(bf16_round, (r, k, v, u))
    return r, k, v, w, u, s0


def _invariance_inputs():
    rng = np.random.default_rng(5)
    b, t, h, hd = 1, 128, 2, 16
    f = np.float32
    r, k, v = (rng.normal(size=(b, t, h, hd)).astype(f) for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(b, t, h, hd)) * 0.3)).astype(f)
    u = (rng.normal(size=(h, hd)) * 0.1).astype(f)
    s0 = (rng.normal(size=(b, h, hd, hd)) * 0.1).astype(f)
    return r, k, v, w, u, s0


def _block_cfg():
    return dataclasses.replace(get_reduced_config("rwkv6-7b"),
                               dtype="float32")


def _block_inputs():
    """A layer's parameters (every leaf random, so that the mixes, decays,
    bonus and gains all matter), x [2, 64, D], and a carried state."""
    cfg = _block_cfg()
    rng = np.random.default_rng(11)
    defs = transformer.block_defs(cfg, torch.float32)

    def draw(d):
        scale = 0.3 if len(d.shape) == 1 else 1.0 / np.sqrt(d.shape[-2])
        return (rng.normal(size=d.shape) * scale).astype(np.float32)

    params = tree_lib.tree_map(draw, defs, is_leaf=is_def)
    b, d, hh, hd = 2, cfg.d_model, cfg.n_heads, cfg.head_dim
    x = rng.normal(size=(b, BLOCK_SEQ, d)).astype(np.float32)
    state = dict(s=(rng.normal(size=(b, hh, hd, hd)) * 0.1).astype(
        np.float32), prev_tm=rng.normal(size=(b, d)).astype(np.float32),
        prev_cm=rng.normal(size=(b, d)).astype(np.float32))
    return params, x, state


def _reference_outputs():
    """The reference's scans and rwkv block functions (runs with JAX)."""
    import jax.numpy as jnp
    from repro.configs import get_reduced_config as jget_reduced
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.rwkv6_scan import rwkv6_scan as rw_raw
    from repro.models import rwkv6 as jrwkv
    from repro.models import transformer as jtf

    out = {}
    for n, case in enumerate(CASES):
        for dtype in DTYPES:
            r, k, v, lw, u, s0 = _scan_inputs(n, case, dtype)
            r, k, v = (jnp.asarray(x, getattr(jnp, dtype)) for x in (r, k, v))
            lw, u, s0 = map(jnp.asarray, (lw, u, s0))
            key = f"{_case_id(case)}/{dtype}"
            y, s = rw_raw(r, k, v, lw, u, s0, chunk=case[4], interpret=True)
            out[f"pallas/y/{key}"] = np.asarray(y, np.float32)
            out[f"pallas/s/{key}"] = np.asarray(s)
            y, s = jref.rwkv6_scan_ref(r, k, v, lw, u, s0)
            out[f"oracle/y/{key}"] = np.asarray(y, np.float32)
            out[f"oracle/s/{key}"] = np.asarray(s)
    for dtype in DTYPES:
        r, k, v, w, u, s0 = _model_scan_inputs(dtype)
        dt = getattr(jnp, dtype)
        y, s = jops.rwkv6_scan(jnp.asarray(r, dt), jnp.asarray(k, dt),
                               jnp.asarray(v, dt), jnp.asarray(w),
                               jnp.asarray(u, dt), jnp.asarray(s0))
        out[f"ops/y/{dtype}"] = np.asarray(y, np.float32)
        out[f"ops/s/{dtype}"] = np.asarray(s)
    r, k, v, w, u, s0 = map(jnp.asarray, _invariance_inputs())
    for chunk in (16, 64):
        y, s = jrwkv.wkv_chunked(r, k, v, w, u, s0, chunk)
        out[f"chunked/y/{chunk}"] = np.asarray(y)
        out[f"chunked/s/{chunk}"] = np.asarray(s)

    jcfg = dataclasses.replace(jget_reduced("rwkv6-7b"), dtype="float32")
    params, x, state = _block_inputs()
    p = {k: jnp.asarray(a) for k, a in params["rwkv"].items()}
    x = jnp.asarray(x)
    st = jrwkv.RWKVState(**{k: jnp.asarray(a) for k, a in state.items()})
    for tag, s_in in (("fresh", None), ("carried", st)):
        y, s_last, last = jrwkv.time_mix(jcfg, p, x, s_in)
        out[f"time_mix/{tag}/y"] = np.asarray(y)
        out[f"time_mix/{tag}/s"] = np.asarray(s_last)
        out[f"time_mix/{tag}/last"] = np.asarray(last)
        y, last = jrwkv.channel_mix(jcfg, p, x, s_in)
        out[f"channel_mix/{tag}/y"] = np.asarray(y)
        out[f"channel_mix/{tag}/last"] = np.asarray(last)
    jp = {"ln1": jnp.asarray(params["ln1"]), "ln2": jnp.asarray(params["ln2"]),
          "rwkv": p}
    out["block"] = np.asarray(jtf._block_full(jcfg, jp, x, None, None))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_rwkv6", tmp_path_factory)


def _assert_scan(y, s, reference, prefix, key, dtype):
    yr = reference[f"{prefix}/y/{key}"]
    scale = float(np.abs(yr).max()) + 1e-6
    np.testing.assert_allclose(y.float().numpy(), yr,
                               atol=RTOL[dtype] * scale, err_msg=prefix)
    np.testing.assert_allclose(s.numpy(), reference[f"{prefix}/s/{key}"],
                               atol=max(RTOL[dtype] * scale, 1e-3),
                               err_msg=prefix)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_scan_matches_pallas_and_oracle(reference, case, dtype):
    n = CASES.index(case)
    r, k, v, lw, u, s0 = _scan_inputs(n, case, dtype)
    r, k, v = (torch.from_numpy(x).to(getattr(torch, dtype))
               for x in (r, k, v))
    y, s = ref.rwkv6_scan_ref(r, k, v, *map(torch.from_numpy, (lw, u, s0)))
    assert y.dtype == r.dtype and s.dtype == torch.float32
    key = f"{_case_id(case)}/{dtype}"
    for prefix in ("pallas", "oracle"):
        _assert_scan(y, s, reference, prefix, key, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_model_layout_scan_matches_reference_ops(reference, dtype):
    """``ops.rwkv6_scan`` (model layout, decay w, log taken inside) against
    the reference's ``ops.rwkv6_scan`` (its Pallas kernel, interpret)."""
    r, k, v, w, u, s0 = _model_scan_inputs(dtype)
    dt = getattr(torch, dtype)
    before = ops.rwkv6_scan.launches
    y, s = ops.rwkv6_scan(*(torch.from_numpy(x).to(dt) for x in (r, k, v)),
                          torch.from_numpy(w),
                          torch.from_numpy(u).to(dt), torch.from_numpy(s0))
    assert ops.rwkv6_scan.launches == before          # the CPU: no kernel
    assert y.shape == r.shape and y.dtype == dt
    _assert_scan(y, s, reference, "ops", dtype, dtype)


def test_chunked_wkv_is_chunk_invariant_and_matches_reference(reference):
    """The chunk length is a tiling knob: wkv_chunked at 16 and 64 agrees
    with the per-step wkv_ref and with the reference's wkv_chunked."""
    r, k, v, w, u, s0 = map(torch.from_numpy, _invariance_inputs())
    y_ref, s_ref = rwkv6.wkv_ref(r, k, v, w, u, s0)
    for chunk in (16, 64):
        y, s = rwkv6.wkv_chunked(r, k, v, w, u, s0, chunk)
        for got, want in ((y, y_ref.numpy()), (s, s_ref.numpy()),
                          (y, reference[f"chunked/y/{chunk}"]),
                          (s, reference[f"chunked/s/{chunk}"])):
            np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def _port_block():
    params, x, state = _block_inputs()
    tp = from_jax(params)
    st = rwkv6.RWKVState(**from_jax(state))
    return tp, torch.from_numpy(x), st


def _close(got, want, msg):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5, err_msg=msg)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("tag", ["fresh", "carried"])
def test_time_mix_matches_reference(reference, tag, use_kernel):
    """time_mix with the per-step recurrence and with the scan's path (on
    the CPU, its plain version) against the reference's wkv_ref path."""
    tp, x, st = _port_block()
    y, (s_last,), last = rwkv6.time_mix(
        _block_cfg(), None, [tp["rwkv"]], x,
        [st] if tag == "carried" else None, use_kernel=use_kernel)
    _close(y, reference[f"time_mix/{tag}/y"], "y")
    _close(s_last, reference[f"time_mix/{tag}/s"], "s")
    _close(last, reference[f"time_mix/{tag}/last"], "last")


@pytest.mark.parametrize("tag", ["fresh", "carried"])
def test_channel_mix_matches_reference(reference, tag):
    tp, x, st = _port_block()
    y, last = rwkv6.channel_mix(_block_cfg(), None, [tp["rwkv"]], x,
                                st if tag == "carried" else None)
    _close(y, reference[f"channel_mix/{tag}/y"], "y")
    _close(last, reference[f"channel_mix/{tag}/last"], "last")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rwkv_block_matches_reference(reference, use_kernel):
    tp, x, _ = _port_block()
    got = transformer._block_full(_block_cfg(), tp, x, None, None,
                                  use_kernel=use_kernel)
    _close(got, reference["block"], "block")


def test_scan_refuses_a_ragged_sequence_and_other_devices():
    r = torch.zeros(1, 48, 2, 8)
    s0 = torch.zeros(1, 2, 8, 8)
    u = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        ops.rwkv6_scan(r, r, r, r + 0.5, u, s0)
    m = torch.zeros(1, 32, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.rwkv6_scan(m, m, m, m, u.to("meta"), s0.to("meta"))
    with pytest.raises(ValueError, match="not on a CUDA card"):
        rw_kernel.launch(r, r, r, r, u, s0, chunk=16)
