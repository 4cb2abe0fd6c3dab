"""The port's dense consensus-ADMM engine and residuals against the reference.

Both packages start from the reference's own state, carried across with
``repro_torch.core.admm.state_from_numpy``, on the same numpy-seeded
distributed least-squares data (``tests/test_core.py``'s problem).

* Residuals (float32 and float64, a ghost row): within 1e-6 relative.
* float64, one step at a time: before each of ``STEPS_F64`` steps the
  port takes the reference's state. theta within 1e-9 of max|theta|; eta,
  cum_tau and budget within 1e-9 relative (they come out equal); n_incr
  and t equal; lam within ``LAM_STEP_TOL`` of max|lam| (see below); r_norm
  and s_norm (float32 in both) within 1e-5 relative plus ``RS_ATOL`` of
  max|theta|.
* float64, ``STEPS_F64`` steps run freely from the init, and ``run``'s
  iteration count at rel_tol ``RUN_TOL``: the looser bounds below.
* float32, ``STEPS_F32`` free steps: theta within 1e-4 of max|theta| (no
  iteration counts: below rel_tol 1e-5 they are set by float32 round-off).
* The dense dynamic topology (J 12, expander, budget scheduler, a node
  dropped before step ``CHURN_AT``): one step at a time, every mask equal
  and theta within 1e-9; freely, every mask equal.

Why some bounds are looser than 1e-9. The reference jits its step, and
XLA's CPU backend contracts the float32 product eta * edge_scale into a
fused multiply-add inside the symmetrized dual weight w. Where the degree
compensation is not 1 (ring, expander) each applied weight can round once
differently, so lam moves by up to ~2^-24 * wsum * |theta| per step: up to
2.3e-6 of max|lam| here. The same step run eagerly (``jax.disable_jit()``)
equals the port to 1e-14. Run freely, that difference feeds theta (8e-8),
and through theta the float32 objective probes, whose spread near consensus
is a few hundred float32 ulps, so tau and eta move by up to 5e-6 and lam by
1.1e-5 in 25 steps. theta_bar is rounded to float32 in both packages, and
its sums over the neighbors are taken in another order, so a residual norm
near consensus is only known to a few float32 ulps of |theta|.

The reference runs in fresh processes (``_reference_outputs`` in float32,
``_reference_outputs_x64`` with ``jax_enable_x64``), through
``torch_round_cases.run_reference``.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import (SCHEMES, ConsensusADMM, PenaltyConfig,
                              build_graph, consensus_error, local_residuals,
                              neighbor_mean, node_eta)
from repro_torch.core import admm
from repro_torch.topology import TopologyConfig
from torch_round_cases import run_reference
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

J = 8
STEPS_F64 = 25
STEPS_F32 = 10
RUN_TOL = 1e-6
RUN_MAX = 300
INNER = dict(inner_steps=10, inner_lr=1.0)
DYN_J = 12
DYN_STEPS = 40
CHURN_AT = 5
VICTIM = 7
DYN_TOPO = dict(scheduler="budget", churn=True, gate_tol=0.05)
PENALTY_FIELDS = ("eta", "cum_tau", "budget", "n_incr", "f_prev", "t")
LAM_STEP_TOL = 1e-5     # one step: the jitted reference's fused dual weight
RS_ATOL = 2e-6          # residual norms: float32 theta_bar (32 ulps of 1)
FREE_THETA_TOL = 1e-6   # 25 free steps: theta, lam and the penalty state
FREE_LAM_TOL = 1e-4
FREE_ETA_RTOL = 1e-4

# name -> (scheme, topology, engine options)
CASES = {f"{s}/{t}": (s, t, {}) for t in ("complete", "ring")
         for s in SCHEMES}
CASES.update({
    "nap/expander": ("nap", "expander", {}),
    "ap/complete/midpoint": ("ap", "complete", {"probe_midpoint": True}),
    "vp_nap/ring/unnormalized": ("vp_nap", "ring",
                                 {"degree_normalize": False}),
    "nap/ring/closed_form": ("nap", "ring", {"closed_form": True}),
})
F32_CASES = [f"{s}/{t}" for t in ("complete", "ring") for s in SCHEMES]


def _lsq_problem(j, d=4, n=16, seed=0):
    """The reference's ``tests/test_core.py::_lsq_problem`` data."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(j, n, d)).astype(np.float32)
    w_true = rng.normal(size=d).astype(np.float32)
    b = A @ w_true + 0.01 * rng.normal(size=(j, n)).astype(np.float32)
    theta0 = rng.normal(size=(j, d)).astype(np.float32)
    return A, b, theta0


def _tree_case(seed, dtype):
    """A two-leaf, nested theta tree, its previous neighbor mean, a mask
    with a ghost row (node J-1 has no edges) and per-node etas."""
    rng = np.random.default_rng(seed)
    theta = {"a": rng.normal(size=(J, 3)),
             "b": {"c": rng.normal(size=(J, 2, 2))}}
    prev = {"a": rng.normal(size=(J, 3)),
            "b": {"c": rng.normal(size=(J, 2, 2))}}
    adj = build_graph("ring", J).adj.copy()
    adj[J - 1, :] = adj[:, J - 1] = False
    eta_edges = rng.uniform(0.5, 2.0, size=(J, J)).astype(np.float32)
    cast = {"float32": np.float32, "float64": np.float64}[dtype]
    conv = (lambda t: {"a": t["a"].astype(cast),
                       "b": {"c": t["b"]["c"].astype(cast)}})
    return conv(theta), conv(prev), adj, eta_edges


def _flat(prefix, tree, out):
    """A nested dict of arrays into ``out`` under ``prefix/<path>``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(f"{prefix}/{k}", v, out)
    else:
        out[prefix] = np.asarray(tree)


def _flat_state(prefix, st):
    """The reference's ``ConsensusState`` in ``state_from_numpy``'s keys."""
    out = {}
    for name in ("theta", "lam", "theta_bar"):
        _flat(f"{prefix}/{name}", getattr(st, name), out)
    for f in PENALTY_FIELDS:
        out[f"{prefix}/penalty/{f}"] = np.asarray(getattr(st.penalty, f))
    out[f"{prefix}/t"] = np.asarray(st.t)
    if st.topo is not None:
        for f in st.topo._fields:
            if f != "key":
                out[f"{prefix}/topo/{f}"] = np.asarray(getattr(st.topo, f))
    return out


def _carried(ref, prefix, device="cpu"):
    head = prefix + "/"
    return admm.state_from_numpy(
        {k[len(head):]: v for k, v in ref.items() if k.startswith(head)},
        device)


def _reference_engine(name, dtype):
    import jax.numpy as jnp
    from repro.core import ConsensusADMM as JADMM
    from repro.core import PenaltyConfig as JPC
    from repro.core import build_graph as jbuild

    scheme, topo, opts = CASES[name]
    opts = dict(opts)
    solver = None
    if opts.pop("closed_form", False):
        def solver(data, theta, lam, eta, adj):
            A, b = data
            w = eta * adj.astype(jnp.float32)
            wsum = w.sum(axis=1)
            th = theta["w"]
            pull = 0.5 * (w @ th + wsum[:, None] * th)
            d = th.shape[1]
            H = jnp.einsum("jni,jnk->jik", A, A) \
                + wsum[:, None, None] * jnp.eye(d, dtype=th.dtype)
            rhs = jnp.einsum("jni,jn->ji", A, b) - lam["w"] + pull
            return {"w": jnp.linalg.solve(H, rhs[..., None])[..., 0]}

    def objective(data, th):
        Ai, bi = data
        return jnp.sum((Ai @ th["w"] - bi) ** 2)

    A, b, theta0 = _lsq_problem(J)
    data = (jnp.asarray(A, dtype), jnp.asarray(b, dtype))
    eng = JADMM(objective=objective,
                penalty_cfg=JPC(scheme=scheme, eta0=1.0),
                graph=jbuild(topo, J), local_solver=solver, **INNER, **opts)
    return eng, data, {"w": jnp.asarray(theta0, dtype)}


def _reference_steps(out, name, dtype, steps, *, run):
    """The reference's state before each step (``{name}/{k}``, k = 0 is the
    init) and after the last, its residuals at every step, and ``run``'s
    iteration count from the init."""
    eng, data, theta0 = _reference_engine(name, dtype)
    st0 = st = eng.init(theta0)
    for k in range(steps):
        out.update(_flat_state(f"{name}/{k}", st))
        st, m = eng.step(st, data)
        out[f"{name}/{k}/r_norm"] = np.asarray(m["r_norm"])
        out[f"{name}/{k}/s_norm"] = np.asarray(m["s_norm"])
    out.update(_flat_state(f"{name}/{steps}", st))
    if run:
        _, hist = eng.run(st0, data, max_iters=RUN_MAX, rel_tol=RUN_TOL)
        out[f"{name}/iters"] = np.asarray(hist["iterations"])
        out[f"{name}/eta_mean"] = np.asarray(hist["eta_mean"])


def _reference_residuals(out, dtype):
    import jax.numpy as jnp
    from repro.core import residuals as jres
    from repro.core.admm import consensus_error as jerr

    theta, prev, adj, eta_edges = _tree_case(3, dtype)
    jt = {"a": jnp.asarray(theta["a"]),
          "b": {"c": jnp.asarray(theta["b"]["c"])}}
    jp = {"a": jnp.asarray(prev["a"]), "b": {"c": jnp.asarray(prev["b"]["c"])}}
    eta_node = jres.node_eta(jnp.asarray(eta_edges), jnp.asarray(adj))
    rr = jres.local_residuals(jt, jp, jnp.asarray(adj), eta_node)
    out[f"res/{dtype}/eta_node"] = np.asarray(eta_node)
    out[f"res/{dtype}/r_norm"] = np.asarray(rr.r_norm)
    out[f"res/{dtype}/s_norm"] = np.asarray(rr.s_norm)
    _flat(f"res/{dtype}/theta_bar", rr.theta_bar, out)
    out[f"res/{dtype}/error"] = np.asarray(jerr(jt))


def _reference_outputs():
    """float32 (the reference's default): steps and residuals."""
    import jax.numpy as jnp
    out = {}
    for name in F32_CASES:
        _reference_steps(out, name, jnp.float32, STEPS_F32, run=False)
    _reference_residuals(out, "float32")
    return out


def _reference_outputs_x64():
    """float64 under ``jax_enable_x64``: steps, runs, residuals and the
    dense dynamic topology."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from repro.core import ConsensusADMM as JADMM
    from repro.core import PenaltyConfig as JPC
    from repro.core import build_graph as jbuild
    from repro.topology import TopologyConfig as JTC

    out = {}
    for name in CASES:
        _reference_steps(out, name, jnp.float64, STEPS_F64, run=True)
    _reference_residuals(out, "float64")

    def objective(data, th):
        Ai, bi = data
        return jnp.sum((Ai @ th["w"] - bi) ** 2)

    A, b, theta0 = _lsq_problem(DYN_J, seed=3)
    data = (jnp.asarray(A, jnp.float64), jnp.asarray(b, jnp.float64))
    eng = JADMM(objective=objective, penalty_cfg=JPC(scheme="nap", eta0=1.0),
                graph=jbuild("expander", DYN_J), topology_cfg=JTC(**DYN_TOPO),
                **INNER)
    st = eng.init({"w": jnp.asarray(theta0, jnp.float64)})
    for k in range(DYN_STEPS):
        out.update(_flat_state(f"dyn/{k}", st))
        if k == CHURN_AT:
            st = eng.apply_churn(st, VICTIM)
        st, m = eng.step(st, data)
        out[f"dyn/{k}/active_edges"] = np.asarray(m["active_edges"])
    out.update(_flat_state(f"dyn/{DYN_STEPS}", st))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_admm", tmp_path_factory)


@pytest.fixture(scope="module")
def reference_x64(tmp_path_factory):
    return run_reference("test_torch_admm", tmp_path_factory,
                         fn="_reference_outputs_x64")


def _objective(data, th):
    Ai, bi = data
    return (Ai @ th["w"] - bi).square().sum()


def _closed_form(data, theta, lam, eta, adj):
    """The exact argmin of the augmented least-squares objective."""
    A, b = data
    w = eta * adj.to(torch.float32)
    wsum = w.sum(dim=1)
    th = theta["w"]
    pull = 0.5 * (w.to(th.dtype) @ th + wsum[:, None] * th)
    d = th.shape[1]
    H = torch.einsum("jni,jnk->jik", A, A) \
        + wsum[:, None, None] * torch.eye(d, dtype=th.dtype)
    rhs = torch.einsum("jni,jn->ji", A, b) - lam["w"] + pull
    return {"w": torch.linalg.solve(H, rhs[..., None])[..., 0]}


def _engine(name, dtype):
    scheme, topo, opts = CASES[name]
    opts = dict(opts)
    solver = _closed_form if opts.pop("closed_form", False) else None
    A, b, _ = _lsq_problem(J)
    data = (torch.as_tensor(A).to(dtype), torch.as_tensor(b).to(dtype))
    eng = ConsensusADMM(objective=_objective,
                        penalty_cfg=PenaltyConfig(scheme=scheme, eta0=1.0),
                        graph=build_graph(topo, J), local_solver=solver,
                        **INNER, **opts)
    return eng, data


def _close_scaled(got, want, tol, msg):
    """|got - want| <= tol * max|want|."""
    got = got.detach().cpu().numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{msg}: {err} > {tol} * {scale}"


def _check_penalty(pen, ref, prefix, rtol):
    for f in ("eta", "cum_tau", "budget"):
        np.testing.assert_allclose(getattr(pen, f).numpy(),
                                   ref[f"{prefix}/penalty/{f}"], rtol=rtol,
                                   err_msg=f)
    for f in ("n_incr", "t"):
        np.testing.assert_array_equal(getattr(pen, f).numpy(),
                                      ref[f"{prefix}/penalty/{f}"])


def _check_residuals(m, ref, prefix, theta_scale):
    for k in ("r_norm", "s_norm"):
        assert m[k].dtype == torch.float32
        np.testing.assert_allclose(m[k].numpy(), ref[f"{prefix}/{k}"],
                                   rtol=1e-5, atol=RS_ATOL * theta_scale,
                                   err_msg=k)


def test_carried_state_matches_a_fresh_init(reference_x64):
    """``state_from_numpy`` keeps every field and dtype, and the port's own
    ``init`` builds the same state (theta_bar to float32 round-off)."""
    eng, _ = _engine("nap/ring", torch.float64)
    st = _carried(reference_x64, "nap/ring/0")
    fresh = eng.init(st.theta)
    for name in ("theta", "lam", "theta_bar"):
        for got, want in zip(tree_lib.leaves(getattr(fresh, name)),
                             tree_lib.leaves(getattr(st, name))):
            assert got.dtype == want.dtype == torch.float64
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    for f in PENALTY_FIELDS:
        got, want = getattr(fresh.penalty, f), getattr(st.penalty, f)
        assert got.dtype == want.dtype, f
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert st.t.dtype == torch.int32 and st.topo is None


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_residuals_match_reference(reference, reference_x64, dtype):
    ref = reference if dtype == "float32" else reference_x64
    theta, prev, adj, eta_edges = _tree_case(3, dtype)
    tt = tree_lib.tree_map(torch.as_tensor, theta)
    tp = tree_lib.tree_map(torch.as_tensor, prev)
    adj_t = torch.as_tensor(adj)
    eta_node = node_eta(torch.as_tensor(eta_edges), adj_t)
    rr = local_residuals(tt, tp, adj_t, eta_node)
    key = f"res/{dtype}"
    np.testing.assert_allclose(eta_node.numpy(), ref[f"{key}/eta_node"],
                               rtol=1e-6)
    assert rr.r_norm.dtype == rr.s_norm.dtype == torch.float32
    np.testing.assert_allclose(rr.r_norm.numpy(), ref[f"{key}/r_norm"],
                               rtol=1e-6)
    np.testing.assert_allclose(rr.s_norm.numpy(), ref[f"{key}/s_norm"],
                               rtol=1e-6)
    assert rr.r_norm[J - 1] > 0          # the ghost row's theta_bar is 0
    for path, leaf in tree_lib.leaves_with_paths(rr.theta_bar):
        assert leaf.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(
            leaf.numpy(), ref[f"{key}/theta_bar/" + "/".join(path)],
            rtol=1e-6)
        assert not leaf[J - 1].any()
    bar = neighbor_mean(tt, adj_t)
    np.testing.assert_allclose(bar["a"].numpy(), ref[f"{key}/theta_bar/a"],
                               rtol=1e-6)
    err = consensus_error(tt)
    assert err.dtype == torch.float32
    np.testing.assert_allclose(err.item(), ref[f"{key}/error"], rtol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_each_step_matches_reference_float64(reference_x64, name):
    """One step at a time from the reference's state."""
    eng, data = _engine(name, torch.float64)
    ref = reference_x64
    for k in range(STEPS_F64):
        st, m = eng.step(_carried(ref, f"{name}/{k}"), data)
        prefix = f"{name}/{k + 1}"
        assert st.theta["w"].dtype == st.lam["w"].dtype == torch.float64
        assert st.penalty.eta.dtype == torch.float32
        scale = float(np.abs(ref[f"{prefix}/theta/w"]).max())
        _close_scaled(st.theta["w"], ref[f"{prefix}/theta/w"], 1e-9,
                      f"theta, step {k}")
        _close_scaled(st.lam["w"], ref[f"{prefix}/lam/w"], LAM_STEP_TOL,
                      f"lam, step {k}")
        _check_penalty(st.penalty, ref, prefix, 1e-9)
        np.testing.assert_array_equal(st.t.numpy(), ref[f"{prefix}/t"])
        _check_residuals(m, ref, f"{name}/{k}", scale)


@pytest.mark.parametrize("name", list(CASES))
def test_free_steps_match_reference_float64(reference_x64, name):
    """``STEPS_F64`` steps from the reference's init, each package on its
    own state."""
    eng, data = _engine(name, torch.float64)
    ref = reference_x64
    st = _carried(ref, f"{name}/0")
    for k in range(STEPS_F64):
        st, m = eng.step(st, data)
    prefix = f"{name}/{STEPS_F64}"
    scale = float(np.abs(ref[f"{prefix}/theta/w"]).max())
    _close_scaled(st.theta["w"], ref[f"{prefix}/theta/w"], FREE_THETA_TOL,
                  "theta")
    _close_scaled(st.lam["w"], ref[f"{prefix}/lam/w"], FREE_LAM_TOL, "lam")
    _check_penalty(st.penalty, ref, prefix, FREE_ETA_RTOL)
    np.testing.assert_array_equal(st.t.numpy(), ref[f"{prefix}/t"])
    _check_residuals(m, ref, f"{name}/{STEPS_F64 - 1}", scale)


@pytest.mark.parametrize("name", list(CASES))
def test_run_iterations_match_reference_float64(reference_x64, name):
    eng, data = _engine(name, torch.float64)
    st = _carried(reference_x64, f"{name}/0")
    _, hist = eng.run(st, data, max_iters=RUN_MAX, rel_tol=RUN_TOL)
    got, want = hist["iterations"], int(reference_x64[f"{name}/iters"])
    assert len(hist["objective"]) == got
    if got != want:
        # allowed only where a float32 penalty decision flipped between
        # the two runs (their eta traces split by more than round-off),
        # and then by one iteration
        ref_eta = reference_x64[f"{name}/eta_mean"]
        n = min(got, want)
        split = np.abs(np.asarray(hist["eta_mean"][:n]) - ref_eta[:n]) \
            > 1e-3 * np.abs(ref_eta[:n])
        assert split.any() and abs(got - want) == 1, (got, want)


@pytest.mark.parametrize("name", F32_CASES)
def test_steps_match_reference_float32(reference, name):
    eng, data = _engine(name, torch.float32)
    st = _carried(reference, f"{name}/0")
    for _ in range(STEPS_F32):
        st, _ = eng.step(st, data)
    assert st.theta["w"].dtype == torch.float32
    _close_scaled(st.theta["w"], reference[f"{name}/{STEPS_F32}/theta/w"],
                  1e-4, "theta")


def _dyn_engine():
    A, b, _ = _lsq_problem(DYN_J, seed=3)
    data = (torch.as_tensor(A).double(), torch.as_tensor(b).double())
    eng = ConsensusADMM(objective=_objective,
                        penalty_cfg=PenaltyConfig(scheme="nap", eta0=1.0),
                        graph=build_graph("expander", DYN_J),
                        topology_cfg=TopologyConfig(**DYN_TOPO), **INNER)
    return eng, data


@pytest.mark.parametrize("mode", ["each_step", "free"])
def test_dense_dynamic_topology_matches_reference(reference_x64, mode):
    ref = reference_x64
    eng, data = _dyn_engine()
    st = _carried(ref, "dyn/0")
    graph_edges = int(eng.graph.adj.sum())
    gated = False
    for k in range(DYN_STEPS):
        if mode == "each_step":
            st = _carried(ref, f"dyn/{k}")
        if k == CHURN_AT:
            st = eng.apply_churn(st, VICTIM)
        st, m = eng.step(st, data)
        np.testing.assert_array_equal(st.topo.mask.numpy(),
                                      ref[f"dyn/{k + 1}/topo/mask"],
                                      err_msg=f"step {k}")
        # the jitted reference divides by the constant edge count as a
        # product with its reciprocal: one float32 rounding apart
        np.testing.assert_allclose(m["active_edges"].item(),
                                   ref[f"dyn/{k}/active_edges"], rtol=1e-6)
        tol = 1e-9 if mode == "each_step" else FREE_THETA_TOL
        _close_scaled(st.theta["w"], ref[f"dyn/{k + 1}/theta/w"], tol,
                      f"step {k}")
        gated |= k > CHURN_AT and int(st.topo.mask.sum()) < graph_edges - 8
    assert not st.topo.node_alive[VICTIM]
    # the budget scheduler gated graph edges after the drop (beyond the
    # victim's 8 directed edges), so the zero-kick absorption ran
    assert gated


def test_churn_needs_a_topology():
    eng, _ = _engine("nap/ring", torch.float64)
    st = eng.init({"w": torch.zeros(J, 4, dtype=torch.float64)})
    with pytest.raises(ValueError, match="topology_cfg"):
        eng.apply_churn(st, 1)
