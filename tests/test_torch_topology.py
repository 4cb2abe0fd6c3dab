"""The port's dynamic topology against the reference ``repro.topology``.

Every circulant graph builder (ring, complete, expander) at J = 4, 6, 8:
backbones, rotation masks, the offset superset, the edge universe and the
expected active fraction and offsets are equal; 20-epoch traces of the
``static``, ``budget`` and ``round_robin`` schedulers from the same penalty
and residual inputs give equal states; the budget latch and its revival,
and node drops with churn repair (ring spares, a star's cut vertex), give
equal states. All of it is boolean or integer (the kicks are carried, not
computed), so every comparison is exact. The ``random`` scheduler draws
from torch rather than JAX, so it is held to its invariants instead: a
symmetric pattern that keeps the backbone, the same draw within a period,
and a keep rate within a binomial bound. The fault-tolerance helpers are
held against the reference on the same inputs (exactly).

The reference runs once per module in a fresh process
(``_reference_outputs``, through ``torch_round_cases.run_reference``); the
inputs of both sides come from the numpy generators below.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import graph, penalty
from repro_torch.runtime import fault_tolerance as ft
from repro_torch import topology as topo
from torch_round_cases import run_reference
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

BUILDERS = ("ring", "complete", "expander")
SIZES = (4, 6, 8)
EPOCHS = 20
FIELDS = ("mask", "backbone", "repair", "node_alive", "epoch", "t", "age",
          "kick")
TRACED = ("static", "budget", "round_robin")
BAD_CONFIGS = (dict(scheduler="gossip"), dict(activation_p=0.0),
               dict(period=0))


# ------------------------------------------------------- shared inputs ----
def _penalty_arrays(rng, j, t):
    """Penalty state arrays whose budgets are spent on about half the edges
    (a top-up revives some in later epochs), and residuals straddling the
    gate tolerance."""
    budget = np.full((j, j), 1.0, np.float32)
    cum_tau = rng.uniform(0.0, 2.0, size=(j, j)).astype(np.float32)
    if t >= EPOCHS // 2:
        budget = (budget + (rng.uniform(size=(j, j)) < 0.3) * 2.0).astype(
            np.float32)
    return dict(eta=rng.uniform(0.05, 0.2, size=(j, j)).astype(np.float32),
                cum_tau=cum_tau, budget=budget,
                n_incr=np.zeros((j, j), np.int32),
                f_prev=rng.uniform(1.0, 2.0, size=j).astype(np.float32),
                t=np.asarray(t, np.int32),
                r=(rng.uniform(size=j) * 2e-4).astype(np.float32))


def _trace_inputs(builder, j):
    rng = np.random.default_rng(100 * j + len(builder))
    return [_penalty_arrays(rng, j, t) for t in range(EPOCHS)]


def _trace_cfg(scheduler):
    return dict(scheduler=scheduler, churn=True, gate_tol=1e-4, period=2)


def _drop_plan(builder, j):
    sched = "static" if builder == "star" else "round_robin"
    victims = (0, j // 2) if builder == "star" else (1, j - 2)
    return sched, victims


def _star(j):
    adj = np.zeros((j, j), bool)
    for leaf in range(1, j):            # 0 is a cut vertex
        adj[0, leaf] = adj[leaf, 0] = True
    return adj


# one stale epoch on complete J=4: the chord (0, 2) is 2 rounds old in one
# direction, past the default bound of 1; the backbone ring never gates
_STALE_AGE = np.array([[0, 0, 0, 1], [2, 0, 1, 0], [2, 0, 0, 0],
                       [1, 0, 0, 0]], np.int32)


def _durations():
    rng = np.random.default_rng(9)
    out = []
    for _ in range(12):
        d = rng.uniform(0.9, 1.1, size=5)
        d[3] *= 4.0                      # node 3 straggles
        out.append(d)
    return out + [np.ones(5), np.array([1, 1, 1, 9, 1.0])]


def _flagged(monitor):
    """The monitor's flags over ``_durations``, one bitmask per step."""
    return [sum(1 << i for i in monitor.observe(d)) for d in _durations()]


# ----------------------------------------------------------- reference ----
def _reference_outputs():
    """Every reference value the tests compare with (runs with JAX)."""
    import jax.numpy as jnp
    from repro import topology as jt
    from repro.core import graph as jg
    from repro.core import penalty as jp
    from repro.runtime import fault_tolerance as jft

    out = {}

    def put_state(key, st):
        for f in FIELDS:
            out[f"{key}/{f}"] = np.asarray(getattr(st, f))

    def pen(a):
        return jp.PenaltyState(**{k: jnp.asarray(v) for k, v in a.items()
                                  if k != "r"})

    for builder in BUILDERS:
        for j in SIZES:
            g = jg.build_graph(builder, j)
            for churn in (False, True):
                for sched in jt.SCHEDULERS:
                    cfg = jt.TopologyConfig(scheduler=sched, churn=churn)
                    rt = jt.TopologyRuntime(g, cfg)
                    k = f"struct/{builder}/{j}/{churn}/{sched}"
                    out[f"{k}/backbone"] = rt.backbone
                    out[f"{k}/rotation"] = rt.rotation
                    out[f"{k}/offsets"] = np.asarray(rt.offsets)
                    out[f"{k}/universe"] = rt.edge_universe
                    out[f"{k}/fractions"] = np.asarray(
                        [rt.expected_active_fraction(),
                         rt.expected_active_offsets()])
                    out[f"{k}/flags"] = np.asarray([cfg.is_dynamic,
                                                    cfg.can_gate])
                put_state(f"init/{builder}/{j}/{churn}", rt.init_state())
            for sched in TRACED:
                rt = jt.TopologyRuntime(g, jt.TopologyConfig(
                    **_trace_cfg(sched)))
                st = rt.init_state()
                for t, a in enumerate(_trace_inputs(builder, j)):
                    st = rt.update(st, penalty=pen(a),
                                   r_norm=jnp.asarray(a["r"]))
                    put_state(f"trace/{builder}/{j}/{sched}/{t}", st)
            rt = jt.TopologyRuntime(g, jt.TopologyConfig(scheduler="budget",
                                                         gate_tol=1e-2))
            st = rt.init_state()
            p0 = jp.init_penalty_state(jp.PenaltyConfig(scheme="nap"), j)
            p0 = p0._replace(cum_tau=p0.budget + 1.0)
            for n, r in enumerate((0.0, 1e3)):
                st = rt.update(st, penalty=p0, r_norm=jnp.full(j, r))
                put_state(f"latch/{builder}/{j}/{n}", st)
            st = rt.update(st, penalty=p0._replace(budget=p0.cum_tau + 1.0),
                           r_norm=jnp.full(j, 1e3))
            put_state(f"latch/{builder}/{j}/2", st)
    for builder in BUILDERS + ("star",):
        for j in SIZES:
            sched, victims = _drop_plan(builder, j)
            rt = jt.TopologyRuntime(jg.build_graph(builder, j),
                                    jt.TopologyConfig(scheduler=sched,
                                                      churn=True))
            st = rt.init_state()
            p0 = jp.init_penalty_state(jp.PenaltyConfig(scheme="nap"), j)
            for n, v in enumerate(victims):
                st = rt.drop_node(st, v)
                put_state(f"drop/{builder}/{j}/{n}/dropped", st)
                st = rt.update(st, penalty=p0, r_norm=jnp.zeros(j))
                put_state(f"drop/{builder}/{j}/{n}/updated", st)

    # state transplant: a budget runtime on complete J=5 after one drop
    rt = jt.TopologyRuntime(jg.build_graph("complete", 5),
                            jt.TopologyConfig(scheduler="budget"))
    st = rt.drop_node(rt.init_state(), 3)
    put_state("numpy/state", st)
    out["numpy/fraction"] = np.asarray(
        jt.active_edge_fraction(st, jnp.asarray(rt.graph.adj)))
    out["numpy/degree"] = np.asarray(jt.active_degree(st))

    for j in (5, 7):
        for node in range(j):
            out[f"graph/{j}/{node}"] = jg.drop_node(
                jg.Graph(j, _star(j), "star"), node).adj
        m = _star(j)
        m[0] = m[:, 0] = False
        comps = jg.connected_components(m)
        out[f"graph/{j}/comps"] = np.asarray([i for c in comps for i in c]
                                             + [-1] * len(comps))

    a = _penalty_arrays(np.random.default_rng(4), 6, 0)
    out["gate/exhausted"] = np.asarray(jp.budget_exhausted(pen(a)))
    for name, prev in (("none", None), ("prev", np.eye(6, k=1, dtype=bool))):
        out[f"gate/{name}"] = np.asarray(jt.budget_gate(
            pen(a), jnp.linspace(0, 2e-4, 6), 1e-4,
            None if prev is None else jnp.asarray(prev)))

    out["ft/slow"] = np.asarray(_flagged(jft.StragglerMonitor(5)))
    a = _penalty_arrays(np.random.default_rng(9), 5, 0)
    shrunk = jft.shrink_penalty_state(pen(a), 2)
    for f in ("eta", "cum_tau", "budget", "n_incr", "f_prev", "t"):
        out[f"ft/shrink/{f}"] = np.asarray(getattr(shrunk, f))
    ring6 = jt.TopologyRuntime(jg.build_graph("ring", 6),
                               jt.TopologyConfig(churn=True))
    ctl = jft.ElasticController(jg.build_graph("ring", 6), topology=ring6)
    put_state("ft/elastic", ctl.drop_preserving(4, ring6.init_state(), 3))
    ev = ctl.events[-1]
    out["ft/event"] = np.asarray([ev.step, ev.victim, ev.old_nodes,
                                  ev.new_nodes])
    g2, _ = ctl.drop(1, jp.init_penalty_state(jp.PenaltyConfig(), 6), 5)
    out["ft/shrunk_adj"] = g2.adj

    refused = []
    for cfg in BAD_CONFIGS:
        try:
            jt.TopologyConfig(**cfg)
            refused.append(False)
        except ValueError:
            refused.append(True)
    out["config/refused"] = np.asarray(refused)
    rt = jt.TopologyRuntime(jg.build_graph("complete", 4),
                            jt.TopologyConfig(scheduler="stale"))
    st = rt.update(rt.init_state()._replace(age=jnp.asarray(_STALE_AGE)))
    put_state("config/stale", st)
    out["config/schedulers"] = np.asarray(jt.SCHEDULERS)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("test_torch_topology", tmp_path_factory)


# --------------------------------------------------------------- tests ----
def _assert_state(port_st, ref, key):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port_st, f).numpy(),
                                      ref[f"{key}/{f}"], err_msg=f"{key} {f}")


def _penalty(a):
    return penalty.PenaltyState(**{k: torch.from_numpy(np.asarray(v))
                                   for k, v in a.items() if k != "r"})


def _runtime(builder, j, **cfg):
    return topo.TopologyRuntime(graph.build_graph(builder, j),
                                topo.TopologyConfig(**cfg))


@pytest.mark.parametrize("churn", [False, True])
@pytest.mark.parametrize("j", SIZES)
@pytest.mark.parametrize("builder", BUILDERS)
def test_static_structures_match_reference(ref, builder, j, churn):
    for sched in topo.SCHEDULERS:
        rt = _runtime(builder, j, scheduler=sched, churn=churn)
        k = f"struct/{builder}/{j}/{churn}/{sched}"
        np.testing.assert_array_equal(rt.backbone, ref[f"{k}/backbone"])
        np.testing.assert_array_equal(rt.rotation, ref[f"{k}/rotation"])
        assert rt.offsets == ref[f"{k}/offsets"].tolist()
        np.testing.assert_array_equal(rt.edge_universe, ref[f"{k}/universe"])
        assert [rt.expected_active_fraction(),
                rt.expected_active_offsets()] \
            == ref[f"{k}/fractions"].tolist(), sched
        assert [rt.cfg.is_dynamic, rt.cfg.can_gate] \
            == ref[f"{k}/flags"].tolist(), sched
    _assert_state(rt.init_state("cpu"), ref, f"init/{builder}/{j}/{churn}")


@pytest.mark.parametrize("scheduler", TRACED)
@pytest.mark.parametrize("j", SIZES)
@pytest.mark.parametrize("builder", BUILDERS)
def test_scheduler_trace_matches_reference(ref, builder, j, scheduler):
    rt = _runtime(builder, j, **_trace_cfg(scheduler))
    st = rt.init_state("cpu")
    adj = torch.as_tensor(rt.graph.adj)
    gated = 0
    for t, a in enumerate(_trace_inputs(builder, j)):
        st = rt.update(st, penalty=_penalty(a),
                       r_norm=torch.from_numpy(a["r"]))
        _assert_state(st, ref, f"trace/{builder}/{j}/{scheduler}/{t}")
        gated += int((~st.mask & adj).sum())
    if scheduler != "static" and not np.array_equal(rt.backbone,
                                                    rt.graph.adj):
        assert gated > 0, "the trace never gated an edge"


@pytest.mark.parametrize("j", SIZES)
@pytest.mark.parametrize("builder", BUILDERS)
def test_budget_latch_and_revival_match_reference(ref, builder, j):
    rt = _runtime(builder, j, scheduler="budget", gate_tol=1e-2)
    st = rt.init_state("cpu")
    p0 = penalty.init_penalty_state(penalty.PenaltyConfig(scheme="nap"), j,
                                    device="cpu")
    # exhaust every budget, residuals below tolerance: non-backbone gated;
    # then residuals drift back up and the latch holds
    p0 = p0._replace(cum_tau=p0.budget + 1.0)
    for n, r in enumerate((0.0, 1e3)):
        st = rt.update(st, penalty=p0, r_norm=torch.full((j,), r))
        _assert_state(st, ref, f"latch/{builder}/{j}/{n}")
    latched = st.mask.clone()
    # a top-up (budget above cum_tau) revives every edge
    st = rt.update(st, penalty=p0._replace(budget=p0.cum_tau + 1.0),
                   r_norm=torch.full((j,), 1e3))
    _assert_state(st, ref, f"latch/{builder}/{j}/2")
    np.testing.assert_array_equal(st.mask.numpy(), rt.graph.adj)
    if not np.array_equal(rt.backbone, rt.graph.adj):
        assert not torch.equal(latched, st.mask)


@pytest.mark.parametrize("j", SIZES)
@pytest.mark.parametrize("builder", BUILDERS + ("star",))
def test_drop_node_repair_matches_reference(ref, builder, j):
    """Two drops in a row, each followed by a scheduler epoch: a ring needs
    its churn spares to repair, a star loses its cut vertex first."""
    sched, victims = _drop_plan(builder, j)
    rt = _runtime(builder, j, scheduler=sched, churn=True)
    st = rt.init_state("cpu")
    p0 = penalty.init_penalty_state(penalty.PenaltyConfig(scheme="nap"), j,
                                    device="cpu")
    for n, v in enumerate(victims):
        st = rt.drop_node(st, v)
        _assert_state(st, ref, f"drop/{builder}/{j}/{n}/dropped")
        st = rt.update(st, penalty=p0, r_norm=torch.zeros(j))
        _assert_state(st, ref, f"drop/{builder}/{j}/{n}/updated")
    alive = st.node_alive.numpy()
    comps = [c for c in graph.connected_components(
        st.mask.numpy() & alive[:, None] & alive[None, :]) if alive[c[0]]]
    assert len(comps) == 1
    # dropping a ghost again changes nothing
    assert rt.drop_node(st, victims[0]) is st


def test_drop_node_keeps_device_dtype_and_shape():
    rt = _runtime("ring", 6, churn=True)
    st = rt.init_state("cpu")._replace(kick=torch.full((6, 6), 0.5))
    new = rt.drop_node(st, 2)
    for a, b in zip(new, st):
        if isinstance(a, torch.Tensor):
            assert (a.shape, a.dtype, a.device) == (b.shape, b.dtype,
                                                    b.device)
    assert float(new.kick[2].abs().sum() + new.kick[:, 2].abs().sum()) == 0
    assert int(new.repair.sum()) == 0            # a path still spans
    # a second drop splits the path: the ring repairs through a spare
    assert int(rt.drop_node(new, 5).repair.sum()) > 0
    with pytest.raises(ValueError, match="out of range"):
        rt.drop_node(st, 6)


@pytest.mark.parametrize("p", [0.3, 0.7])
@pytest.mark.parametrize("j", SIZES)
def test_random_scheduler_invariants(j, p):
    rt = _runtime("complete", j, scheduler="random", activation_p=p,
                  period=2, seed=5)
    st = rt.init_state("cpu")
    bb = torch.as_tensor(rt.backbone)
    masks = []
    for _ in range(40):
        st = rt.update(st)
        m = st.mask
        assert torch.equal(m, m.T) and not m.diagonal().any()
        assert bool((m | ~bb).all()), "backbone must stay active"
        masks.append(m.clone())
    for a, b in zip(masks[0::2], masks[1::2]):
        assert torch.equal(a, b)           # the same draw within a period
    # off the backbone, edges are kept with probability p: 20 draws of the
    # free pairs, within 5 binomial standard deviations
    free = np.triu(rt.graph.adj & ~rt.backbone, 1)
    kept = np.array([np.asarray(m)[free].sum() for m in masks[0::2]])
    n = free.sum() * len(kept)
    assert abs(kept.sum() - p * n) <= 5 * np.sqrt(n * p * (1 - p)) + 1
    # the same seed and epoch draw the same pattern anew
    again = rt.update(rt.init_state("cpu"))
    assert torch.equal(again.mask, masks[0])


def test_stale_scheduler_raises_and_configs_validate(ref):
    rt = _runtime("ring", 4, scheduler="stale")
    assert rt.expected_active_fraction() == 1.0
    # the stale epoch is ported: it equals the reference's
    rt = _runtime("complete", 4, scheduler="stale")
    st = rt.update(rt.init_state("cpu")._replace(
        age=torch.from_numpy(_STALE_AGE)))
    _assert_state(st, ref, "config/stale")
    assert not st.mask[0, 2] and not st.mask[2, 0]
    assert int(st.mask.sum()) == 10
    assert ref["config/refused"].all()
    for bad in BAD_CONFIGS:
        with pytest.raises(ValueError):
            topo.TopologyConfig(**bad)
    with pytest.raises(ValueError, match="budget-spending"):
        topo.TopologyConfig(scheduler="budget").validate_penalty(
            penalty.PenaltyConfig(scheme="ap"))
    assert list(topo.SCHEDULERS) == ref["config/schedulers"].tolist()


def test_state_from_numpy_and_counters(ref):
    st = topo.from_numpy({f: ref[f"numpy/state/{f}"] for f in FIELDS},
                         "cpu", seed=7)
    _assert_state(st, ref, "numpy/state")
    assert st.seed == 7
    adj = torch.as_tensor(graph.build_graph("complete", 5).adj)
    assert float(topo.active_edge_fraction(st, adj)) \
        == float(ref["numpy/fraction"])
    np.testing.assert_array_equal(topo.active_degree(st).numpy(),
                                  ref["numpy/degree"])


@pytest.mark.parametrize("j", (5, 7))
def test_graph_helpers_match_reference(ref, j):
    for node in range(j):
        got = graph.drop_node(graph.Graph(j, _star(j), "star"), node)
        np.testing.assert_array_equal(got.adj, ref[f"graph/{j}/{node}"])
    m = _star(j)
    m[0] = m[:, 0] = False
    comps = graph.connected_components(m)
    assert [i for c in comps for i in c] + [-1] * len(comps) \
        == ref[f"graph/{j}/comps"].tolist()


def test_budget_exhausted_matches_reference(ref):
    a = _penalty_arrays(np.random.default_rng(4), 6, 0)
    np.testing.assert_array_equal(
        penalty.budget_exhausted(_penalty(a)).numpy(), ref["gate/exhausted"])
    for name, prev in (("none", None), ("prev", np.eye(6, k=1, dtype=bool))):
        got = topo.budget_gate(_penalty(a), torch.linspace(0, 2e-4, 6), 1e-4,
                               None if prev is None else torch.as_tensor(prev))
        np.testing.assert_array_equal(got.numpy(), ref[f"gate/{name}"])


def test_fault_tolerance_matches_reference(ref):
    flagged = _flagged(ft.StragglerMonitor(5))
    assert flagged == ref["ft/slow"].tolist()
    assert flagged[-1] == 1 << 3               # node 3 flagged

    a = _penalty_arrays(np.random.default_rng(9), 5, 0)
    got = ft.shrink_penalty_state(_penalty(a), 2)
    for f in ("eta", "cum_tau", "budget", "n_incr", "f_prev", "t"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      ref[f"ft/shrink/{f}"])

    calls, slept = [], []

    def flaky(x):
        calls.append(x)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return x * 2

    wrapped = ft.with_retries(flaky, ft.RetryPolicy(backoff_s=0.1),
                              sleep=slept.append)
    assert wrapped(4) == 8 and slept == [0.1, 0.2]
    with pytest.raises(OSError):          # retried once, then raised
        ft.with_retries(lambda: (_ for _ in ()).throw(OSError("x")),
                        ft.RetryPolicy(max_retries=1), sleep=slept.append)()
    assert slept == [0.1, 0.2, 0.5]


def test_elastic_controller_matches_reference(ref):
    g = graph.build_graph("ring", 6)
    rt = topo.TopologyRuntime(g, topo.TopologyConfig(churn=True))
    ctl = ft.ElasticController(g, topology=rt)
    st = ctl.drop_preserving(4, rt.init_state("cpu"), step=3)
    _assert_state(st, ref, "ft/elastic")
    ev = ctl.events[-1]
    assert [ev.step, ev.victim, ev.old_nodes, ev.new_nodes] \
        == ref["ft/event"].tolist() and ev.mode == "preserve"
    p6 = penalty.init_penalty_state(penalty.PenaltyConfig(), 6, device="cpu")
    g2, p2 = ctl.drop(1, p6, step=5)
    np.testing.assert_array_equal(g2.adj, ref["ft/shrunk_adj"])
    assert p2.eta.shape == (5, 5)
    with pytest.raises(ValueError, match="TopologyRuntime"):
        ft.ElasticController(g).drop_preserving(0, st, step=0)
