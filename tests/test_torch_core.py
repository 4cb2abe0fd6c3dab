"""The port's graphs and penalty schedules against the reference.

The adjacency must be equal, and the penalty traces equal to float32
round-off: the two packages run the same f32 operations, so eta, cum_tau and
budget hold to 1e-6 relative over 20 rounds, and the integer counters
(n_incr, t) exactly.

The reference runs once per module in a fresh process
(``_reference_outputs``, through ``torch_round_cases.run_reference``); the
inputs of both sides come from the numpy generators below.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import graph, penalty
from torch_round_cases import run_reference
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

SIZES = (2, 3, 5, 8)
TAU_TOPOS = ("ring", "cluster", "complete")
TAU_DRAWS = 5
PENALTY_ROUNDS = 20
PENALTY_FIELDS = ("eta", "cum_tau", "budget", "f_prev", "n_incr", "t")


def _probes(rng, j):
    f_self = rng.uniform(1.0, 5.0, size=j).astype(np.float32)
    f_nbr = rng.uniform(1.0, 5.0, size=(j, j)).astype(np.float32)
    return f_self, f_nbr


def _tau_inputs():
    rng = np.random.default_rng(1)
    return [_probes(rng, 6) for _ in range(TAU_DRAWS)]


def _residuals(rng, j):
    # log-uniform so r > mu s, s > mu r and balanced rows all occur
    r = np.exp(rng.uniform(-4, 4, size=j)).astype(np.float32)
    s = np.exp(rng.uniform(-4, 4, size=j)).astype(np.float32)
    return r, s


def _penalty_inputs(j):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(PENALTY_ROUNDS):
        f_self, f_nbr = _probes(rng, j)
        out.append((f_self, f_nbr) + _residuals(rng, j))
    return out


def _penalty_kw(scheme):
    return dict(scheme=scheme, eta0=0.5, t_max=12, t_reset=12,
                budget_init=0.3)


def _reference_outputs():
    """The reference's graphs, taus and penalty traces (runs with JAX)."""
    import jax.numpy as jnp
    from repro.core import graph as jgraph
    from repro.core import penalty as jpen

    out = {"topologies": np.asarray(jgraph.TOPOLOGIES),
           "schemes": np.asarray(jpen.SCHEMES)}
    for topo in graph.TOPOLOGIES:
        for j in SIZES:
            key = f"graph/{topo}/{j}"
            try:
                g = jgraph.build_graph(topo, j)
            except ValueError as e:             # e.g. torus at a prime J
                out[f"{key}/error"] = np.asarray(str(e))
                continue
            out[f"{key}/adj"] = np.asarray(g.adj)
            out[f"{key}/offsets"] = np.asarray(g.neighbor_offsets_ring(),
                                               np.int64)
            out[f"{key}/name"] = np.asarray(g.name)
    for topo in TAU_TOPOS:
        adj = jnp.asarray(graph.build_graph(topo, 6).adj)
        for n, (f_self, f_nbr) in enumerate(_tau_inputs()):
            out[f"tau/{topo}/{n}"] = np.asarray(jpen.compute_tau(
                adj, jnp.asarray(f_self), jnp.asarray(f_nbr)))
    j = 6
    adj = jnp.asarray(graph.build_graph("cluster", j).adj)
    for scheme in penalty.SCHEMES:
        cfg = jpen.PenaltyConfig(**_penalty_kw(scheme))
        st = jpen.init_penalty_state(cfg, j)
        for n, (f_self, f_nbr, r, s) in enumerate(_penalty_inputs(j)):
            st = jpen.update_penalty(
                cfg, st, adj=adj, f_self=jnp.asarray(f_self),
                f_nbr=jnp.asarray(f_nbr), r_norm=jnp.asarray(r),
                s_norm=jnp.asarray(s))
            for name in PENALTY_FIELDS:
                out[f"pen/{scheme}/{n}/{name}"] = np.asarray(
                    getattr(st, name))
        out[f"pen/{scheme}/effective_eta"] = np.asarray(
            jpen.effective_eta(cfg, st, adj))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_core", tmp_path_factory)


@pytest.mark.parametrize("j", SIZES)
@pytest.mark.parametrize("topo", graph.TOPOLOGIES)
def test_adjacency_matches_reference(reference, topo, j):
    assert graph.TOPOLOGIES == tuple(reference["topologies"].tolist())
    key = f"graph/{topo}/{j}"
    if f"{key}/error" in reference:
        msg = str(reference[f"{key}/error"])
        with pytest.raises(ValueError, match=msg[:20]):
            graph.build_graph(topo, j)
        return
    got = graph.build_graph(topo, j)
    np.testing.assert_array_equal(got.adj, reference[f"{key}/adj"])
    assert got.neighbor_offsets_ring() == reference[f"{key}/offsets"].tolist()
    assert got.name == str(reference[f"{key}/name"])


@pytest.mark.parametrize("topo", TAU_TOPOS)
def test_compute_tau_matches_reference(reference, topo):
    g = graph.build_graph(topo, 6)
    for n, (f_self, f_nbr) in enumerate(_tau_inputs()):
        got = penalty.compute_tau(torch.as_tensor(g.adj),
                                  torch.from_numpy(f_self),
                                  torch.from_numpy(f_nbr))
        np.testing.assert_allclose(got.numpy(), reference[f"tau/{topo}/{n}"],
                                   rtol=1e-6, atol=1e-7)
    # degenerate neighborhood (all probes equal): tau = 0 in both
    flat = np.full(6, 2.0, np.float32)
    got = penalty.compute_tau(torch.as_tensor(g.adj), torch.from_numpy(flat),
                              torch.from_numpy(np.full((6, 6), 2.0,
                                                       np.float32)))
    assert float(got.abs().max()) == 0.0


@pytest.mark.parametrize("scheme", penalty.SCHEMES)
def test_update_penalty_trace_matches_reference(reference, scheme):
    assert penalty.SCHEMES == tuple(reference["schemes"].tolist())
    j = 6
    adj = torch.as_tensor(graph.build_graph("cluster", j).adj)
    cfg = penalty.PenaltyConfig(**_penalty_kw(scheme))
    st = penalty.init_penalty_state(cfg, j, device="cpu")
    for n, (f_self, f_nbr, r, s) in enumerate(_penalty_inputs(j)):
        st = penalty.update_penalty(
            cfg, st, adj=adj, f_self=torch.from_numpy(f_self),
            f_nbr=torch.from_numpy(f_nbr), r_norm=torch.from_numpy(r),
            s_norm=torch.from_numpy(s))
        want = {name: reference[f"pen/{scheme}/{n}/{name}"]
                for name in PENALTY_FIELDS}
        for name in ("eta", "cum_tau", "budget", "f_prev"):
            np.testing.assert_allclose(getattr(st, name).numpy(), want[name],
                                       rtol=1e-6, err_msg=name)
        np.testing.assert_array_equal(st.n_incr.numpy(), want["n_incr"])
        assert int(st.t) == int(want["t"])
    eff = penalty.effective_eta(cfg, st, adj)
    np.testing.assert_allclose(eff.numpy(),
                               reference[f"pen/{scheme}/effective_eta"],
                               rtol=1e-6)
