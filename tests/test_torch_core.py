"""The port's graphs and penalty schedules against the reference.

The adjacency must be equal, and the penalty traces equal to float32
round-off: the two packages run the same f32 operations, so eta, cum_tau and
budget hold to 1e-6 relative over 20 rounds, and the integer counters
(n_incr, t) exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import penalty as jpen
from repro_torch.core import graph, penalty

SIZES = (2, 3, 5, 8)


@pytest.mark.parametrize("j", SIZES)
@pytest.mark.parametrize("topo", graph.TOPOLOGIES)
def test_adjacency_matches_reference(topo, j):
    assert graph.TOPOLOGIES == jgraph.TOPOLOGIES
    try:
        want = jgraph.build_graph(topo, j)
    except ValueError as e:                  # e.g. torus at a prime J
        with pytest.raises(ValueError, match=str(e)[:20]):
            graph.build_graph(topo, j)
        return
    got = graph.build_graph(topo, j)
    np.testing.assert_array_equal(got.adj, want.adj)
    assert got.neighbor_offsets_ring() == want.neighbor_offsets_ring()
    assert got.name == want.name


def _probes(rng, j):
    f_self = rng.uniform(1.0, 5.0, size=j).astype(np.float32)
    f_nbr = rng.uniform(1.0, 5.0, size=(j, j)).astype(np.float32)
    return f_self, f_nbr


@pytest.mark.parametrize("topo", ["ring", "cluster", "complete"])
def test_compute_tau_matches_reference(topo):
    rng = np.random.default_rng(1)
    g = graph.build_graph(topo, 6)
    for _ in range(5):
        f_self, f_nbr = _probes(rng, 6)
        want = jpen.compute_tau(jnp.asarray(g.adj), jnp.asarray(f_self),
                                jnp.asarray(f_nbr))
        got = penalty.compute_tau(torch.as_tensor(g.adj),
                                  torch.from_numpy(f_self),
                                  torch.from_numpy(f_nbr))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    # degenerate neighborhood (all probes equal): tau = 0 in both
    flat = np.full(6, 2.0, np.float32)
    got = penalty.compute_tau(torch.as_tensor(g.adj), torch.from_numpy(flat),
                              torch.from_numpy(np.full((6, 6), 2.0,
                                                       np.float32)))
    assert float(got.abs().max()) == 0.0


def _residuals(rng, j):
    # log-uniform so r > mu s, s > mu r and balanced rows all occur
    r = np.exp(rng.uniform(-4, 4, size=j)).astype(np.float32)
    s = np.exp(rng.uniform(-4, 4, size=j)).astype(np.float32)
    return r, s


@pytest.mark.parametrize("scheme", penalty.SCHEMES)
def test_update_penalty_trace_matches_reference(scheme):
    assert penalty.SCHEMES == jpen.SCHEMES
    j = 6
    adj = graph.build_graph("cluster", j).adj
    kw = dict(scheme=scheme, eta0=0.5, t_max=12, t_reset=12,
              budget_init=0.3)
    jcfg, tcfg = jpen.PenaltyConfig(**kw), penalty.PenaltyConfig(**kw)
    jst = jpen.init_penalty_state(jcfg, j)
    tst = penalty.init_penalty_state(tcfg, j, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(20):
        f_self, f_nbr = _probes(rng, j)
        r, s = _residuals(rng, j)
        jst = jpen.update_penalty(
            jcfg, jst, adj=jnp.asarray(adj), f_self=jnp.asarray(f_self),
            f_nbr=jnp.asarray(f_nbr), r_norm=jnp.asarray(r),
            s_norm=jnp.asarray(s))
        tst = penalty.update_penalty(
            tcfg, tst, adj=torch.as_tensor(adj),
            f_self=torch.from_numpy(f_self), f_nbr=torch.from_numpy(f_nbr),
            r_norm=torch.from_numpy(r), s_norm=torch.from_numpy(s))
        for name in ("eta", "cum_tau", "budget", "f_prev"):
            np.testing.assert_allclose(getattr(tst, name).numpy(),
                                       np.asarray(getattr(jst, name)),
                                       rtol=1e-6, err_msg=name)
        np.testing.assert_array_equal(tst.n_incr.numpy(),
                                      np.asarray(jst.n_incr))
        assert int(tst.t) == int(jst.t)
    eff = penalty.effective_eta(tcfg, tst, torch.as_tensor(adj))
    np.testing.assert_allclose(
        eff.numpy(), np.asarray(jpen.effective_eta(jcfg, jst,
                                                   jnp.asarray(adj))),
        rtol=1e-6)
