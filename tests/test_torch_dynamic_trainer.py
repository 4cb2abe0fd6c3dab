"""The port's dynamic-topology trainer against the reference ConsensusTrainer.

A subprocess runs the reference on a (4, 1, 1) ("pod", "data", "model") mesh
of four fake CPU devices: reduced qwen3-4b in float32, nap, complete graph,
one local step per round, the fused Pallas round (interpret mode), under
two dynamic topologies:

  (a) ``round_robin`` with churn — edges gate every round, so non-zero
      zero-kick weights reach the round;
  (b) ``budget`` with churn, and node 2 dropped (``apply_churn``) after
      round 2 — a ghost row from round 3 on.

It saves the initial parameters and topology state and, per round, the
loss, ``r_max``, eta, ``active_edges``, the mask, node liveness and the
parked kicks. The port runs the same schedule in-process from the
transplanted parameters (``from_jax``) and topology state
(``topology.from_numpy``).

Tolerances: losses to rtol 1e-4 and the round metrics to rtol 1e-3, as in
``test_torch_trainer.py`` (float32 matmul round-off carried through the
steps); masks and liveness exactly; the kicks' support exactly and their
values (symmetrized penalties) to rtol 1e-3 like eta.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import get_reduced_config
from repro_torch.core.penalty import PenaltyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.models.params import from_jax
from repro_torch.optim import ConsensusConfig, ConsensusTrainer
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.topology import TopologyConfig, from_numpy
from torch_round_cases import run_script
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

ROUNDS = 5
DROP_AFTER = 2          # (b): node 2 is dropped after this round
CASES = {"a": dict(scheduler="round_robin", churn=True),
         "b": dict(scheduler="budget", churn=True, gate_tol=10.0)}

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, numpy as np
from repro.configs import get_reduced_config
from repro.core.penalty import PenaltyConfig
from repro.data import DataConfig, SyntheticTokens
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.optim import ConsensusConfig, ConsensusTrainer
from repro.optim.adamw import AdamWConfig
from repro.topology import TopologyConfig

out_path, rounds, drop_after = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = dataclasses.replace(get_reduced_config("qwen3-4b"), dtype="float32")
model = build_model(cfg)
mesh = make_mesh((4, 1, 1), ("pod", "data", "model"))
data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  batch_per_node=2, num_nodes=4))
cases = {"a": dict(scheduler="round_robin", churn=True),
         "b": dict(scheduler="budget", churn=True, gate_tol=10.0)}
out = {}
for name, dyn in cases.items():
    tr = ConsensusTrainer(model, mesh, adamw=AdamWConfig(lr=1e-2),
                          consensus=ConsensusConfig(
                              penalty=PenaltyConfig(scheme="nap", eta0=0.1),
                              topology="complete", local_steps=1,
                              use_fused_kernel=True,
                              dyn_topology=TopologyConfig(**dyn)))
    state = tr.init_state(jax.random.PRNGKey(0))
    if name == "a":
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state.params)[0]:
            out["p/" + "/".join(k.key for k in path)] = np.asarray(leaf[0])
    for k, v in state.topo._asdict().items():
        if k != "key":
            out[f"{name}/topo0/{k}"] = np.asarray(v)
    train, cons = jax.jit(tr.train_step), jax.jit(tr.consensus_step)
    rec = {k: [] for k in ("loss", "r_max", "eta", "active", "mask",
                           "alive", "kick")}
    for step in range(rounds):
        state, m = train(state, data.batch(step))
        state, cm = cons(state, data.batch(10**6 + step))
        rec["loss"].append(float(m["loss"]))
        rec["r_max"].append(float(cm["r_max"]))
        rec["eta"].append(float(cm["eta_mean"]))
        rec["active"].append(float(cm["active_edges"]))
        if name == "b" and step == drop_after:
            state = tr.apply_churn(state, 2)
        rec["mask"].append(np.asarray(state.topo.mask))
        rec["alive"].append(np.asarray(state.topo.node_alive))
        rec["kick"].append(np.asarray(state.topo.kick))
    for k, v in rec.items():
        out[f"{name}/{k}"] = np.asarray(v)
np.savez(out_path, **out)
"""


def reference_path(tmp_path_factory) -> str:
    """The reference run's npz, computed once per test run (shared with
    ``test_torch_ranks.py``)."""
    return run_script("dynamic", _REFERENCE, [ROUNDS, DROP_AFTER],
                      tmp_path_factory, timeout=900)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    with np.load(reference_path(tmp_path_factory)) as z:
        return {k: z[k] for k in z.files}


def _transplanted(ref):
    tree = {}
    for key, arr in ref.items():
        if key.startswith("p/"):
            node = tree
            *parents, leaf = key[2:].split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = arr
    return from_jax(tree)


def _trainer(dyn: TopologyConfig, topology: str = "complete"):
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    tr = ConsensusTrainer(
        build_model(cfg), num_nodes=4, device="cpu",
        adamw=AdamWConfig(lr=1e-2),
        consensus=ConsensusConfig(
            penalty=PenaltyConfig(scheme="nap", eta0=0.1), topology=topology,
            local_steps=1, dyn_topology=dyn))
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      batch_per_node=2, num_nodes=4),
                           device="cpu")
    return tr, data


def _run_port(ref, name):
    tr, data = _trainer(TopologyConfig(**CASES[name]))
    assert tr.dynamic and tr.offsets == [1, 2, 3]
    topo0 = {k[len(f"{name}/topo0/"):]: v for k, v in ref.items()
             if k.startswith(f"{name}/topo0/")}
    state = tr.init_state(_transplanted(ref))
    state = state._replace(topo=from_numpy(topo0, "cpu"))
    rec = {k: [] for k in ("loss", "r_max", "eta", "active", "mask",
                           "alive", "kick")}
    for step in range(ROUNDS):
        state, m = tr.train_step(state, data.batch(step))
        state, cm = tr.consensus_step(state, data.batch(10**6 + step))
        rec["loss"].append(float(m["loss"]))
        rec["r_max"].append(float(cm["r_max"]))
        rec["eta"].append(float(cm["eta_mean"]))
        rec["active"].append(float(cm["active_edges"]))
        if name == "b" and step == DROP_AFTER:
            state = tr.apply_churn(state, 2)
        rec["mask"].append(state.topo.mask.numpy())
        rec["alive"].append(state.topo.node_alive.numpy())
        rec["kick"].append(state.topo.kick.numpy())
    return {k: np.asarray(v) for k, v in rec.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dynamic_trajectory_matches_reference(reference, name):
    got = _run_port(reference, name)
    want = {k: reference[f"{name}/{k}"] for k in got}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for k in ("r_max", "eta", "active"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_array_equal(got["alive"], want["alive"])
    np.testing.assert_array_equal(got["kick"] != 0, want["kick"] != 0)
    np.testing.assert_allclose(got["kick"], want["kick"], rtol=1e-3)
    if name == "a":
        # round-robin gates edges, so kicks were parked and absorbed
        assert (got["kick"] != 0).any() and min(got["active"]) < 1.0
    else:
        assert got["alive"][-1].tolist() == [True, True, False, True]
        assert got["active"][DROP_AFTER + 1] < got["active"][DROP_AFTER]


def test_static_churn_equals_the_ungated_round():
    """``static`` with churn on ``complete`` (whose offset superset equals
    its graph offsets) runs the gated round with every gate open, and must
    equal the default ungated round bit for bit."""
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    params1 = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    states = []
    for dyn in (TopologyConfig(), TopologyConfig(scheduler="static",
                                                 churn=True)):
        tr, data = _trainer(dyn)
        state = tr.init_state(params1)
        state, _ = tr.train_step(state, data.batch(0))
        for step in range(2):
            state, _ = tr.consensus_step(state, data.batch(10**6 + step))
        states.append(state)
    a, b = states
    for u, v in zip(tree_lib.leaves(a.params), tree_lib.leaves(b.params),
                    strict=True):
        assert torch.equal(u, v)
    for name in ("lam", "theta_bar_prev"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.penalty.eta, b.penalty.eta)


def test_dead_offsets_skip_their_probe(monkeypatch):
    """An offset with no active edge and no pending kick runs no probe
    forward; with every edge gated but the backbone ring, complete J=4
    probes only offsets 1 and 3 (offset 2 is all gated)."""
    tr, data = _trainer(TopologyConfig(scheduler="budget", churn=True))
    state = tr.init_state(build_model(tr.model.cfg).init(
        torch.Generator().manual_seed(1), "cpu"))
    ring = torch.as_tensor(tr.topo_rt.backbone)
    state = state._replace(topo=state.topo._replace(mask=ring))
    calls = []
    orig = tr._probe_losses
    monkeypatch.setattr(tr, "_probe_losses",
                        lambda p, b: calls.append(1) or orig(p, b))
    state, m = tr.consensus_step(state, data.batch(10**6))
    assert len(calls) == 1 + 2          # own probe + two live offsets
    assert float(m["active_edges"]) == pytest.approx(8 / 12)
    assert np.isfinite(float(m["r_max"]))


def test_trainer_refuses_stale_and_static_churn_drop():
    # the stale scheduler is ported: it builds a gated, kicking trainer
    tr, _ = _trainer(TopologyConfig(scheduler="stale"))
    assert tr.dynamic and tr.topo_cfg.can_gate and tr.async_cfg is None
    tr, _ = _trainer(TopologyConfig())
    assert not tr.dynamic
    with pytest.raises(ValueError, match="churn"):
        tr.apply_churn(tr.init_state(build_model(tr.model.cfg).init(
            torch.Generator().manual_seed(0), "cpu")), 1)


def test_launcher_dynamic_path_on_cpu(capsys):
    from repro_torch.launch.train import main
    before = kops.consensus_round.masked_launches
    assert main(["--reduced", "--steps", "6", "--local-steps", "2",
                 "--nodes", "3", "--topo-scheduler", "budget",
                 "--drop-node", "3:1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("active=") == 3
    assert "dropped node 1 (topology epoch)" in out
    assert "active=0.33" in out.splitlines()[5]
    # on the CPU the plain version runs: nothing is launched
    assert kops.consensus_round.masked_launches == before


def test_launcher_run_records_rounds():
    from repro_torch.launch.train import parse_args, run
    args = parse_args(["--reduced", "--steps", "4", "--local-steps", "2",
                       "--nodes", "4", "--topology", "complete",
                       "--topo-scheduler", "round_robin", "--drop-node",
                       "1:2", "--device", "cpu"])
    record = run(get_reduced_config("qwen3-4b"), args)
    rounds = record["rounds"]
    assert [r["alive"] for r in rounds] == [[True] * 4,
                                            [True, True, False, True]]
    assert all(r["launches"] == 0 and r["masked_launches"] == 0
               for r in rounds)
    assert record["offsets"] == [1, 2, 3]


def test_launcher_refuses_stale_scheduler():
    from repro_torch.launch.train import parse_args
    # the stale scheduler is ported: the launcher takes it, and refuses an
    # unknown one
    assert parse_args(["--topo-scheduler", "stale"]).topo_scheduler \
        == "stale"
    with pytest.raises(SystemExit):
        parse_args(["--topo-scheduler", "gossip"])
    args = parse_args(["--drop-node", "5:1"])
    assert args.topo_scheduler == "static" and args.drop_node == "5:1"
