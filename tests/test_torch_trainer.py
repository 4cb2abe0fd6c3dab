"""The port's sync consensus trainer against the reference ConsensusTrainer.

A subprocess runs the reference on a (2, 1, 1) ("pod", "data", "model") mesh
of two fake CPU devices: reduced qwen3-4b in float32, nap, ring,
local_steps=2, 6 steps, the fused Pallas round (interpret mode), plus one
int8-wire round. It saves the initial parameters and the per-step losses,
r_max and eta. The port runs the same schedule in-process from the
transplanted parameters.

Tolerances: the two frameworks round float32 matmuls and transcendentals
differently at the last bit, and six steps of AdamW carry that forward, so
losses hold to rtol 1e-4 and the round metrics (a square root of a sum over
every parameter, and the penalties that follow from the probes) to rtol
1e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.core.penalty import PenaltyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.models.params import from_jax
from repro_torch.optim import ConsensusConfig, ConsensusTrainer
from repro_torch.optim.adamw import AdamWConfig
from torch_round_cases import run_script
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

STEPS = 6

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import dataclasses
import jax, numpy as np
from repro.configs import get_reduced_config
from repro.core.penalty import PenaltyConfig
from repro.data import DataConfig, SyntheticTokens
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.optim import ConsensusConfig, ConsensusTrainer
from repro.optim.adamw import AdamWConfig

out_path, steps = sys.argv[1], int(sys.argv[2])
cfg = dataclasses.replace(get_reduced_config("qwen3-4b"), dtype="float32")
model = build_model(cfg)
mesh = make_mesh((2, 1, 1), ("pod", "data", "model"))
data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  batch_per_node=4, num_nodes=2))


def trainer(codec):
    return ConsensusTrainer(model, mesh, adamw=AdamWConfig(lr=1e-2),
                            consensus=ConsensusConfig(
                                penalty=PenaltyConfig(scheme="nap", eta0=0.1),
                                topology="ring", local_steps=2,
                                wire_codec=codec, use_fused_kernel=True))


tr = trainer("native")
state = tr.init_state(jax.random.PRNGKey(0))
out = {}
for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
    out["p/" + "/".join(k.key for k in path)] = np.asarray(leaf[0])
train, cons = jax.jit(tr.train_step), jax.jit(tr.consensus_step)
losses, r_max, eta = [], [], []
for step in range(steps):
    state, m = train(state, data.batch(step))
    losses.append(float(m["loss"]))
    if tr.should_sync(step):
        state, cm = cons(state, data.batch(10**6 + step))
        r_max.append(float(cm["r_max"]))
        eta.append(float(cm["eta_mean"]))
out.update(losses=np.asarray(losses), r_max=np.asarray(r_max),
           eta=np.asarray(eta), eta_final=np.asarray(state.penalty.eta))

tr8 = trainer("int8")
st8 = tr8.init_state(jax.random.PRNGKey(0))
st8, m8 = jax.jit(tr8.train_step)(st8, data.batch(0))
st8, cm8 = jax.jit(tr8.consensus_step)(st8, data.batch(10**6))
out.update(int8_loss=float(m8["loss"]), int8_r_max=float(cm8["r_max"]),
           int8_s_max=float(cm8["s_max"]), int8_eta=float(cm8["eta_mean"]))
np.savez(out_path, **out)
"""


def reference_path(tmp_path_factory) -> str:
    """The reference run's npz, computed once per test run (shared with
    ``test_torch_ranks.py``)."""
    return run_script("trainer", _REFERENCE, [STEPS], tmp_path_factory,
                      timeout=600)


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


def _trainer(codec: str):
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    model = build_model(cfg)
    tr = ConsensusTrainer(
        model, num_nodes=2, device="cpu", adamw=AdamWConfig(lr=1e-2),
        consensus=ConsensusConfig(
            penalty=PenaltyConfig(scheme="nap", eta0=0.1), topology="ring",
            local_steps=2, wire_codec=codec))
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      batch_per_node=4, num_nodes=2),
                           device="cpu")
    return tr, data


def test_trainer_trajectory_matches_reference(reference):
    tr, data = _trainer("native")
    state = tr.init_state(_transplanted(reference))
    losses, r_max, eta = [], [], []
    for step in range(STEPS):
        state, m = tr.train_step(state, data.batch(step))
        losses.append(float(m["loss"]))
        if tr.should_sync(step):
            state, cm = tr.consensus_step(state, data.batch(10**6 + step))
            r_max.append(float(cm["r_max"]))
            eta.append(float(cm["eta_mean"]))
    assert len(r_max) == STEPS // 2
    np.testing.assert_allclose(losses, reference["losses"], rtol=1e-4)
    np.testing.assert_allclose(r_max, reference["r_max"], rtol=1e-3)
    np.testing.assert_allclose(eta, reference["eta"], rtol=1e-3)
    np.testing.assert_allclose(state.penalty.eta.numpy(),
                               reference["eta_final"], rtol=1e-3)
    # nap moved the penalties off eta0
    assert np.any(np.abs(np.asarray(eta) - 0.1) > 1e-6)


def test_int8_wire_round_matches_reference(reference):
    tr, data = _trainer("int8")
    state = tr.init_state(_transplanted(reference))
    state, m = tr.train_step(state, data.batch(0))
    state, cm = tr.consensus_step(state, data.batch(10**6))
    np.testing.assert_allclose(float(m["loss"]), reference["int8_loss"],
                               rtol=1e-5)
    for k in ("r_max", "s_max"):
        np.testing.assert_allclose(float(cm[k]), reference[f"int8_{k}"],
                                   rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(float(cm["eta_mean"]), reference["int8_eta"],
                               rtol=1e-3)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.train import main
    assert main(["--reduced", "--steps", "4", "--local-steps", "2",
                 "--device", "cpu", "--wire-codec", "int8"]) == 0
    out = capsys.readouterr().out
    assert out.count("consensus r=") == 2


def test_launcher_rejects_unported_flags():
    from repro_torch.launch.train import parse_args
    for flag in (["--no-async-collectives"], ["--multi-pod"],
                 ["--mesh", "prod"],
                 ["--health"]):      # --health needs --obs-dir
        with pytest.raises(SystemExit):
            parse_args(flag)
    # the checkpoint flags (the reference's defaults) and --mesh debug
    # without --shard-consensus are ported
    args = parse_args(["--ckpt-dir", "x", "--mesh", "debug"])
    assert (args.ckpt_dir, args.ckpt_every, args.mesh) == ("x", 10, "debug")
    assert parse_args([]).ckpt_dir == ""
    # the obs flags are ported
    args = parse_args(["--obs-dir", "x", "--health", "--obs-ring-cap", "4",
                       "--obs-drain-every", "2", "--no-node-ring",
                       "--profile-rounds", "1"])
    assert (args.obs_dir, args.health, args.obs_ring_cap,
            args.obs_drain_every, args.no_node_ring,
            args.profile_rounds) == ("x", True, 4, 2, True, 1)
    # the async executor is ported: its flags parse, with the reference's
    # default bound
    args = parse_args(["--async", "--slow-node", "0:2.0"])
    assert args.async_mode and args.max_staleness == 2
    assert args.slow_node == "0:2.0"
    # the fp8 wires are ported: the launcher takes both formats
    for name in ("fp8_e4m3", "fp8_e5m2"):
        assert parse_args(["--wire-codec", name]).wire_codec == name
    # the ranks come from torchrun: the backend flag parses, an unknown
    # backend does not
    for name in ("nccl", "gloo"):
        assert parse_args(["--dist-backend", name]).dist_backend == name
    assert parse_args([]).dist_backend == ""
    with pytest.raises(SystemExit):
        parse_args(["--dist-backend", "mpi"])


def test_trainer_rejects_non_circulant_topology():
    cfg = get_reduced_config("qwen3-4b")
    with pytest.raises(ValueError, match="circulant"):
        ConsensusTrainer(build_model(cfg), num_nodes=4, device="cpu",
                         adamw=AdamWConfig(),
                         consensus=ConsensusConfig(topology="star"))
