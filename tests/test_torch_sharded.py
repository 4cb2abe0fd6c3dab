"""The consensus trainer with its flat state sharded in-pod
(``ConsensusConfig.shard_consensus``): R = J * S gloo ranks on the CPU,
rank r holding node r // S whole and slab r % S of its flat rows.

(a) The sharded ranks against one process computing the same S-way
    sharded run whole (``trivial_grid(J, shards=S)``), bit for bit:
    reduced qwen3-4b in float32, 6 steps; J 2 x S 2 on the native, int8
    and fp8_e4m3 wires (one spawn of four ranks runs them all), and the
    dynamic budget scheduler with churn at J 3 x S 2, node 2 dropped, obs
    rings on, and the async executor at J 3 x S 2 (stale scheduler,
    fp8_e4m3, node 0 3x slow, ``pipeline_offsets`` 2, against depth 1; one
    spawn of six ranks for both). Every rank's replicated state,
    steps' and rounds' metrics and node-ring rows equal the one
    process's; the S replicas of a node's parameters and moments are equal
    and equal its row there; its slabs of lam and theta_bar_prev, joined,
    equal its rows there, as do its slabs of the wire ledger (each rank's
    ``[deg, 1, shard_wire_width]``); each rank's lam is
    ``[1, shard_total]``.
(b) The same four ranks from the reference's parameters against the
    reference trajectory that ``test_torch_trainer.py`` records (one
    reference process a test run, shared), at its tolerances: losses rtol
    1e-4, r_max and eta_mean 1e-3.
(c) The launcher under ``torchrun``, four ranks, ``--shard-consensus``:
    rank 0 alone prints, its consensus lines equal those of one process
    running the launcher on ``trivial_grid(2, "cpu", shards=2)``.
(d) The refusals: R not a multiple of J, NCCL for ranks sharing a card,
    a sharded grid without ``shard_consensus``; and what is accepted since
    the sharded ledger: a slab rank's trainer with the async executor or
    pipelined offsets, the one-process launcher with ``--async
    --pipeline-offsets 2`` (its consensus lines equal depth 1's), and the
    async executor on a sharded trainer.

Every process runs torch on one thread, so that the one-process run and
the ranks sum in the same order. A spawn serves every test that reads it:
the xdist workers of one run share it under a file lock.
"""
import dataclasses
import fcntl
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_trainer as trainer_test
import torch_ranks_cases as cases
from test_torch_ranks import DYN, ROUND_LINE, SRC, _same, one_thread
from repro_torch.async_exec import AsyncConfig
from repro_torch.configs import get_reduced_config
from repro_torch.distributed import RankGrid, gather_pod, trivial_grid
from repro_torch.launch import mesh
from repro_torch.models import build_model
from repro_torch.optim import ConsensusConfig, ConsensusTrainer
from repro_torch.optim.adamw import AdamWConfig
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

STATIC = {codec: dict(j=2, shards=2, topology="ring", local_steps=2,
                      codec=codec, steps=6, batch=2)
          for codec in ("native", "int8", "fp8_e4m3")}
DYNAMIC = {"dynamic": dict(j=3, shards=2, topology="complete",
                           local_steps=1, dyn=DYN, drop=(2, 2), obs=True,
                           steps=6, batch=2),
           "async": dict(j=3, shards=2, topology="ring", local_steps=1,
                         codec="fp8_e4m3",
                         dyn=dict(scheduler="stale", max_staleness=1),
                         async_=dict(max_staleness=1, slow=3.0), pipe=2,
                         steps=4, batch=2)}


def _shared_dir(tmp_path_factory, name):
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent                  # the run's, shared by workers
    d = base / name
    d.mkdir(exist_ok=True)
    return d


def _spawned(tmp_path_factory, name, specs, world):
    """``specs`` run once per test run on ``world`` sharded ranks; returns
    name -> the ranks' outputs."""
    d = _shared_dir(tmp_path_factory, name)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "done").exists():
            cases.spawn(cases.specs_worker, world, d, str(d), specs, True)
            (d / "done").touch()
    return {k: [torch.load(d / f"{k}.{r}.pt") for r in range(world)]
            for k in specs}


@pytest.fixture(scope="module")
def static_ranks(tmp_path_factory):
    ref = dict(j=2, shards=2, topology="ring", local_steps=2,
               steps=trainer_test.STEPS, batch=4,
               params=trainer_test.reference_path(tmp_path_factory))
    return _spawned(tmp_path_factory, "sharded_static",
                    dict(STATIC, reference=ref), 4)


@pytest.fixture(scope="module")
def dynamic_ranks(tmp_path_factory):
    return _spawned(tmp_path_factory, "sharded_dynamic", DYNAMIC, 6)


def _hold(got, want, spec):
    """Every sharded rank's output ``got`` against the one-process
    ``want``, bit for bit (module docstring, (a))."""
    s = spec["shards"]
    assert len(got) == spec["j"] * s
    for r, out in enumerate(got):
        assert out["grid"] == (r // s, r % s, s)
        for k in ("loss", "grad_norm", "rounds", "mask", "alive", "kick",
                  "eta", "w_prev", "replicated", "wire_bytes"):
            _same(out[k], want[k], f"rank {r} {k}")
    shard_total = want["rows"]["lam"].shape[1] // s
    for r, out in enumerate(got):
        node = r // s
        for k in ("params", "m", "v"):
            _same([x[0] for x in out["rows"][k]],
                  [x[node] for x in want["rows"][k]], f"rank {r} {k}")
        for k in ("lam", "bar"):
            assert out["rows"][k].shape == (1, shard_total)
    for node in range(spec["j"]):
        for k in ("lam", "bar"):
            joined = torch.cat([got[node * s + k2]["rows"][k][0]
                                for k2 in range(s)])
            _same(joined, want["rows"][k][node], f"node {node} {k}")
        if want["ledger"] is not None:
            joined = torch.cat([got[node * s + k2]["ledger"]
                                for k2 in range(s)], dim=-1)
            _same(joined, want["ledger"][:, node:node + 1],
                  f"node {node} ledger")
    assert len(want["rounds"]) == spec["steps"] // spec["local_steps"]


@pytest.mark.parametrize("codec", list(STATIC))
def test_sharded_ranks_equal_one_process(static_ranks, codec):
    spec = STATIC[codec]
    with one_thread():
        want = cases.run_trainer(spec)
    _hold(static_ranks[codec], want, spec)


def test_sharded_dynamic_ranks_equal_one_process(dynamic_ranks):
    spec = DYNAMIC["dynamic"]
    with one_thread():
        want = cases.run_trainer(spec)
    _hold(dynamic_ranks["dynamic"], want, spec)
    assert min(float(m["active_edges"]) for m in want["rounds"]) < 1.0
    assert want["alive"][-1].tolist() == [True, True, False]
    assert want["replicated"]["node_ring"] is not None


def test_sharded_async_pipelined_ranks_equal_one_process(dynamic_ranks):
    spec = DYNAMIC["async"]
    with one_thread():
        want = cases.run_trainer(dict(spec, pipe=1))
    got = dynamic_ranks["async"]
    _hold(got, want, spec)
    tr_w = want["ledger"].shape[-1] // spec["shards"]
    assert all(g["ledger"].shape == (2, 1, tr_w) for g in got)
    stale = [float(m["stale_edges"]) for m in want["rounds"]]
    assert max(stale) > 0 and min(stale) == 0


def test_sharded_wire_bytes_and_layout():
    """The sharded trainer's layout and wire accounting are the S-way
    sharded ones (held against the reference's in
    ``test_torch_flatten_sharded.py``); S = 1 keeps the unsharded
    layout."""
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    model = build_model(cfg)

    def trainer(shards, codec):
        return ConsensusTrainer(
            model, num_nodes=2, device="cpu", adamw=AdamWConfig(),
            ranks=trivial_grid(2, "cpu", shards=shards),
            consensus=ConsensusConfig(wire_codec=codec,
                                      shard_consensus=True))

    for codec in ("native", "int8", "fp8_e4m3"):
        one, two = trainer(1, codec), trainer(2, codec)
        assert one.slayout is None and two.slayout.n_shards == 2
        assert two.layout.total % (2 * two.layout.block_size) == 0
        assert two.codec.wire_bytes() == 2 * two.codec.wire_row_bytes()
        plain = ConsensusTrainer(model, num_nodes=2, device="cpu",
                                 adamw=AdamWConfig(),
                                 consensus=ConsensusConfig(wire_codec=codec))
        assert one.layout.total == plain.layout.total
        assert one.codec.wire_bytes() == plain.codec.wire_bytes()


# ---------------------------------------------------------------- (b) ----
def test_sharded_ranks_match_reference(static_ranks, tmp_path_factory):
    with np.load(trainer_test.reference_path(tmp_path_factory)) as z:
        ref = {k: z[k] for k in z.files}
    for out in static_ranks["reference"]:
        np.testing.assert_allclose([float(x) for x in out["loss"]],
                                   ref["losses"], rtol=1e-4)
        for k, key in (("r_max", "r_max"), ("eta", "eta_mean")):
            np.testing.assert_allclose(
                [float(m[key]) for m in out["rounds"]], ref[k], rtol=1e-3)
        np.testing.assert_allclose(out["replicated"]["penalty"][0].numpy(),
                                   ref["eta_final"], rtol=1e-3)


# ---------------------------------------------------------------- (c) ----
LAUNCH = ["--reduced", "--nodes", "2", "--shard-consensus", "--steps", "4",
          "--local-steps", "2", "--wire-codec", "int8", "--device", "cpu"]


def test_sharded_launcher_under_torchrun(capsys):
    from repro_torch.launch import train
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train"] + LAUNCH,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with one_thread():
        train.run(get_reduced_config("qwen3-4b"), train.parse_args(LAUNCH),
                  grid=trivial_grid(2, "cpu", shards=2))
    one = capsys.readouterr().out
    ranked = ROUND_LINE.findall(proc.stdout)
    assert ranked == ROUND_LINE.findall(one) and len(ranked) == 2
    assert proc.stdout.count("done: 4 steps") == 1     # rank 0 alone


# ---------------------------------------------------------------- (d) ----
def test_sharded_world_must_be_a_multiple_of_nodes():
    for j, world in ((3, 2), (4, 6), (4, 2)):
        with pytest.raises(ValueError, match="not a multiple of --nodes"):
            mesh.init_ranks(j, "cpu", world_size=world, rank=0,
                            shard_consensus=True)


@pytest.mark.parametrize("kw", [dict(async_exec=AsyncConfig(
    max_staleness=1)), dict(pipeline_offsets=2)], ids=["async", "pipelined"])
def test_shards_accept_async_and_pipelining(kw):
    """Rank 0 of J 2 x S 2 (slab 0 of node 0; no collective runs here):
    the trainer takes the async executor or the pipeline, and an async
    rank's ledger holds its slab's message of its node."""
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    model = build_model(cfg)
    grid = RankGrid(world=4, rank=0, local_rank=0, nodes_per_rank=1,
                    node_lo=0, node_hi=1, device=torch.device("cpu"),
                    backend="gloo", group=object(), shards=2, shard=0,
                    inpod_group=object(), shard_group=object())
    tr = ConsensusTrainer(model, num_nodes=2, device="cpu",
                          adamw=AdamWConfig(), ranks=grid,
                          consensus=ConsensusConfig(shard_consensus=True,
                                                    **kw))
    state = tr.init_state(model.init(torch.Generator().manual_seed(0),
                                     "cpu"))
    assert tr.slab and state.lam.shape == (1, tr.slayout.shard_total)
    if "async_exec" in kw:
        assert state.ledger.wires.shape == (1, 1, tr.codec.shard_wire_width)
    else:
        assert tr.pipelined and state.ledger is None
    # the trivial grid makes no group
    grid = mesh.init_ranks(2, "cpu", shard_consensus=True)
    assert grid.shards == 1 and grid.group is None


def test_sharded_launcher_runs_async_pipelined(capsys):
    """One process computing J 2 x S 2 whole with ``--async
    --pipeline-offsets 2``: its consensus lines equal depth 1's."""
    from repro_torch.launch import train
    lines = []
    for depth in ("2", "1"):
        args = train.parse_args(
            ["--reduced", "--nodes", "2", "--shard-consensus", "--async",
             "--max-staleness", "1", "--slow-node", "0:2.0",
             "--pipeline-offsets", depth, "--local-steps", "1", "--steps",
             "4", "--wire-codec", "int8", "--device", "cpu"])
        with one_thread():
            train.run(get_reduced_config("qwen3-4b"), args,
                      grid=trivial_grid(2, "cpu", shards=2))
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if " stale=" in ln])
    cut = [[ln.rsplit(" ", 1)[0] for ln in run] for run in lines]
    assert cut[0] == cut[1] and len(cut[0]) == 4


def test_sharded_nccl_refused_for_ranks_sharing_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in (("WORLD_SIZE", "4"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                 ("LOCAL_WORLD_SIZE", "4")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        mesh.init_ranks(2, "cuda", shard_consensus=True)
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        main(["--reduced", "--nodes", "2", "--shard-consensus", "--steps",
              "1"])


def test_trainer_refuses_unsharded_config_on_sharded_grid():
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    model = build_model(cfg)
    with pytest.raises(ValueError, match="set ConsensusConfig.shard_cons"):
        ConsensusTrainer(model, num_nodes=2, device="cpu",
                         adamw=AdamWConfig(),
                         ranks=trivial_grid(2, "cpu", shards=2),
                         consensus=ConsensusConfig())
    # the async executor on a sharded trainer: the ledger's rows are the
    # sharded wire, S slab messages side by side
    tr = ConsensusTrainer(model, num_nodes=2, device="cpu",
                          adamw=AdamWConfig(),
                          ranks=trivial_grid(2, "cpu", shards=2),
                          consensus=ConsensusConfig(
                              shard_consensus=True,
                              async_exec=AsyncConfig(max_staleness=1)))
    state = tr.init_state(model.init(torch.Generator().manual_seed(0),
                                     "cpu"))
    assert state.ledger.wires.shape == (1, 2, 2 * tr.codec.shard_wire_width)
    with pytest.raises(ValueError, match="holds no slab"):
        gather_pod(torch.zeros(3), trivial_grid(2, "cpu", shards=2))
