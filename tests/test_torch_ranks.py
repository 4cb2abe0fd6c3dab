"""The consensus trainer as R ranks over ``torch.distributed`` (gloo, on
the CPU), each holding a block of J / R nodes.

(a) The circulant exchange alone (``distributed.circulant_into``): for
    every J <= 8 and every R dividing J, every offset, once with all
    offsets live and once with a seeded subset dead on every rank, each
    rank's rows equal ``torch.roll``'s (a dead offset's stay zero); then
    with every offset in flight at once (``circulant_start``, a tag an
    offset) and seeded rows kept, which hold their values. One spawn of
    eight ranks runs every case on the group of ranks [0, R).
(b) The rank trainer against the one-process port trainer, bit for bit:
    reduced qwen3-4b in float32, 6 steps: the static nap ring at J=3 R=3
    and J=4 R=2, the dynamic budget scheduler with churn on the complete
    graph with node 2 dropped at R=2 and R=4 (obs rings on), and the int8
    and fp8_e4m3 wires at J=4 R=2. The per-node rows of every rank,
    stacked, equal the one process's; the replicated state and every
    step's and round's metrics are equal on every rank.
(c) Against the reference, from the records ``test_torch_trainer.py`` and
    ``test_torch_dynamic_trainer.py`` build (one reference process each per
    test run, shared), at their tolerances: losses rtol 1e-4, round
    metrics 1e-3, masks and liveness exactly.
(d) The launcher under ``torchrun`` with two ranks: rank 0 alone prints,
    its consensus lines equal a one-process run's, and its ``--obs-dir``
    artifacts validate.
(e) The refusals: J not a multiple of the world size, nccl on the CPU,
    and nccl with two ranks on one card (checked before any NCCL call);
    the async executor on two ranks is accepted.
(f) The round pipeline and the async executor across ranks: J 4 over two
    ranks at ``pipeline_offsets`` 2 (exchanges in flight across ranks),
    each run bit for bit against one process at depth 1, its ledger rows
    included: the dynamic budget scheduler with churn and kicks (a case
    of (b)), and the async executor (stale scheduler, ``max_staleness``
    1, native, node 0 3x slow, 8 ticks), also held against the reference
    trajectory that ``test_torch_async.py`` records (from its initial
    parameters, topology and ledger; one reference process a test run,
    shared) at that test's tolerances.

Every process runs torch on one thread, so that the one-process run and
the ranks sum in the same order.
"""
import contextlib
import dataclasses
import fcntl
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_dynamic_trainer as dyn_test
import test_torch_trainer as trainer_test
import torch_ranks_cases as cases
from torch_round_cases import run_reference
from repro_torch.async_exec import AsyncConfig
from repro_torch.configs import get_reduced_config
from repro_torch.distributed import RankGrid
from repro_torch.launch import mesh
from repro_torch.models import build_model
from repro_torch.optim import ConsensusConfig, ConsensusTrainer
from repro_torch.optim.adamw import AdamWConfig

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _bits(t):
    """A float tensor's bytes (so that -0.0 differs from 0.0)."""
    if t.is_floating_point():
        return t.reshape(-1).contiguous().view(torch.uint8)
    return t


def _same(a, b, where="state"):
    """a and b equal bit for bit (tensors, sequences, dicts, scalars)."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(_bits(a), _bits(b)), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for n, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{n}]")
    else:
        assert a == b, where


def _ranks(spec, world, tmp_path):
    cases.spawn(cases.trainer_worker, world, tmp_path, str(tmp_path), spec)
    return [torch.load(tmp_path / f"trainer{r}.pt") for r in range(world)]


def _hold(got, want):
    """The ranks' outputs ``got`` (blocks of nodes, in rank order) against
    the one-process ``want``, bit for bit: the replicated state and the
    metrics on every rank, the node rows and the ledger rows stacked."""
    for r, out in enumerate(got):
        for k in ("loss", "grad_norm", "rounds", "mask", "alive", "kick",
                  "eta", "w_prev", "replicated"):
            _same(out[k], want[k], f"rank {r} {k}")
    stacked = {k: ([torch.cat([g["rows"][k][n] for g in got])
                    for n in range(len(want["rows"][k]))]
                   if isinstance(want["rows"][k], list)
                   else torch.cat([g["rows"][k] for g in got]))
               for k in want["rows"]}
    _same(stacked, want["rows"], "rows")
    if want["ledger"] is not None:
        _same(torch.cat([g["ledger"] for g in got], dim=1), want["ledger"],
              "ledger")


# ---------------------------------------------------------------- (a) ----
@pytest.fixture(scope="module")
def exchange_results(tmp_path_factory):
    # one spawn per test run: the xdist workers share it under a lock
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = base / "ranks_exchange"
    d.mkdir(exist_ok=True)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "done").exists():
            cases.spawn(cases.exchange_worker, cases.EXCHANGE_WORLD, d,
                        str(d))
            (d / "done").touch()
    out = {}
    for r in range(cases.EXCHANGE_WORLD):
        with open(d / f"exchange{r}.json") as f:
            for k, ok in json.load(f).items():
                out.setdefault(k, []).append(ok)
    return out


@pytest.mark.parametrize("j,r", cases.EXCHANGE_CASES,
                         ids=[f"J{j}-R{r}" for j, r in cases.EXCHANGE_CASES])
def test_exchange_equals_roll(exchange_results, j, r):
    assert exchange_results[f"{j}/{r}"] == [True] * r


def test_exchange_segments():
    # rank 1 of J=6 R=3 at offset 3: nodes 5 then 0, from ranks 2 and 0
    from repro_torch.distributed import segments
    assert segments(2, 2, 3, 6) == [(2, 0, 1, 1), (0, 1, 0, 1)]
    # one rank: the two copies of a roll
    assert segments(0, 5, 2, 5) == [(0, 0, 2, 3), (0, 3, 0, 2)]


# ---------------------------------------------------------------- (b) ----
DYN = dict(scheduler="budget", churn=True, gate_tol=10.0)
SPECS = {
    "ring-J3-R3": (dict(j=3, topology="ring", local_steps=2), 3),
    "ring-J4-R2": (dict(j=4, topology="ring", local_steps=2), 2),
    "dynamic-R2": (dict(j=4, topology="complete", local_steps=1, dyn=DYN,
                        drop=(2, 2), obs=True), 2),
    "dynamic-R4": (dict(j=4, topology="complete", local_steps=1, dyn=DYN,
                        drop=(2, 2), obs=True), 4),
    "int8-J4-R2": (dict(j=4, topology="ring", local_steps=2, codec="int8"),
                   2),
    "fp8-J4-R2": (dict(j=4, topology="ring", local_steps=2,
                       codec="fp8_e4m3"), 2),
    # (f): the round pipeline at depth 2, against one process at depth 1
    "dynamic-R2-pipe2": (dict(j=4, topology="complete", local_steps=1,
                              dyn=DYN, drop=(2, 2), obs=True, pipe=2), 2),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_ranks_equal_one_process(tmp_path, name):
    spec, world = SPECS[name]
    spec = dict(spec, steps=6, batch=2)
    with one_thread():
        want = cases.run_trainer(dict(spec, pipe=1))
    got = _ranks(spec, world, tmp_path)
    _hold(got, want)
    assert len(want["rounds"]) == 6 // spec["local_steps"]
    if "dyn" in spec:           # edges gated and the drop happened
        assert min(float(m["active_edges"]) for m in want["rounds"]) < 1.0
        assert want["alive"][-1].tolist() == [True, True, False, True]
    if spec.get("pipe"):        # the scheduler parked kicks
        assert any(k.any() for k in want["kick"])


# ---------------------------------------------------------------- (c) ----
def test_ranks_trainer_match_reference(tmp_path, tmp_path_factory):
    path = trainer_test.reference_path(tmp_path_factory)
    spec = dict(j=2, topology="ring", local_steps=2, steps=trainer_test.STEPS,
                batch=4, params=path)
    got = _ranks(spec, 2, tmp_path)
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    for out in got:
        np.testing.assert_allclose([float(x) for x in out["loss"]],
                                   ref["losses"], rtol=1e-4)
        for k, key in (("r_max", "r_max"), ("eta", "eta_mean")):
            np.testing.assert_allclose(
                [float(m[key]) for m in out["rounds"]], ref[k], rtol=1e-3)
        np.testing.assert_allclose(out["replicated"]["penalty"][0].numpy(),
                                   ref["eta_final"], rtol=1e-3)


def test_ranks_dynamic_match_reference(tmp_path, tmp_path_factory):
    path = dyn_test.reference_path(tmp_path_factory)
    spec = dict(j=4, topology="complete", local_steps=1,
                steps=dyn_test.ROUNDS, batch=2, params=path,
                dyn=dyn_test.CASES["b"], topo0="b/topo0/",
                drop=(dyn_test.DROP_AFTER, 2))
    got = _ranks(spec, 2, tmp_path)
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    for out in got:
        np.testing.assert_allclose([float(x) for x in out["loss"]],
                                   ref["b/loss"], rtol=1e-4)
        for k, key in (("r_max", "r_max"), ("eta", "eta_mean"),
                       ("active", "active_edges")):
            np.testing.assert_allclose(
                [float(m[key]) for m in out["rounds"]], ref[f"b/{k}"],
                rtol=1e-3, err_msg=k)
        np.testing.assert_array_equal(np.stack(out["mask"]), ref["b/mask"])
        np.testing.assert_array_equal(np.stack(out["alive"]),
                                      ref["b/alive"])
        np.testing.assert_allclose(np.stack(out["kick"]), ref["b/kick"],
                                   rtol=1e-3)


# ---------------------------------------------------------------- (d) ----
LAUNCH = ["--reduced", "--nodes", "4", "--steps", "4", "--local-steps",
          "2", "--topo-scheduler", "budget", "--drop-node", "1:1",
          "--device", "cpu"]
ROUND_LINE = re.compile(r"^step +\d+ loss \S+ \| consensus r=\S+ eta=\S+"
                        r"(?: active=\S+)?", re.M)


def test_launcher_under_torchrun(tmp_path, capsys):
    from repro_torch.launch.train import main
    obs_dir = tmp_path / "obs"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train"]
        + LAUNCH + ["--obs-dir", str(obs_dir), "--obs-drain-every", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with one_thread():
        assert main(LAUNCH) == 0
    one = capsys.readouterr().out
    ranked = ROUND_LINE.findall(proc.stdout)
    assert ranked == ROUND_LINE.findall(one) and len(ranked) == 2
    assert proc.stdout.count("done: 4 steps") == 1     # rank 0 alone
    assert "dropped node 1 (topology epoch)" in proc.stdout
    from repro_torch.obs import export
    report = export.validate_obs_dir(str(obs_dir))
    assert report["ok"], report["errors"]
    check = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.export", "--validate",
         str(obs_dir)], env=env, capture_output=True, text=True, timeout=120)
    assert check.returncode == 0, check.stdout[-2000:]


# ---------------------------------------------------------------- (e) ----
def test_nodes_must_divide_among_ranks():
    with pytest.raises(ValueError, match="not a multiple of the world size"):
        mesh.init_ranks(3, "cpu", world_size=2, rank=0)


def test_async_accepted_across_ranks():
    # rank 0 of two: the trainer takes the async executor and holds its own
    # node's ledger rows (the launcher builds its trainer the same way)
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    grid = RankGrid(world=2, rank=0, local_rank=0, nodes_per_rank=1,
                    node_lo=0, node_hi=1, device=torch.device("cpu"))
    model = build_model(cfg)
    tr = ConsensusTrainer(model, num_nodes=2, device="cpu",
                          adamw=AdamWConfig(), ranks=grid,
                          consensus=ConsensusConfig(
                              async_exec=AsyncConfig(max_staleness=1)))
    state = tr.init_state(model.init(torch.Generator().manual_seed(0),
                                     "cpu"))
    assert state.ledger.wires.shape == (1, 1, tr.codec.wire_width)
    assert state.ledger.w_prev.shape == (2, 2)
    assert state.lam.shape == (1, tr.layout.total)


def test_nccl_refused_on_cpu():
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match="nccl backend needs device cuda"):
        mesh.init_ranks(2, "cpu", backend="nccl", world_size=1, rank=0)
    with pytest.raises(ValueError, match="nccl backend needs device cuda"):
        main(["--reduced", "--nodes", "2", "--device", "cpu",
              "--dist-backend", "nccl", "--steps", "1"])


def test_nccl_refused_for_ranks_sharing_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0"),
                 ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        mesh.init_ranks(2, "cuda")
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        main(["--reduced", "--nodes", "2", "--steps", "1"])
    # the trivial grid makes no group and keeps every node
    monkeypatch.setenv("WORLD_SIZE", "1")
    grid = mesh.init_ranks(4, "cpu")
    assert (grid.group, grid.world, grid.node_lo, grid.node_hi) \
        == (None, 1, 0, 4)


# ---------------------------------------------------------------- (f) ----
ASYNC_SPEC = dict(j=4, topology="ring", local_steps=1, steps=8, batch=2,
                  dyn=dict(scheduler="stale", max_staleness=1),
                  async_=dict(max_staleness=1, slow=3.0),
                  topo0="native/topo0/", ledger0="native/ledger0/")


def test_async_ranks_equal_one_process_and_reference(tmp_path,
                                                     tmp_path_factory):
    """The async executor on two ranks at depth 2 from the reference
    trajectory's initial state: bit for bit against one process at depth
    1, and within ``test_torch_async.py``'s tolerances of the reference."""
    ref = run_reference("test_torch_async", tmp_path_factory,
                        fn="_trainer_reference_outputs")
    npz = tmp_path / "start.npz"
    np.savez(npz, **{k: v for k, v in ref.items()
                     if k.startswith(("p/", "native/topo0/",
                                      "native/ledger0/"))})
    spec = dict(ASYNC_SPEC, params=str(npz))
    got = _ranks(dict(spec, pipe=2), 2, tmp_path)
    with one_thread():
        want = cases.run_trainer(spec)
    _hold(got, want)
    assert got[0]["ledger"].shape[1] == 2          # its block's rows
    stale = [float(m["stale_edges"]) for m in want["rounds"]]
    assert max(stale) > 0 and min(stale) == 0
    for out in got:
        np.testing.assert_allclose([float(x) for x in out["loss"]],
                                   ref["native/loss"], rtol=1e-4)
        for key, k in (("r_max", "r_max"), ("s_max", "s_max"),
                       ("eta_mean", "eta_mean"), ("stale_edges", "stale")):
            np.testing.assert_allclose(
                [float(m[key]) for m in out["rounds"]], ref[f"native/{k}"],
                rtol=1e-3, err_msg=key)
        np.testing.assert_array_equal(
            [int(m["age_max"]) for m in out["rounds"]],
            ref["native/age_max"])
        np.testing.assert_allclose(np.stack(out["eta"]), ref["native/eta"],
                                   rtol=1e-3)
        np.testing.assert_allclose(np.stack(out["w_prev"]),
                                   ref["native/w_prev"], rtol=1e-3)
        np.testing.assert_array_equal(np.stack(out["mask"]),
                                      ref["native/mask"])
