"""Workers of ``tests/test_torch_ranks.py`` and
``tests/test_torch_sharded.py``: the consensus trainer and the circulant
exchange run as R gloo ranks in spawned processes, each joined through a
``file://`` store (no TCP port), each on one torch thread. This module
imports no JAX."""
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch import tree as tree_lib
from repro_torch.async_exec import (AsyncConfig, AsyncExecutor, RoundClock,
                                    straggler_compute)
from repro_torch.async_exec import from_numpy as ledger_from_numpy
from repro_torch.configs import get_reduced_config
from repro_torch.core.penalty import PenaltyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.models.params import from_jax
from repro_torch.obs import ObsConfig
from repro_torch.optim import ConsensusConfig, ConsensusTrainer
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.topology import TopologyConfig, from_numpy


def spawn(fn, world: int, tmp_dir, *args, timeout: float = 240.0) -> None:
    """Run ``fn(rank, world, store, *args)`` in ``world`` spawned processes
    that share the ``file://`` store ``store``; raise if one fails or the
    whole takes longer than ``timeout`` seconds (the processes are then
    killed)."""
    store = os.path.join(str(tmp_dir), f"store.{os.getpid()}.{time.time_ns()}")
    ctx = mp.start_processes(fn, args=(world, store) + args, nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks of {fn.__name__} did not "
                               f"finish in {timeout} s")


def _grid(rank, world, store, j, shard_consensus=False):
    from repro_torch.launch.mesh import init_ranks
    torch.set_num_threads(1)
    return init_ranks(j, "cpu", backend="gloo", init_method=f"file://{store}",
                      world_size=world, rank=rank,
                      shard_consensus=shard_consensus)


# ------------------------------------------------------------- exchange ----
EXCHANGE_WORLD = 8
# (J, R) for every J <= 8 and every R dividing J (R = 1 with a group)
EXCHANGE_CASES = [(j, r) for j in range(2, EXCHANGE_WORLD + 1)
                  for r in range(1, j + 1) if j % r == 0]


def exchange_worker(rank, world, store, out_dir):
    """Every case of ``EXCHANGE_CASES`` on the group of ranks [0, R): for
    each offset set (all live, and a seeded subset shared by every rank),
    the rows equal ``torch.roll``'s and a dead offset's row stays zero;
    then every offset started before any is waited on (the pipelined
    round's form, each offset's ops with its own tag), with a seeded set
    of kept rows per offset: those keep what they held, the others equal
    ``torch.roll``'s."""
    import torch.distributed as dist

    from repro_torch.distributed import circulant_into, circulant_start
    from repro_torch.distributed import RankGrid
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    groups = {r: dist.new_group(list(range(r)))
              for r in range(1, world + 1)}
    ok = {}
    for j, r in EXCHANGE_CASES:
        if rank >= r:
            continue
        per = j // r
        grid = RankGrid(world=r, rank=rank, local_rank=rank,
                        nodes_per_rank=per, node_lo=rank * per,
                        node_hi=(rank + 1) * per,
                        device=torch.device("cpu"), backend="gloo",
                        group=groups[r])
        rng = np.random.default_rng(1000 * j + r)       # same on every rank
        full = torch.from_numpy(rng.normal(size=(j, 5)).astype(np.float32)
                                ).to(torch.bfloat16)
        wire = full[grid.node_lo:grid.node_hi].clone()
        offsets = list(range(1, j))
        good = True
        for live in ([True] * len(offsets),
                     list(rng.integers(0, 2, size=len(offsets)) > 0)):
            dst = torch.zeros((len(offsets), per, 5), dtype=wire.dtype)
            for d, off in enumerate(offsets):
                if live[d]:
                    circulant_into(dst[d], wire, off, grid)
            for d, off in enumerate(offsets):
                want = torch.roll(full, -off, 0)[grid.node_lo:grid.node_hi]
                if not live[d]:
                    want = torch.zeros_like(want)
                good &= bool(torch.equal(dst[d], want))
        keep = rng.integers(0, 2, size=(len(offsets), j)) > 0
        held = torch.full((len(offsets), per, 5), 7.0, dtype=wire.dtype)
        pend = [circulant_start(held[d], wire, off, grid, tag=d,
                                keep=keep[d, grid.node_lo:grid.node_hi])
                for d, off in enumerate(offsets)]
        for p in pend:
            p.wait()
        for d, off in enumerate(offsets):
            want = torch.roll(full, -off, 0)[grid.node_lo:grid.node_hi]
            kept = torch.from_numpy(keep[d, grid.node_lo:grid.node_hi])
            want = torch.where(kept[:, None], 7.0, want.float()).to(
                wire.dtype)
            good &= bool(torch.equal(held[d], want))
        ok[f"{j}/{r}"] = good
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"exchange{rank}.json"), "w") as f:
        json.dump(ok, f)


# -------------------------------------------------------------- trainer ----
def _params(spec, model):
    if spec.get("params"):                  # the reference's, transplanted
        with np.load(spec["params"]) as z:
            tree = {}
            for key in z.files:
                if key.startswith("p/"):
                    node = tree
                    *parents, leaf = key[2:].split("/")
                    for k in parents:
                        node = node.setdefault(k, {})
                    node[leaf] = z[key]
        return from_jax(tree)
    return model.init(torch.Generator().manual_seed(0), "cpu")


def run_trainer(spec: dict, grid=None) -> dict:
    """The reduced float32 qwen3-4b trainer on ``spec``'s schedule, on the
    rank ``grid`` (None: one process holding every node, and with
    ``spec["shards"]`` S every slab of the S-way sharded layout). Returns
    this rank's rows of the per-node state (and of the wire ledger), the
    replicated state, and every step's and round's metrics (each rank's
    are over all J nodes).

    ``spec["pipe"]`` is the round pipeline's depth; ``spec["async_"]``
    (``max_staleness``, ``slow``: node 0's factor) runs the rounds through
    the async executor on a round clock with ``wire_s`` 0.25, from the
    npz's initial ledger at ``spec["ledger0"]`` when given (cut to this
    rank's rows or slab)."""
    from repro_torch.distributed import trivial_grid
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    model = build_model(cfg)
    j = spec["j"]
    if grid is None and spec.get("shards"):
        grid = trivial_grid(j, "cpu", shards=spec["shards"])
    dyn = TopologyConfig(**spec["dyn"]) if spec.get("dyn") else \
        TopologyConfig()
    tr = ConsensusTrainer(
        model, num_nodes=j, device="cpu", adamw=AdamWConfig(lr=1e-2),
        ranks=grid,
        consensus=ConsensusConfig(
            penalty=PenaltyConfig(scheme="nap", eta0=0.1),
            topology=spec["topology"], local_steps=spec["local_steps"],
            wire_codec=spec.get("codec", ""), dyn_topology=dyn,
            obs=ObsConfig(ring_capacity=8) if spec.get("obs") else None,
            shard_consensus=bool(spec.get("shards")),
            async_exec=(AsyncConfig(
                max_staleness=spec["async_"]["max_staleness"])
                if spec.get("async_") else None),
            pipeline_offsets=spec.get("pipe", 1)))
    nodes = None if grid is None else (grid.node_lo, grid.node_hi)
    data = SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=32, batch_per_node=spec["batch"],
        num_nodes=j), device="cpu", nodes=nodes)
    state = tr.init_state(_params(spec, model))
    if spec.get("topo0"):
        with np.load(spec["params"]) as z:
            pre = spec["topo0"]
            state = state._replace(topo=from_numpy(
                {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)},
                "cpu"))
    if spec.get("ledger0"):
        with np.load(spec["params"]) as z:
            pre = spec["ledger0"]
            shard = None
            if tr.slab:
                shard = (tr.ranks.shard, tr.codec.shard_wire_width)
            state = state._replace(ledger=ledger_from_numpy(
                {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)},
                "cpu", nodes=(tr.ranks.node_lo, tr.ranks.node_hi),
                shard=shard))
    ex = None
    if spec.get("async_"):
        ex = AsyncExecutor(tr, RoundClock(
            compute_s=straggler_compute(j, factor=spec["async_"]["slow"]),
            wire_s=0.25, offsets=tuple(tr.offsets)))
    out = {"loss": [], "grad_norm": [], "rounds": [], "mask": [],
           "alive": [], "kick": [], "eta": [], "w_prev": []}
    drop_at, victim = spec.get("drop", (-1, -1))
    for step in range(spec["steps"]):
        state, m = tr.train_step(state, data.batch(step))
        out["loss"].append(m["loss"])
        out["grad_norm"].append(m["grad_norm"])
        if tr.should_sync(step):
            probe = data.batch(10**6 + step)
            if ex is not None:
                state, cm = ex.consensus_round(state, probe)
            else:
                state, cm = tr.consensus_step(state, probe)
            out["rounds"].append(cm)
            out["eta"].append(state.penalty.eta.clone())
            if state.ledger is not None:
                out["w_prev"].append(state.ledger.w_prev.clone())
            if step == drop_at:
                state = tr.apply_churn(state, victim)
            out["mask"].append(state.topo.mask.clone())
            out["alive"].append(state.topo.node_alive.clone())
            out["kick"].append(state.topo.kick.clone())
    out["rows"] = {"params": tree_lib.leaves(state.params),
                   "m": tree_lib.leaves(state.opt.m),
                   "v": tree_lib.leaves(state.opt.v),
                   "lam": state.lam, "bar": state.theta_bar_prev}
    out["ledger"] = None if state.ledger is None else state.ledger.wires
    out["wire_bytes"] = tr.codec.wire_bytes()
    out["replicated"] = {
        "penalty": list(state.penalty), "topo": list(state.topo),
        "step": state.step, "opt_step": state.opt.step,
        "ledger": None if state.ledger is None
        else [state.ledger.round, state.ledger.w_prev],
        "ring": None if state.ring is None else list(state.ring),
        "node_ring": None if state.node_ring is None
        else list(state.node_ring)}
    return out


def trainer_worker(rank, world, store, out_dir, spec):
    grid = _grid(rank, world, store, spec["j"])
    try:
        out = run_trainer(spec, grid)
    finally:
        grid.close()
    torch.save(out, os.path.join(out_dir, f"trainer{rank}.pt"))


def specs_worker(rank, world, store, out_dir, specs, shard_consensus):
    """Every spec of ``specs`` (name -> spec, one J for all) on one grid of
    ``world`` ranks (with ``shard_consensus``, J * S ranks with the
    consensus state sharded in-pod); this rank's output of each into
    ``<name>.<rank>.pt``."""
    j = next(iter(specs.values()))["j"]
    grid = _grid(rank, world, store, j, shard_consensus=shard_consensus)
    try:
        for name, spec in specs.items():
            out = run_trainer(spec, grid)
            out["grid"] = (grid.pod, grid.shard, grid.shards)
            torch.save(out, os.path.join(out_dir, f"{name}.{rank}.pt"))
    finally:
        grid.close()
