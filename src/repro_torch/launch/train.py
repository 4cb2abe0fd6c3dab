"""Training launcher: consensus-ADMM training end to end (port of
``repro/launch/train.py``): synchronous rounds on a static or dynamic
topology, or bounded-staleness async rounds (``--async``).

The J nodes (``--nodes``) run on the ranks that ``torchrun`` (``python -m
torch.distributed.run``) starts, each rank holding a contiguous block of
J / R node rows on its device (``--device``, CUDA unless ``cpu`` is asked
for; ``launch.mesh.init_ranks``). Started plainly, one process holds all
J. The backend follows the device (NCCL on cards, gloo on the CPU);
``--dist-backend gloo`` on ``cuda`` runs ranks that share one card, their
rows staged through host memory. With ``--shard-consensus`` under
torchrun, R = J * S ranks: the S ranks of each node hold its parameters
whole (with ``--mesh debug``, their shards) and one slab each of its flat
consensus rows (S = R / J). ``--async``
and ``--pipeline-offsets`` run on every such grid: every rank builds the
same deterministic round clock and executor. Only rank 0 prints and
writes the ``--obs-dir`` artifacts: the rings are replicated, so its drain
is the run's.
Every arch of the reference trains: the audio and vision archs on the
frontend stubs' embeddings (``SyntheticTokens.embeds_batch``), rwkv6 on the
plain per-step recurrence (the scan kernel has no backward, as in the
reference).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --steps 8 --scheme nap --local-steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch moonshot-v1-16b-a3b --reduced --steps 4 --local-steps 2 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --steps 10 --local-steps 2 --nodes 4 --topology complete \\
      --topo-scheduler round_robin --drop-node 5:1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --steps 4 --local-steps 2 --wire-codec fp8_e4m3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --async --max-staleness 1 --slow-node 0:4.0 --nodes 3 \\
      --local-steps 1 --steps 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --steps 8 --local-steps 1 --obs-dir /tmp/obs --health \\
      --device cpu
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 3 -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --nodes 3 --steps 8 --local-steps 2 --device cpu
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --nodes 2 --shard-consensus --steps 4 --local-steps 2 \\
      --device cpu
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --nodes 4 --async --max-staleness 1 --slow-node 0:3.0 \\
      --pipeline-offsets 2 --local-steps 1 --steps 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --steps 40 --scheme nap --topology ring --local-steps 4 \\
      --mesh debug --ckpt-dir /tmp/ckpt --device cpu
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch moonshot-v1-16b-a3b --reduced --nodes 2 --mesh debug \\
      --steps 4 --local-steps 2 --device cpu

With ``--obs-dir`` the rounds append to the device metrics rings, the
launcher drains them every ``--obs-drain-every`` rounds into the
``repro_torch.obs.export`` artifact set (which ``python -m
repro_torch.obs.export --validate DIR`` checks and ``python -m
repro_torch.obs.dashboard DIR`` renders), and ``--profile-rounds N`` writes
a torch.profiler Chrome trace of the first N rounds under
``<obs-dir>/profile/``.

``--mesh`` is the reference's flag, for the in-pod axes: the reference
lays J pods x ``data`` x ``model`` devices on one mesh (``debug``: pod 2 x
data 2 x model 2, ``make_debug_mesh(multi_pod=True)``), the port starts
its ranks with torchrun and ``--mesh`` splits each node's S = R / J ranks
into ``data x model``: ``debug`` is data 2 x model 2 (R = 4 J ranks, or
one process computing the run whole), each rank holding its shards of the
node's parameters and moments and running the local step and the probes
under the pod's mesh (``distributed.fsdp``). Without ``--shard-consensus``
(the reference's default) each of the S ranks holds the node's flat
consensus rows whole, the same bits as its in-pod twins; with it, one slab
each. ``none`` keeps the node's parameters whole on each of its ranks;
``prod`` (16 x 16 a pod) is refused. The port's default is ``none``, where
the reference's is ``debug``: the reference's default lays its 8 devices
itself, while here the ranks come from torchrun, and a plain start is one
process. The number of pods is ``--nodes`` (the reference's mesh fixes it
at 2; its ``--multi-pod`` has no counterpart). The reference's
``--no-async-collectives`` only sets XLA scheduler flags and has no
counterpart here: argparse rejects it.

``--ckpt-dir`` (``repro_torch.checkpoint``, the reference's on-disk
format): every ``--ckpt-every`` steps the state is saved in the background
(``save_async``); a run started on a directory that holds a checkpoint
resumes from its newest step (``resumed from step N``), on the same grid
only: the checkpoint names its grid, and another grid is refused. Under
torchrun every rank writes its own rows, slab or shards, and rank 0 the
replicated state and the manifest. A synchronous run resumed from step k
equals the uninterrupted run bit for bit. An async run's round clock is
host state that neither package checkpoints (the reference saves the
train state only): a resumed async run starts a fresh clock, and its
rounds after the resume differ from the uninterrupted run's. The obs
writer and the straggler monitor start afresh too, as the reference's do.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.async_exec import (AsyncConfig, AsyncExecutor, RoundClock,
                                    straggler_compute)
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.penalty import SCHEMES, PenaltyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.distributed import gather_nodes
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import init_ranks
from repro_torch.models import build_model
from repro_torch.obs import ObsConfig, ObsWriter, host_span_factory
from repro_torch.optim import ConsensusConfig, ConsensusTrainer
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.consensus import replicated_leaf
from repro_torch.runtime import (ElasticController, StragglerMonitor,
                                 aged_out_nodes, node_durations)
from repro_torch.topology import SCHEDULERS, TopologyConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--nodes", type=int, default=2,
                    help="ADMM nodes J, a multiple of the world size: each "
                         "rank holds J / R of them on its device")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--dist-backend", default="", choices=["", "nccl",
                                                           "gloo"],
                    help="process group backend of the ranks; empty follows "
                         "the device (nccl on cuda, gloo on cpu) and makes "
                         "no group for one process. gloo on cuda runs ranks "
                         "that share a card (rows staged through host "
                         "memory); nccl needs a card a rank")
    ap.add_argument("--shard-consensus", action="store_true",
                    help="shard the flat consensus state (lam, "
                         "theta_bar_prev, the wire) over the S = R / J ranks "
                         "of each node under torchrun; without --mesh the "
                         "local step stays whole on each of them")
    ap.add_argument("--mesh", choices=["none", "debug", "prod"],
                    default="none",
                    help="in-pod mesh of each node's S = R / J ranks: debug "
                         "= data 2 x model 2 (each rank holds its shards of "
                         "the node's parameters and moments, and the flat "
                         "consensus rows whole, or one slab of them with "
                         "--shard-consensus); none = the parameters whole "
                         "on every rank; prod (16 x 16 a pod) is refused")
    ap.add_argument("--scheme", choices=SCHEMES, default="nap")
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--topo-scheduler", choices=SCHEDULERS,
                    default="static",
                    help="dynamic-topology edge scheduler "
                         "(repro_torch.topology)")
    ap.add_argument("--topo-churn", action="store_true",
                    help="exchange over the churn offset superset so that "
                         "node drops are layout-preserving")
    ap.add_argument("--drop-node", default="",
                    help="STEP:VICTIM — ghost node VICTIM after STEP "
                         "(churn drill; implies --topo-churn)")
    ap.add_argument("--drop-stragglers", action="store_true",
                    help="ghost a flagged straggler instead of only logging "
                         "it (async mode flags by edge age, sync mode by "
                         "the wall-clock monitor)")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="bounded-staleness executor (repro_torch."
                         "async_exec): rounds consume the freshest landed "
                         "payload per edge instead of waiting for all")
    ap.add_argument("--max-staleness", type=int, default=2,
                    help="async: rounds a consumed payload may lag; older "
                         "edges gate until a fresh payload lands (0 = wait "
                         "for everything, the synchronous round)")
    ap.add_argument("--slow-node", default="",
                    help="async drill: NODE:FACTOR — model node NODE taking "
                         "FACTOR x the fleet's round time (e.g. 0:2.0)")
    ap.add_argument("--pipeline-offsets", type=int, default=1,
                    help="round pipeline depth: how many graph offsets' "
                         "exchanges may be in flight ahead of the "
                         "decode/probe consume point (1 = sequential; the "
                         "values are the same at every depth)")
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--eta0", type=float, default=0.1)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--compression", default="none", choices=["none", "int8"],
                    help="legacy spelling of --wire-codec (none | int8)")
    ap.add_argument("--wire-codec", default="",
                    choices=["", "native", "int8", "fp8_e4m3", "fp8_e5m2"],
                    help="consensus wire codec (repro_torch.wire): native = "
                         "params dtype, int8 = absmax per leaf + bitcast "
                         "scale tail, fp8_* = 1 B/param float8 with "
                         "per-block f32 scales; empty resolves from "
                         "--compression")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory: saved every --ckpt-every "
                         "steps, resumed from when it holds a checkpoint")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs-dir", default="",
                    help="observability (repro_torch.obs): drain the device "
                         "metrics rings and the topology event journal into "
                         "this directory (metrics.jsonl, node_metrics.jsonl, "
                         "events.jsonl, rollup.json, run.json; async runs "
                         "add the round clock's Perfetto trace). Unset = "
                         "obs off: the round runs as without it")
    ap.add_argument("--obs-ring-cap", type=int, default=256,
                    help="rows in the device metrics ring")
    ap.add_argument("--obs-drain-every", type=int, default=8,
                    help="host drain cadence in consensus rounds")
    ap.add_argument("--no-node-ring", action="store_true",
                    help="leave out the per-node telemetry ring "
                         "(obs.node_ring), keeping only the scalar ring")
    ap.add_argument("--health", action="store_true",
                    help="run the health monitor (repro_torch.obs.health) "
                         "over drained per-node rows: health_* events in "
                         "the journal, a per-node score table and advisory "
                         "recommendations in the rollup, printed at exit. "
                         "Advisory only. Requires --obs-dir")
    ap.add_argument("--profile-rounds", type=int, default=0,
                    help="write a torch.profiler Chrome trace covering the "
                         "first N consensus rounds to <obs-dir>/profile "
                         "(the obs spans label the round's phases)")
    args = ap.parse_args(argv)
    if args.health and not args.obs_dir:
        ap.error("--health requires --obs-dir (the monitor feeds off "
                 "drained per-node telemetry)")
    if args.mesh == "prod":
        ap.error("--mesh prod lays 256 ranks (data 16 x model 16) in each "
                 "pod, which cannot run here; use --mesh debug")
    return args


def inpod_mesh(args) -> tuple[int, int] | None:
    """The ``(data, model)`` split of each pod's ranks that ``--mesh``
    asks for (None: the parameters whole on every rank)."""
    return {"none": None, "debug": (2, 2)}[args.mesh]


def run(cfg: ArchConfig, args, grid=None) -> dict:
    """Train ``cfg`` as ``args`` say; returns the run's record: per-step
    losses and seconds, per-round metrics (with ``active_edges``, the
    round's node liveness, its seconds between two synchronizations, and
    the launches of the ungated and the gated kernel and of those with
    per-block scales; async rounds add ``stale_edges``, ``age_max`` and the
    nodes that advanced), the layout,
    the wire bytes per node per offset, with ``--async`` the executor's
    summary, with ``--obs-dir`` the obs rollup (``record["obs"]``) and
    the profile trace's path (``record["profile"]``), and the step the run
    started from (``record["start_step"]``: a checkpoint's, or 0).

    The local step is not retried: it updates the replicas in place, so a
    replay would start from a half-updated state.

    Under torchrun each rank runs this with its block of the nodes and
    returns the same record (its own launch counts); only rank 0 prints,
    writes ``--obs-dir`` and profiles. The process group lives for the
    call, unless the caller passes its own ``grid`` (``init_ranks`` for
    ``args``, or ``trivial_grid(J, device, shards=S)``: one process
    computing an S-way sharded run whole) and closes it itself. With
    ``--ckpt-dir`` every rank saves and restores its own part; the writes
    in flight have finished when this returns."""
    if grid is not None:
        return _run(cfg, args, grid)
    grid = init_ranks(args.nodes, args.device,
                      backend=args.dist_backend or None,
                      shard_consensus=args.shard_consensus,
                      mesh=inpod_mesh(args))
    try:
        return _run(cfg, args, grid)
    finally:
        grid.close()


def _run(cfg: ArchConfig, args, grid) -> dict:
    device = grid.device
    lead = grid.rank == 0
    say = print if lead else (lambda *a, **k: None)
    model = build_model(cfg)
    drop_at, drop_victim = (-1, -1)
    if args.drop_node:
        drop_at, drop_victim = (int(x) for x in args.drop_node.split(":"))
    churn = args.topo_churn or args.drop_stragglers or drop_at >= 0
    topo_sched = args.topo_scheduler
    if args.async_mode and topo_sched == "static" and args.max_staleness > 0:
        # the stale scheduler mirrors the executor's gating into the mask
        topo_sched = "stale"
    trainer = ConsensusTrainer(
        model, num_nodes=args.nodes, device=device, ranks=grid,
        adamw=AdamWConfig(lr=args.lr),
        consensus=ConsensusConfig(
            penalty=PenaltyConfig(scheme=args.scheme, eta0=args.eta0),
            topology=args.topology, local_steps=args.local_steps,
            compression=args.compression, wire_codec=args.wire_codec,
            dyn_topology=TopologyConfig(scheduler=topo_sched, churn=churn,
                                        max_staleness=args.max_staleness),
            async_exec=(AsyncConfig(max_staleness=args.max_staleness)
                        if args.async_mode else None),
            obs=(ObsConfig(ring_capacity=args.obs_ring_cap,
                           drain_every=args.obs_drain_every,
                           with_node_ring=not args.no_node_ring)
                 if args.obs_dir else None),
            shard_consensus=args.shard_consensus,
            pipeline_offsets=args.pipeline_offsets))
    # every rank draws the same one-node parameters from the seed
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = trainer.init_state(model.init(gen, device))
    ckpt_ranks = grid if grid.distributed else None
    ckpt_grid = trainer.grid_spec()
    start_step = 0
    if args.ckpt_dir and checkpoint.latest_steps(args.ckpt_dir):
        state, meta = checkpoint.restore(args.ckpt_dir, state,
                                         ranks=ckpt_ranks, grid=ckpt_grid)
        start_step = int(meta["step"])
        say(f"resumed from step {start_step}", flush=True)
    data = SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq,
        batch_per_node=args.batch_per_node, num_nodes=trainer.num_nodes,
        seed=args.seed), device=device, nodes=(grid.node_lo, grid.node_hi))

    def make_batch(step):
        # the frontend stubs train on precomputed embeddings
        if cfg.frontend != "none":
            return data.embeds_batch(step, cfg.d_model)
        return data.batch(step)

    executor = None
    if args.async_mode and trainer.num_nodes > 1:
        compute = np.ones(trainer.num_nodes)
        if args.slow_node:
            v, f = args.slow_node.split(":")
            compute = straggler_compute(trainer.num_nodes, victim=int(v),
                                        factor=float(f))
        executor = AsyncExecutor(trainer, RoundClock(
            compute_s=compute, wire_s=0.25, offsets=tuple(trainer.offsets)))

    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    monitor = StragglerMonitor(trainer.num_nodes)
    elastic = ElasticController(trainer.graph, topology=trainer.topo_rt)
    record = {"losses": [], "step_seconds": [], "rounds": [],
              "layout": trainer.layout, "offsets": list(trainer.offsets),
              "wire_bytes": trainer.codec.wire_bytes(),
              "start_step": start_step}
    writer = None
    if args.obs_dir and lead:
        writer = ObsWriter(args.obs_dir, meta={
            "arch": cfg.arch_id, "scheme": args.scheme,
            "topology": args.topology, "num_nodes": trainer.num_nodes,
            "wire_codec": trainer.codec_name,
            "wire_bytes_per_round":
                trainer.codec.wire_bytes() * max(len(trainer.offsets), 1),
            "offsets": [int(o) for o in trainer.offsets],
            "async": bool(args.async_mode),
            "ring_capacity": args.obs_ring_cap,
            "drain_every": args.obs_drain_every,
        }, max_staleness=(args.max_staleness if args.async_mode else None),
            health=args.health)
    round_span = host_span_factory(writer is not None)
    rounds, prof = 0, None

    def finish_profile():
        prof.stop()
        out_dir = os.path.join(args.obs_dir or ".", "profile")
        os.makedirs(out_dir, exist_ok=True)
        record["profile"] = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(record["profile"])
        say(f"profile trace ({rounds} rounds) -> {record['profile']}",
              flush=True)
    t_start = time.perf_counter()
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, make_batch(step))
        loss = float(m["loss"])
        line = f"step {step:5d} loss {loss:.4f}"
        if trainer.should_sync(step):
            alive = state.topo.node_alive.tolist()
            counts = ("launches", "masked_launches", "per_block_launches")
            before = [getattr(kops.consensus_round, c) for c in counts]
            probe = make_batch(10**6 + step)
            if args.profile_rounds > 0 and rounds == 0 and lead:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU] + (
                    [torch.profiler.ProfilerActivity.CUDA]
                    if device.type == "cuda" else []))
                prof.start()
            sync()
            t_round = time.perf_counter()
            with round_span("round/async" if executor is not None
                            else "round/sync"):
                if executor is not None:
                    ticks = executor.clock.rounds_done.copy()
                    state, cm = executor.consensus_round(state, probe)
                else:
                    state, cm = trainer.consensus_step(state, probe)
            sync()
            round_s = time.perf_counter() - t_round
            rounds += 1
            if prof is not None and rounds == args.profile_rounds:
                finish_profile()
                prof = None
            if writer is not None and rounds % args.obs_drain_every == 0:
                writer.drain(state, step=step + 1)
            rnd = {k: float(v) for k, v in cm.items()}
            rnd.update(alive=alive, seconds=round_s,
                       **{c: getattr(kops.consensus_round, c) - b
                          for c, b in zip(counts, before)})
            line += (f" | consensus r={rnd['r_max']:.4f} "
                     f"eta={rnd['eta_mean']:.4f}")
            if trainer.dynamic:
                line += f" active={rnd['active_edges']:.2f}"
            if executor is not None:
                rnd["advance"] = (executor.clock.rounds_done
                                  > ticks).tolist()
                line += (f" stale={rnd['stale_edges']:.2f}"
                         f" age_max={int(rnd['age_max'])}")
                if args.drop_stragglers:
                    # the staleness clocks are the straggler signal
                    for v in aged_out_nodes(
                            state.topo, max_staleness=args.max_staleness):
                        live = state.topo.node_alive.cpu().numpy()
                        if live[v] and live.sum() > 2:
                            state = state._replace(
                                topo=elastic.drop_preserving(v, state.topo,
                                                             step))
                            line += f" | ghosted aged-out node {v}"
            record["rounds"].append(rnd)
        if step == drop_at:
            # layout-preserving churn drill: ghost the victim and go on
            state = state._replace(topo=elastic.drop_preserving(
                drop_victim, state.topo, step))
            line += f" | dropped node {drop_victim} (topology epoch)"
        sync()
        dt = time.perf_counter() - t0
        # each rank's step seconds, for each of its nodes
        rank_s = [dt]
        if grid.distributed:
            rank_s = gather_nodes(torch.tensor(rank_s, dtype=torch.float64,
                                               device=device),
                                  grid).cpu().numpy()
        slow = monitor.observe(node_durations(rank_s, grid.nodes_per_rank))
        if slow and executor is None:
            line += f" | stragglers: {slow}"
            if args.drop_stragglers and trainer.dynamic:
                for v in slow:
                    # re-read liveness each drop: the >2-survivors floor
                    # must see the drops already applied
                    live = state.topo.node_alive.cpu().numpy()
                    if live[v] and live.sum() > 2:
                        state = state._replace(topo=elastic.drop_preserving(
                            v, state.topo, step))
                        line += f" | ghosted straggler {v}"
        record["losses"].append(loss)
        record["step_seconds"].append(dt)
        say(f"{line} {dt * 1e3:.0f}ms", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            checkpoint.save_async(
                args.ckpt_dir, step + 1, state,
                metadata={"step": step + 1, "arch": cfg.arch_id,
                          "scheme": args.scheme, "topology": args.topology,
                          "grid": ckpt_grid},
                ranks=ckpt_ranks, shared=replicated_leaf)
    checkpoint.wait_pending()
    say(f"done: {args.steps - start_step} steps in "
        f"{time.perf_counter() - t_start:.1f}s", flush=True)
    if prof is not None:                # fewer rounds than asked for
        finish_profile()
    if executor is not None:
        record["async"] = executor.summary()
        say(f"async executor: {record['async']}", flush=True)
    if writer is not None:
        writer.drain(state, step=args.steps)        # tail < drain_every
        if executor is not None:
            writer.observe_executor(executor.summary())
            executor.export_timeline(
                os.path.join(args.obs_dir, "roundclock_trace.json"))
        rollup = writer.finalize(
            extra=({"async_summary": executor.summary()}
                   if executor is not None else None))
        record["obs"] = rollup
        say(f"obs: {rollup['rounds']} rounds, "
              f"{rollup['journal_events']} topology events, "
              f"{rollup['dropped_rows']} dropped rows -> {args.obs_dir}",
              flush=True)
        if args.health and "health" in rollup:
            h = rollup["health"]
            say("health scores (1.0 = clean):")
            for n in h["nodes"]:
                active = [k for k in ("divergence", "eta_stall",
                                      "eta_oscillation", "straggler",
                                      "drift") if n.get(k)]
                tag = f" [{', '.join(active)}]" if active else ""
                say(f"  node {n['node']}: {n['score']:.2f}{tag}")
            recs = h["recommendations"]
            for note in recs["notes"]:
                say(f"  advisory: {note}")
            if not recs["notes"]:
                say("  no advisories", flush=True)
    return record


def main(argv=None):
    args = parse_args(argv)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    run(cfg, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
