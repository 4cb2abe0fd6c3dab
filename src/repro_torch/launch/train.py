"""Training launcher: synchronous consensus-ADMM training end to end (port of
``repro/launch/train.py``, sync static path).

Every node row lives on one device (``--device``, CUDA unless ``cpu`` is
asked for), so ``--nodes`` takes the place of the reference's ``--mesh``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --reduced --steps 8 --scheme nap --local-steps 2 --device cpu

The async, observability, churn, checkpoint and pipeline flags come with
their slices; until then argparse rejects them.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.penalty import SCHEMES, PenaltyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import ConsensusConfig, ConsensusTrainer
from repro_torch.optim.adamw import AdamWConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--nodes", type=int, default=2,
                    help="ADMM nodes J, all held on --device")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--scheme", choices=SCHEMES, default="nap")
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--eta0", type=float, default=0.1)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--compression", default="none", choices=["none", "int8"],
                    help="legacy spelling of --wire-codec")
    ap.add_argument("--wire-codec", default="",
                    choices=["", "native", "int8"],
                    help="consensus wire codec: native = params dtype, "
                         "int8 = absmax per leaf + bitcast scale tail; "
                         "empty resolves from --compression")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def run(cfg: ArchConfig, args) -> dict:
    """Train ``cfg`` as ``args`` say; returns the run's record:
    per-step losses and seconds, per-round metrics, and the layout."""
    device = resolve_device(args.device)
    model = build_model(cfg)
    trainer = ConsensusTrainer(
        model, num_nodes=args.nodes, device=device,
        adamw=AdamWConfig(lr=args.lr),
        consensus=ConsensusConfig(
            penalty=PenaltyConfig(scheme=args.scheme, eta0=args.eta0),
            topology=args.topology, local_steps=args.local_steps,
            compression=args.compression, wire_codec=args.wire_codec))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = trainer.init_state(model.init(gen, device))
    data = SyntheticTokens(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq,
        batch_per_node=args.batch_per_node, num_nodes=trainer.num_nodes,
        seed=args.seed), device=device)

    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    record = {"losses": [], "step_seconds": [], "rounds": [],
              "layout": trainer.layout}
    t_start = time.perf_counter()
    for step in range(args.steps):
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, data.batch(step))
        loss = float(m["loss"])
        line = f"step {step:5d} loss {loss:.4f}"
        if trainer.should_sync(step):
            state, cm = trainer.consensus_step(state,
                                               data.batch(10**6 + step))
            rnd = {k: float(v) for k, v in cm.items()}
            record["rounds"].append(rnd)
            line += (f" | consensus r={rnd['r_max']:.4f} "
                     f"eta={rnd['eta_mean']:.4f}")
        sync()
        dt = time.perf_counter() - t0
        record["losses"].append(loss)
        record["step_seconds"].append(dt)
        print(f"{line} {dt * 1e3:.0f}ms", flush=True)
    print(f"done: {args.steps} steps in {time.perf_counter() - t_start:.1f}s",
          flush=True)
    return record


def main(argv=None):
    args = parse_args(argv)
    cfg = get_reduced_config(args.arch) if args.reduced \
        else get_config(args.arch)
    run(cfg, args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
