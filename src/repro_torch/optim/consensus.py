"""Consensus-ADMM training: the synchronous, static-topology trainer (port of
``repro/optim/consensus.py:ConsensusTrainer``).

Every node i of the ADMM graph holds its own parameter replica theta_i.
Between consensus rounds each node takes H local AdamW steps on its own
data (f_i = its local loss). A consensus round then

  1. packs the replicas into one flat ``[J, total]`` buffer and encodes it
     with the wire codec (native or int8, ``repro_torch.wire``),
  2. exchanges it: one roll of the node axis per graph offset,
  3. probes f_i(theta_j) on a held-out batch (eq. 7 kappas),
  4. runs ONE fused kernel call (``kernels.ops.consensus_round``): dequant,
     both neighbor means, the prox pull, the dual update and the eq. 5
     residual partials,
  5. updates the per-edge penalties with the paper's schemes
     (``repro_torch.core.penalty``).

All J node rows live on one device, so the exchange is a roll of dim 0 of
the wire buffer. The graph must be circulant (ring, complete, expander):
its edges are the offsets of node 0 applied to every node.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch import wire as wire_lib
from repro_torch.core.graph import Graph, build_graph
from repro_torch.core.penalty import (PenaltyConfig, PenaltyState,
                                      init_penalty_state, update_penalty)
from repro_torch.kernels import ops as kops
from repro_torch.models.model import Model
from repro_torch.optim import adamw as adamw_lib
from repro_torch.optim import flatten


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """The fields of the reference's ``ConsensusConfig`` that the sync,
    static, unsharded path reads (same names and defaults). The round
    always goes through ``kops.consensus_round``, whose tensors' device picks
    the kernel or the plain version, and the flat layout's block size is
    always the reference's automatic one."""

    penalty: PenaltyConfig = PenaltyConfig(scheme="nap", eta0=1.0)
    topology: str = "ring"         # circulant: ring | complete | expander
    local_steps: int = 8           # H — local optimizer steps per round
    prox_step: float = 0.5         # alpha in the prox pull
    compression: str = "none"      # legacy spelling: none | int8
    wire_codec: str = ""           # native | int8; empty => from compression


class TrainState(NamedTuple):
    params: Any                    # tree of [J, ...] per-node replicas
    opt: adamw_lib.AdamWState      # moments [J, ...] f32, one shared step
    lam: torch.Tensor              # [J, total] f32 flat duals
    theta_bar_prev: torch.Tensor   # [J, total] f32 neighbor means (eq. 5)
    penalty: PenaltyState          # [J, J]
    step: torch.Tensor             # [] int32


def _roll_into(dst: torch.Tensor, src: torch.Tensor, off: int) -> None:
    """dst[:] = torch.roll(src, -off, 0), written straight into ``dst``:
    row i receives node (i + off) % J's message."""
    j = src.shape[0]
    off %= j
    dst[:j - off].copy_(src[off:])
    dst[j - off:].copy_(src[:off])


class ConsensusTrainer:
    """Local steps and consensus rounds for a model over J nodes held on
    one device."""

    def __init__(self, model: Model, *, num_nodes: int,
                 device: torch.device | str,
                 adamw: adamw_lib.AdamWConfig, consensus: ConsensusConfig):
        self.model = model
        self.device = torch.device(device)
        self.acfg = adamw
        self.ccfg = consensus
        self.num_nodes = int(num_nodes)
        self.graph: Graph = build_graph(consensus.topology, self.num_nodes) \
            if self.num_nodes > 1 else build_graph("complete", 1)
        self.offsets = self.graph.neighbor_offsets_ring() \
            if self.num_nodes > 1 else []
        self._check_circulant()
        defs = model.param_defs()
        self.layout = flatten.FlatLayout.for_tree(
            defs, block_size=flatten.auto_block_size(defs), node_axis=False)
        self.codec_name = wire_lib.resolve_codec_name(
            consensus.wire_codec or consensus.compression)
        self.codec = wire_lib.get_codec(self.codec_name, self.layout)
        # the kernel indexes the [deg, J, L] scales by these ids unchecked,
        # so the table is checked here, once
        table = self.layout.block_leaf
        if table.size and not (0 <= table.min()
                               and table.max() < self.codec.scale_width):
            raise ValueError(f"block->leaf ids span [{table.min()}, "
                             f"{table.max()}], the wire has "
                             f"{self.codec.scale_width} scales")
        self.block_leaf = torch.as_tensor(table, dtype=torch.int32,
                                          device=self.device)
        self._adj = torch.as_tensor(self.graph.adj, device=self.device)

    def _check_circulant(self):
        j = self.num_nodes
        u = np.zeros((j, j), dtype=bool)
        for off in self.offsets:
            u[np.arange(j), (np.arange(j) + off) % j] = True
        if not np.array_equal(u, self.graph.adj):
            raise ValueError(
                f"topology {self.ccfg.topology!r} at J={j} is not circulant; "
                "the single-device engine rolls by node 0's offsets")

    # ------------------------------------------------------------ state ----
    def init_state(self, params1: dict) -> TrainState:
        """State with ``params1`` (one node's parameters) on every node."""
        j = self.num_nodes
        params = tree_lib.tree_map(
            lambda x: x.to(self.device)[None].expand(j, *x.shape).clone(),
            params1)
        flat_shape = (j, self.layout.total)
        return TrainState(
            params=params, opt=adamw_lib.init(self.acfg, params),
            lam=torch.zeros(flat_shape, dtype=torch.float32,
                            device=self.device),
            theta_bar_prev=torch.zeros(flat_shape, dtype=torch.float32,
                                       device=self.device),
            penalty=init_penalty_state(self.ccfg.penalty, j,
                                       device=self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device))

    # ------------------------------------------------------- local steps ----
    def train_step(self, state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        """One local AdamW step on every node (no exchange).

        Nodes run one after another — forward, backward and update — so the
        peak memory holds one node's gradients. The update is in place.
        """
        losses, gnorms = [], []
        for i in range(self.num_nodes):
            p_i = tree_lib.tree_map(lambda x: x[i], state.params)
            paths = [p for p, _ in tree_lib.leaves_with_paths(p_i)]
            leaves = [x.detach().requires_grad_()
                      for x in tree_lib.leaves(p_i)]
            loss, _ = self.model.loss(tree_lib.unflatten(paths, leaves),
                                      {k: v[i] for k, v in batch.items()})
            grads = torch.autograd.grad(loss, leaves)
            del leaves
            opt_i = adamw_lib.AdamWState(
                step=state.opt.step,
                m=tree_lib.tree_map(lambda x: x[i], state.opt.m),
                v=tree_lib.tree_map(lambda x: x[i], state.opt.v))
            _, _, mtr = adamw_lib.update(self.acfg, opt_i, p_i,
                                         tree_lib.unflatten(paths,
                                                            list(grads)))
            del grads
            losses.append(loss.detach())
            gnorms.append(mtr["grad_norm"])
        new = state._replace(
            opt=state.opt._replace(step=state.opt.step + 1),
            step=state.step + 1)
        return new, {"loss": torch.stack(losses).mean(),
                     "grad_norm": torch.stack(gnorms)}

    def should_sync(self, step: int) -> bool:
        return self.num_nodes > 1 and (step + 1) % self.ccfg.local_steps == 0

    # --------------------------------------------------- consensus round ----
    @torch.no_grad()
    def _probe_losses(self, params: dict, batch: dict) -> torch.Tensor:
        """[J] local objectives f_i at node i's row of ``params``."""
        return torch.stack([
            self.model.loss(tree_lib.tree_map(lambda x: x[i], params),
                            {k: v[i] for k, v in batch.items()})[0]
            for i in range(self.num_nodes)])

    @torch.no_grad()
    def consensus_step(self, state: TrainState, probe_batch: dict
                       ) -> tuple[TrainState, dict]:
        """One ADMM consensus round over the flat buffers."""
        dev = self.device
        f32 = torch.float32
        if self.num_nodes <= 1:
            return state, {"r_max": torch.zeros((), device=dev),
                           "eta_mean": torch.tensor(self.ccfg.penalty.eta0,
                                                    device=dev)}
        j = self.num_nodes
        offsets = self.offsets
        deg = len(offsets)
        lay = self.layout
        idx = torch.arange(j, device=dev)

        f_self = self._probe_losses(state.params, probe_batch)     # [J]

        # pack in the params' float dtype (bf16 params -> bf16 wire)
        theta_flat = lay.pack(state.params, dtype=lay.wire_dtype)
        wire = self.codec.encode(theta_flat)

        # exchange: rolled[d] = torch.roll(wire, -off_d, 0). These are
        # COPIES, never views of theta_flat: the kernel updates theta_flat
        # in place on the card.
        rolled = torch.empty((deg,) + tuple(wire.shape), dtype=wire.dtype,
                             device=dev)
        for d, off in enumerate(offsets):
            _roll_into(rolled[d], wire, off)
        del wire
        payloads, dec_scales = self.codec.decode(rolled)
        wires = payloads.contiguous()                 # [deg, J, total]
        del rolled, payloads

        eta = state.penalty.eta
        sym_sum = torch.zeros((j,), dtype=f32, device=dev)
        f_nbr = torch.zeros((j, j), dtype=f32, device=dev)
        e_rows = []
        for d, off in enumerate(offsets):
            jidx = (idx + off) % j
            f_off = self._probe_losses(self.codec.unpack(
                wires[d], None if dec_scales is None else dec_scales[d]),
                probe_batch)
            e_sym = 0.5 * (eta[idx, jidx] + eta[jidx, idx])             # [J]
            # F[i, (i+off) % J] through the static circulant mask
            mask = torch.as_tensor(np.roll(np.eye(j), off, axis=1),
                                   dtype=f32, device=dev)
            f_nbr = f_nbr + f_off[:, None] * mask
            sym_sum = sym_sum + e_sym
            e_rows.append(e_sym)
        e_stack = torch.stack(e_rows)                                  # [deg, J]
        scales = dec_scales.contiguous() if dec_scales is not None \
            else torch.ones((deg, j, self.codec.scale_width), dtype=f32,
                            device=dev)

        alpha = self.ccfg.prox_step / (1.0 + 2.0 * sym_sum)           # [J]
        eta_node = sym_sum / deg
        theta_new, lam_new, bar_new, r_sq, s_sq = kops.consensus_round(
            theta_flat, state.lam, state.theta_bar_prev, wires, scales,
            e_stack, alpha, sym_sum, eta_node, block_leaf=self.block_leaf,
            block_size=lay.block_size)
        del wires

        # theta_new -> the parameter replicas, in place
        for dst, src in zip(tree_lib.leaves(state.params),
                            tree_lib.leaves(lay.unpack(theta_new)),
                            strict=True):
            dst.copy_(src)
        del theta_flat, theta_new
        r_norm = torch.sqrt(r_sq)
        s_norm = torch.sqrt(s_sq)
        penalty_new = update_penalty(
            self.ccfg.penalty, state.penalty, adj=self._adj, f_self=f_self,
            f_nbr=f_nbr, r_norm=r_norm, s_norm=s_norm)
        new = state._replace(lam=lam_new, theta_bar_prev=bar_new,
                             penalty=penalty_new)
        adj = self._adj
        metrics = {
            "r_max": r_norm.max(), "s_max": s_norm.max(),
            "f_mean": f_self.mean(),
            "eta_mean": torch.where(adj, penalty_new.eta, 0.0).sum()
            / torch.clamp_min(adj.sum(), 1),
            "active_edges": torch.ones((), device=dev),
        }
        return new, metrics
