"""Topology event journal: the dynamic-network story as structured events
(port of ``repro/obs/journal.py``; host numpy).

The paper's §4 point is that budget gating "effectively leads to an
adaptive, dynamic network topology" — the journal makes that dynamic
inspectable after the fact. It is a host-side JSONL log of TRANSITIONS
(not per-round state dumps), derived by diffing consecutive drained
``TopologyState``/``PenaltyState`` snapshots — no extra device work in
the round: ``snapshot`` copies the ``[J, J]`` states to the host only at a
drain.

Event types (each record: ``{"step", "event", ...}``):

  * ``edge_gated`` / ``edge_revived``   — scheduler mask flips (undirected)
  * ``stale_gated`` / ``stale_revived`` — symmetrized staleness age crossed
                                          the bound (async executor)
  * ``node_dropped``                    — churn: liveness off (ghost row)
  * ``repair_activated``                — churn repair edge switched on
                                          (ghost-row backbone rewiring)
  * ``kick_parked`` / ``kick_absorbed`` — zero-kick weights parked across a
                                          round boundary / consumed by the
                                          kernel's dual absorption
  * ``budget_exhausted``                — eq. (9) budget spent (directed)
  * ``budget_topup``                    — eq. (10) top-up raised the budget
                                          (n_incr grew; revives the edge)

Diffing drained snapshots means transitions that flip there-and-back
WITHIN one drain window coalesce away — the journal records the topology
at drain resolution (``ObsConfig.drain_every``); set ``drain_every=1`` for
round-exact journaling.
"""
from __future__ import annotations

import json
import os
from typing import IO

import numpy as np
import torch


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def snapshot(topo, penalty=None) -> dict:
    """Copy the journal-relevant state to host numpy (one drain's worth):
    the ``TopologyState`` and ``PenaltyState`` tensors, wherever they
    live."""
    snap = {
        "mask": _host(topo.mask, bool),
        "node_alive": _host(topo.node_alive, bool),
        "repair": _host(topo.repair, bool),
        "age": _host(topo.age, np.int32),
        "kick": _host(topo.kick, np.float32),
    }
    if penalty is not None:
        snap["eta"] = _host(penalty.eta, np.float32)
        snap["cum_tau"] = _host(penalty.cum_tau, np.float32)
        snap["budget"] = _host(penalty.budget, np.float32)
        snap["n_incr"] = _host(penalty.n_incr, np.int32)
    return snap


def _undirected(pairs_mask: np.ndarray):
    """Yield (i, j), i < j, for True entries of a symmetric [J, J] mask."""
    ii, jj = np.nonzero(np.triu(pairs_mask, k=1))
    return zip(ii.tolist(), jj.tolist())


def _directed(pairs_mask: np.ndarray):
    m = pairs_mask.copy()
    np.fill_diagonal(m, False)
    ii, jj = np.nonzero(m)
    return zip(ii.tolist(), jj.tolist())


def diff_events(prev: dict, cur: dict, *, step: int,
                max_staleness: int | None = None) -> list[dict]:
    """Transitions between two snapshots -> ordered list of event dicts.

    ``max_staleness`` enables the stale gate/revive events (the bound is
    executor config, not state, so the caller supplies it).
    """
    ev: list[dict] = []

    def add(event, **kw):
        ev.append({"step": int(step), "event": event, **kw})

    # -- churn first: a dropped node explains its edges' flips -----------
    for v in np.nonzero(prev["node_alive"] & ~cur["node_alive"])[0]:
        add("node_dropped", node=int(v))
    for i, j in _undirected(~prev["repair"] & cur["repair"]):
        add("repair_activated", edge=[i, j])

    # -- scheduler gate/revive (mask is symmetric) -----------------------
    sym = lambda a: a & a.T
    for i, j in _undirected(sym(prev["mask"]) & ~sym(cur["mask"])):
        add("edge_gated", edge=[i, j],
            eta=float(cur["eta"][i, j]) if "eta" in cur else None)
    for i, j in _undirected(~sym(prev["mask"]) & sym(cur["mask"])):
        add("edge_revived", edge=[i, j],
            eta=float(cur["eta"][i, j]) if "eta" in cur else None)

    # -- staleness crossings (async executor) ----------------------------
    if max_staleness is not None:
        age_p = np.maximum(prev["age"], prev["age"].T)
        age_c = np.maximum(cur["age"], cur["age"].T)
        was, now = age_p <= max_staleness, age_c <= max_staleness
        for i, j in _undirected(was & ~now):
            add("stale_gated", edge=[i, j], age=int(age_c[i, j]))
        for i, j in _undirected(~was & now):
            add("stale_revived", edge=[i, j], age=int(age_c[i, j]))

    # -- zero-kick park/absorb -------------------------------------------
    kick_p, kick_c = prev["kick"] != 0.0, cur["kick"] != 0.0
    for i, j in _undirected(~kick_p & kick_c):
        add("kick_parked", edge=[i, j], weight=float(cur["kick"][i, j]))
    for i, j in _undirected(kick_p & ~kick_c):
        add("kick_absorbed", edge=[i, j], weight=float(prev["kick"][i, j]))

    # -- budget lifecycle (directed: cum_tau_ij != cum_tau_ji) -----------
    if "budget" in cur and "budget" in prev:
        ex_p = prev["cum_tau"] >= prev["budget"]
        ex_c = cur["cum_tau"] >= cur["budget"]
        for i, j in _directed(~ex_p & ex_c):
            add("budget_exhausted", edge=[i, j],
                cum_tau=float(cur["cum_tau"][i, j]),
                budget=float(cur["budget"][i, j]))
        for i, j in _directed(cur["n_incr"] > prev["n_incr"]):
            add("budget_topup", edge=[i, j],
                n_incr=int(cur["n_incr"][i, j]),
                budget=float(cur["budget"][i, j]))
    return ev


class EventJournal:
    """Append-only JSONL journal over drained state snapshots.

    ``observe(topo, penalty, step)`` diffs against the previous snapshot,
    writes one JSON line per transition, and keeps the new snapshot. The
    first observe establishes the baseline (no events). Flushed per
    observe so a crashed run keeps its journal.
    """

    def __init__(self, path: str, *, max_staleness: int | None = None):
        self.path = path
        self.max_staleness = max_staleness
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f: IO[str] | None = open(path, "a")
        self._prev: dict | None = None
        self.num_events = 0

    def observe(self, topo, penalty=None, *, step: int) -> list[dict]:
        snap = snapshot(topo, penalty)
        events: list[dict] = []
        if self._prev is not None:
            events = diff_events(self._prev, snap, step=step,
                                 max_staleness=self.max_staleness)
            for e in events:
                self._f.write(json.dumps(e) + "\n")
            if events:
                self._f.flush()
            self.num_events += len(events)
        self._prev = snap
        return events

    def emit(self, event: dict) -> dict:
        """Append one pre-built event record to the same JSONL stream.

        The health monitor (``obs.health``) routes its ``health_*`` events
        through here so topology transitions and health findings land in
        ONE chronologically ordered journal. Flushed per emit, mirroring
        ``observe``.
        """
        self._f.write(json.dumps(event) + "\n")
        self._f.flush()
        self.num_events += 1
        return event

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
