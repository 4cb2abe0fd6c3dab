"""Online health monitor: the layer that INTERPRETS per-node telemetry (a
host-numpy copy of ``repro/obs/health.py``).

The node ring (``obs.node_ring``) records what each node did; this module
decides what it means. A ``HealthMonitor`` consumes drained per-node rows
(``schema.node_row_to_dict`` dicts — the same records ``ObsWriter`` spools
to ``node_metrics.jsonl``) plus, optionally, the async executor's clock
summary, and runs a bank of four deterministic detectors:

  * **divergence** — windowed growth of a node's primal residual ``r_i``:
    the second half of the window persistently above ``divergence_ratio``
    x the first half. Temporal: "this node is getting WORSE".
  * **eta stall / oscillation** — is the paper's adaptation (eq. 7-9)
    still doing anything for this node? Stall fires when the node's
    ``eta_row_mean`` is frozen across the window while its residual is
    still material (adaptation gave up early); oscillation fires when the
    per-round deltas keep flipping sign at material amplitude (the
    flapping mode the scheme's monotone budget is supposed to preclude).
  * **straggler** — staleness ages from the rows (mean incident age vs the
    bound) and, when an executor summary is supplied, RoundClock lag
    percentiles (rounds behind the fleet front-runner).
  * **drift** — cross-sectional outlier: a node whose residual sits
    persistently above ``drift_ratio`` x the fleet median of the same
    round. Unlike divergence this needs no growth — a node stuck far from
    consensus while everyone else converged drifts without diverging.

Detectors fire on the TRANSITION into the bad state (one ``health_*``
event per episode, re-armed when the node recovers), so a journal stays
readable; the current boolean state lives in the per-node score table.
Everything is a pure function of the observed series — no wall clock, no
randomness — which is what makes the synthetic-trace unit tests exact.

Events ride the existing ``EventJournal`` JSONL (``journal.emit``), the
score table and the advisory ``recommendations`` block land in the
ObsWriter rollup, and ``launch/train.py --health`` prints both. The
recommendations are ADVISORY ONLY — nothing in the trainer acts on them
(that is the ROADMAP's elastic/autoscaler item, which needs exactly these
signals).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

# the event names this module can emit (the dashboard and the tests key
# off this registry; append-only like the schema column registries)
HEALTH_EVENTS = (
    "health_divergence",
    "health_eta_stall",
    "health_eta_oscillation",
    "health_straggler",
    "health_drift",
)

# score deductions per active detector state (clamped to [0, 1]); the
# weights order the failure modes by how actionable they are: a diverging
# node poisons its neighbors' consensus pulls, a straggler only slows them
_WEIGHTS = {
    "divergence": 0.5,
    "eta_stall": 0.2,
    "eta_oscillation": 0.2,
    "straggler": 0.3,
    "drift": 0.4,
}


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detector thresholds (all pure, all deterministic).

    Attributes:
      window: rows of per-node history each detector looks at. Detectors
        are silent until the window fills.
      divergence_ratio: fire divergence when mean(r_i over the window's
        second half) > ratio x mean(first half).
      min_residual: residuals below this are "converged" — no divergence,
        stall or drift verdicts are rendered on noise-floor values.
      stall_tol: max |delta eta_row_mean| over the window still counting
        as frozen (relative to the window's mean level).
      osc_flip_frac: fraction of consecutive delta-sign flips (among
        material deltas) above which eta is oscillating.
      drift_ratio: fire drift when r_i > ratio x fleet median for every
        row in the window.
      straggler_age_frac: fire straggler when the node's mean incident
        staleness age exceeds this fraction of ``max_staleness``.
      straggler_lag: fire straggler when the clock lag (rounds behind the
        fleet front-runner) reaches this many rounds.
      drop_score: score threshold under which a node becomes a
        drop-candidate in the recommendations block.
    """

    window: int = 8
    divergence_ratio: float = 2.0
    min_residual: float = 1e-6
    stall_tol: float = 1e-3
    osc_flip_frac: float = 0.6
    drift_ratio: float = 4.0
    straggler_age_frac: float = 0.5
    straggler_lag: int = 4
    drop_score: float = 0.5

    def __post_init__(self):
        if self.window < 2:
            raise ValueError(f"window {self.window} < 2")


class HealthMonitor:
    """Stateful detector bank over a stream of drained node rows.

    Args:
      cfg: detector thresholds.
      num_nodes: fleet size J (row vectors are validated against it).
      journal: optional ``obs.journal.EventJournal`` — fired events are
        ``emit``-ted there as well as returned.
      max_staleness: the async bound (enables the age-based straggler
        path; sync traces leave it None and ages are all zero anyway).
    """

    def __init__(self, num_nodes: int, cfg: HealthConfig | None = None, *,
                 journal=None, max_staleness: int | None = None):
        self.cfg = cfg or HealthConfig()
        self.num_nodes = int(num_nodes)
        self.journal = journal
        self.max_staleness = max_staleness
        w = self.cfg.window
        self._r = [deque(maxlen=w) for _ in range(num_nodes)]
        self._eta = [deque(maxlen=w) for _ in range(num_nodes)]
        self._age = [deque(maxlen=w) for _ in range(num_nodes)]
        self._r_med = deque(maxlen=w)        # fleet median per row
        self._state = {name: [False] * num_nodes
                       for name in _WEIGHTS}  # current boolean verdicts
        self._fires = {name: [0] * num_nodes for name in _WEIGHTS}
        self._lag = [0] * num_nodes           # latest executor lag
        self._last_step = 0
        self.num_rows = 0

    # ------------------------------------------------------ ingestion ----
    def observe_rows(self, node_rows: list[dict]) -> list[dict]:
        """Feed drained per-node rows (chronological); returns new events."""
        events: list[dict] = []
        for row in node_rows:
            events.extend(self._observe_row(row))
        return events

    def _observe_row(self, row: dict) -> list[dict]:
        j = self.num_nodes
        r = [float(v) for v in row["r"]]
        if len(r) != j:
            raise ValueError(f"row has {len(r)} nodes, monitor built "
                             f"for {j}")
        eta = [float(v) for v in row["eta_row_mean"]]
        age = [int(v) for v in row["age_max"]]
        alive = [bool(v) for v in row.get("alive", [1.0] * j)]
        self._last_step = step = int(row["step"])
        live_r = [ri for ri, a in zip(r, alive) if a]
        self._r_med.append(float(np.median(live_r)) if live_r else 0.0)
        for i in range(j):
            self._r[i].append(r[i])
            self._eta[i].append(eta[i])
            self._age[i].append(age[i])
        self.num_rows += 1

        events: list[dict] = []
        for i in range(j):
            if not alive[i]:
                # ghost rows carry stale values; clear their verdicts
                for name in _WEIGHTS:
                    self._state[name][i] = False
                continue
            events.extend(self._judge(i, step))
        return events

    def observe_executor(self, summary: dict) -> list[dict]:
        """Feed an ``AsyncExecutor.summary()`` dict (clock lag path).

        Raise-only: a lag above the threshold flags the node, but a low
        lag never CLEARS a straggler verdict — the per-row age path owns
        recovery (the two paths share one state, and a summary snapshot
        must not erase what the age distribution is still showing).
        """
        lag = summary.get("round_lag")
        if lag is None:
            return []
        self._lag = [int(v) for v in lag]
        events: list[dict] = []
        for i, l in enumerate(self._lag):
            if l >= self.cfg.straggler_lag:
                events.extend(self._transition(
                    "straggler", i, True, self._last_step, lag=l))
        return events

    # ------------------------------------------------------- detectors ----
    def _judge(self, i: int, step: int) -> list[dict]:
        cfg = self.cfg
        events: list[dict] = []
        r = np.asarray(self._r[i], dtype=np.float64)
        full = len(r) >= cfg.window

        # divergence: second half of the window grew past ratio x first
        if full:
            half = cfg.window // 2
            lo, hi = float(r[:half].mean()), float(r[half:].mean())
            verdict = (hi > cfg.min_residual
                       and hi > cfg.divergence_ratio * max(lo,
                                                           cfg.min_residual))
            events.extend(self._transition(
                "divergence", i, verdict, step,
                r_early=lo, r_late=hi))

        # eta stall / oscillation
        if full:
            eta = np.asarray(self._eta[i], dtype=np.float64)
            deltas = np.diff(eta)
            level = max(float(np.abs(eta).mean()), 1e-12)
            material = np.abs(deltas) > cfg.stall_tol * level
            frozen = not material.any()
            resid = float(r[-1])
            stall = frozen and resid > cfg.min_residual
            events.extend(self._transition(
                "eta_stall", i, stall, step,
                eta=float(eta[-1]), r=resid))
            osc = False
            if material.sum() >= 2:
                signs = np.sign(deltas[material])
                flips = float((signs[1:] != signs[:-1]).mean())
                osc = flips >= cfg.osc_flip_frac
            events.extend(self._transition(
                "eta_oscillation", i, osc, step, eta=float(eta[-1])))

        # straggler (age path; the lag path is observe_executor)
        if full and self.max_staleness is not None and self.max_staleness > 0:
            mean_age = float(np.mean(self._age[i]))
            verdict = mean_age > cfg.straggler_age_frac * self.max_staleness
            events.extend(self._transition(
                "straggler", i, verdict, step, mean_age=mean_age))

        # drift: persistently far above the fleet median
        if full and len(self._r_med) >= cfg.window:
            med = np.asarray(self._r_med, dtype=np.float64)
            above = r > np.maximum(cfg.drift_ratio * med, cfg.min_residual)
            verdict = bool(above.all()) and float(r[-1]) > cfg.min_residual
            events.extend(self._transition(
                "drift", i, verdict, step,
                r=float(r[-1]), fleet_median=float(med[-1])))
        return events

    def _transition(self, name: str, i: int, verdict: bool, step: int,
                    **detail) -> list[dict]:
        """Edge-triggered state machine: one event per episode."""
        was = self._state[name][i]
        self._state[name][i] = verdict
        if verdict and not was:
            self._fires[name][i] += 1
            ev = {"step": int(step), "event": f"health_{name}",
                  "node": int(i), **detail}
            if self.journal is not None:
                self.journal.emit(ev)
            return [ev]
        return []

    # --------------------------------------------------------- outputs ----
    def scores(self) -> list[float]:
        """Per-node health in [0, 1]: 1 minus the active-state deductions."""
        out = []
        for i in range(self.num_nodes):
            s = 1.0 - sum(w for name, w in _WEIGHTS.items()
                          if self._state[name][i])
            out.append(round(max(0.0, s), 4))
        return out

    def table(self) -> dict:
        """The rollup's per-node health table (JSON-ready)."""
        scores = self.scores()
        nodes = []
        for i in range(self.num_nodes):
            nodes.append({
                "node": i,
                "score": scores[i],
                **{name: bool(self._state[name][i]) for name in _WEIGHTS},
                "fires": {name: self._fires[name][i] for name in _WEIGHTS
                          if self._fires[name][i]},
                "lag": self._lag[i],
            })
        return {"rows_seen": self.num_rows, "last_step": self._last_step,
                "window": self.cfg.window, "nodes": nodes}

    def recommendations(self) -> dict:
        """Advisory block: printed by ``--health``, never acted on."""
        cfg = self.cfg
        scores = self.scores()
        drop = [i for i, s in enumerate(scores)
                if s < cfg.drop_score
                and (self._state["divergence"][i]
                     or self._state["drift"][i]
                     or self._state["straggler"][i])]
        # a stalled eta with material residual is exactly what the
        # paper's eq. (10) budget top-up exists to fix
        topup = [i for i in range(self.num_nodes)
                 if self._state["eta_stall"][i]]
        notes = []
        for i in drop:
            active = [n for n in _WEIGHTS if self._state[n][i]]
            notes.append(f"node {i}: score {scores[i]} "
                         f"({', '.join(active)}) — drop candidate")
        for i in topup:
            notes.append(f"node {i}: eta stalled with residual above "
                         f"floor — raise its budget (eq. 10 top-up)")
        return {"drop_candidates": drop, "budget_topup": topup,
                "notes": notes}


def analyze_trace(node_rows: list[dict], num_nodes: int, *,
                  cfg: HealthConfig | None = None,
                  executor_summary: dict | None = None,
                  journal=None, max_staleness: int | None = None) -> dict:
    """One-shot convenience: run a fresh monitor over a full trace.

    Returns ``{"events", "table", "recommendations"}`` — what the
    ObsWriter folds into the rollup and the dashboard annotates.
    """
    mon = HealthMonitor(num_nodes, cfg, journal=journal,
                        max_staleness=max_staleness)
    events = mon.observe_rows(node_rows)
    if executor_summary is not None:
        events += mon.observe_executor(executor_summary)
    return {"events": events, "table": mon.table(),
            "recommendations": mon.recommendations()}
