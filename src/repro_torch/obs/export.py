"""Exporters: per-run obs artifacts with one emit path for every run loop
(port of ``repro/obs/export.py``: the same files and keys, so that either
package's validator and dashboard read the other's runs).

``ObsWriter`` owns one run's observability directory (``--obs-dir``):

    run.json              run metadata (schema version, codec, scheme,
                          J, wire accounting) — written at open
    metrics.jsonl         drained metrics-ring rows, one JSON object per
                          consensus round, keys = ``obs.schema.RING_COLUMNS``
    node_metrics.jsonl    drained node-ring rows (``obs.node_ring``), one
                          JSON object per round: ``{"step", "<metric>":
                          [J values]}``, keys = ``schema.NODE_COLUMNS``
    events.jsonl          the topology event journal (``obs.journal``),
                          plus ``health_*`` events when the writer runs
                          the health monitor (``obs.health``)
    rollup.json           summary rollup written at finalize: convergence
                          curve, active-edge fraction over rounds, wire
                          bytes/round by codec, staleness histogram, host
                          round timing (``round_ms``), per-node health
                          table + advisory recommendations
    roundclock_trace.json Chrome/Perfetto trace of the ``RoundClock``
                          modeled timeline (async runs) — load in
                          https://ui.perfetto.dev to eyeball modeled
                          compute/wire overlap next to a measured
                          ``--profile-rounds`` torch.profiler trace

The launcher and the ``AsyncExecutor`` emit through this one writer, so
every run leaves the same artifact shapes (validated by ``python -m repro_torch.obs.export --validate DIR``).
``python -m repro_torch.obs.dashboard DIR`` renders the whole set into one
self-contained HTML file.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from repro_torch.obs import node_ring as node_ring_lib
from repro_torch.obs import ring as ring_lib
from repro_torch.obs import schema
from repro_torch.obs.journal import EventJournal

METRICS_FILE = "metrics.jsonl"
NODE_METRICS_FILE = "node_metrics.jsonl"
EVENTS_FILE = "events.jsonl"
ROLLUP_FILE = "rollup.json"
META_FILE = "run.json"
CLOCK_TRACE_FILE = "roundclock_trace.json"
DASHBOARD_FILE = "dashboard.html"


# ------------------------------------------------------------- writer ----
class ObsWriter:
    """One run's observability sink (see module docstring for the layout)."""

    def __init__(self, obs_dir: str, *, meta: dict | None = None,
                 max_staleness: int | None = None,
                 health: bool = False, health_cfg=None):
        self.dir = obs_dir
        os.makedirs(obs_dir, exist_ok=True)
        self.meta = {"schema_version": schema.SCHEMA_VERSION,
                     "ring_columns": list(schema.RING_COLUMNS),
                     "node_columns": list(schema.NODE_COLUMNS),
                     **(meta or {})}
        with open(self._p(META_FILE), "w") as f:
            json.dump(self.meta, f, indent=1, sort_keys=True)
            f.write("\n")
        self._metrics_f = open(self._p(METRICS_FILE), "a")
        # opened lazily on the first node row: a scalar-only run
        # (with_node_ring=False) must not leave an empty node artifact
        self._node_f = None
        self.journal = EventJournal(self._p(EVENTS_FILE),
                                    max_staleness=max_staleness)
        self._rows: list[dict] = []     # in-memory history for the rollup
        self._node_rows: list[dict] = []
        self.dropped_rows = 0
        self.dropped_node_rows = 0
        self._cursor = 0                # metrics-ring drain cursor
        self._node_cursor = 0           # node-ring drain cursor
        # host wall-clock between drains -> the rollup's round_ms (the
        # sync path's ONLY timing source; async runs also have the clock)
        self._drain_log: list[dict] = []
        self._last_drain_t: float | None = None
        self._max_staleness = max_staleness
        # online health monitor: fed per drain, events into the journal
        self._health_on = health or health_cfg is not None
        self._health_cfg = health_cfg
        self.health = None              # built lazily (needs J)
        self._executor_summary: dict | None = None

    def _p(self, name: str) -> str:
        return os.path.join(self.dir, name)

    # ------------------------------------------------------- emit path ----
    def append_metrics(self, rows: list[dict]):
        for r in rows:
            self._metrics_f.write(json.dumps(r) + "\n")
        if rows:
            self._metrics_f.flush()
            self._rows.extend(rows)

    def append_node_metrics(self, rows: list[dict]):
        if rows and self._node_f is None:
            self._node_f = open(self._p(NODE_METRICS_FILE), "a")
        for r in rows:
            self._node_f.write(json.dumps(r) + "\n")
        if rows:
            self._node_f.flush()
            self._node_rows.extend(rows)
        if rows and self._health_on:
            if self.health is None:
                from repro_torch.obs.health import HealthMonitor
                self.health = HealthMonitor(
                    len(rows[0]["r"]), self._health_cfg,
                    journal=self.journal,
                    max_staleness=self._max_staleness)
            self.health.observe_rows(rows)

    def drain(self, state, *, step: int) -> int:
        """One drain: pull both rings + journal the topology. Returns the
        number of new metrics rows. The ONE call every run loop makes every
        K rounds — ring rows to ``metrics.jsonl``, node-ring slabs to
        ``node_metrics.jsonl`` (and through the health monitor when on),
        topology/penalty diffs to ``events.jsonl``, overflow and host
        wall-clock accounted for the rollup."""
        now = time.monotonic()
        n = 0
        if getattr(state, "ring", None) is not None:
            rows, self._cursor, dropped = ring_lib.drain_rows(
                state.ring, self._cursor)
            self.dropped_rows += dropped
            self.append_metrics(rows)
            n = len(rows)
        if getattr(state, "node_ring", None) is not None:
            nrows, self._node_cursor, ndropped = \
                node_ring_lib.drain_node_rows(state.node_ring,
                                              self._node_cursor)
            self.dropped_node_rows += ndropped
            self.append_node_metrics(nrows)
        self.journal.observe(state.topo, getattr(state, "penalty", None),
                             step=step)
        # the first drain anchors the clock; each later one records the
        # wall time the n rounds since the previous drain took
        if self._last_drain_t is not None and n > 0:
            self._drain_log.append({
                "step": int(step), "rounds": n,
                "wall_s": now - self._last_drain_t})
        self._last_drain_t = now
        return n

    def observe_executor(self, summary: dict):
        """Feed an ``AsyncExecutor.summary()`` to the health monitor
        (clock-lag straggler path); stored for the rollup either way."""
        self._executor_summary = summary
        if self.health is not None:
            self.health.observe_executor(summary)

    def write_roundclock_trace(self, clock) -> str:
        path = self._p(CLOCK_TRACE_FILE)
        write_roundclock_trace(clock, path)
        return path

    # --------------------------------------------------------- rollup ----
    def finalize(self, extra: dict | None = None) -> dict:
        """Write ``rollup.json`` from the accumulated history and close."""
        rollup = build_rollup(self._rows, meta=self.meta,
                              dropped_rows=self.dropped_rows,
                              journal_events=self.journal.num_events,
                              node_rows=self._node_rows,
                              dropped_node_rows=self.dropped_node_rows,
                              drain_log=self._drain_log)
        if self.health is not None:
            rollup["health"] = {
                **self.health.table(),
                "recommendations": self.health.recommendations(),
            }
        if self._executor_summary is not None:
            rollup["executor"] = self._executor_summary
        if extra:
            rollup.update(extra)
        with open(self._p(ROLLUP_FILE), "w") as f:
            json.dump(rollup, f, indent=1, sort_keys=True)
            f.write("\n")
        self.close()
        return rollup

    def close(self):
        if self._metrics_f is not None:
            self._metrics_f.close()
            self._metrics_f = None
        if self._node_f is not None:
            self._node_f.close()
            self._node_f = None
        self.journal.close()


def build_rollup(rows: list[dict], *, meta: dict | None = None,
                 dropped_rows: int = 0, journal_events: int = 0,
                 node_rows: list[dict] | None = None,
                 dropped_node_rows: int = 0,
                 drain_log: list[dict] | None = None) -> dict:
    """Summary rollup from drained metrics rows (pure, benchmark-friendly)."""
    meta = meta or {}
    node_rows = node_rows or []
    drain_log = drain_log or []

    def curve(key):
        return [r[key] for r in rows]

    ages = [int(r.get("age_max", 0)) for r in rows]
    hist: dict[str, int] = {}
    for a in ages:
        hist[str(a)] = hist.get(str(a), 0) + 1
    stale = [float(r.get("stale_edges", 0.0)) for r in rows]
    # host round timing from the drain wall-clock deltas (the first drain
    # only anchors the clock, so each entry is wall_s over `rounds` rounds)
    round_ms = [1e3 * d["wall_s"] / max(d["rounds"], 1) for d in drain_log]
    per_node: dict = {}
    if node_rows:
        j = len(node_rows[0]["r"])
        per_node = {
            "num_nodes": j,
            "rounds": len(node_rows),
            "dropped_rows": int(dropped_node_rows),
            "r_last": [float(v) for v in node_rows[-1]["r"]],
            "r_mean": [float(np.mean([nr["r"][i] for nr in node_rows]))
                       for i in range(j)],
            "age_mean": [float(np.mean([nr["age_max"][i]
                                        for nr in node_rows]))
                         for i in range(j)],
            "wire_rx_bytes_total": [
                float(np.sum([nr["wire_rx_bytes"][i] for nr in node_rows]))
                for i in range(j)],
        }
    return {
        "schema_version": schema.SCHEMA_VERSION,
        "rounds": len(rows),
        "dropped_rows": int(dropped_rows),
        "journal_events": int(journal_events),
        "steps": curve("step") if rows else [],
        "convergence": {k: curve(k) for k in
                        ("r_max", "s_max", "f_mean")} if rows else {},
        "active_edge_fraction": curve("active_edges") if rows else [],
        "eta_mean": curve("eta_mean") if rows else [],
        "staleness": {
            "age_max_hist": hist,
            "stale_edges_mean": (float(np.mean(stale)) if stale else 0.0),
        },
        "timing": {
            "drains": len(drain_log),
            "round_ms": (float(np.mean(round_ms)) if round_ms else None),
            "round_ms_p50": (float(np.percentile(round_ms, 50))
                             if round_ms else None),
            "round_ms_max": (float(np.max(round_ms)) if round_ms else None),
        },
        "per_node": per_node,
        "wire": {k: meta[k] for k in
                 ("wire_codec", "wire_bytes_per_round", "offsets")
                 if k in meta},
    }


# --------------------------------------------- RoundClock -> Perfetto ----
def roundclock_trace_events(clock) -> list[dict]:
    """Chrome-trace events for the clock's modeled timeline so far.

    Reconstructs the discrete-event model analytically (the clock's stated
    conventions, ``async_exec.clock`` docstring): node i's round k computes
    over ``[k*c_i, (k+1)*c_i)`` (double-buffered permutes hide behind
    compute), and the payload it sends at that round's end is on the wire
    for ``wire_s``. One Perfetto track per node for compute, one for its
    wire, instants for fleet ticks. Times in microseconds (trace units).
    """
    us = 1e6
    ev: list[dict] = []
    compute_s = np.asarray(clock.compute_s, dtype=float)
    j = int(compute_s.shape[0])
    for i in range(j):
        ev.append({"ph": "M", "pid": 0, "tid": i, "name": "thread_name",
                   "args": {"name": f"node {i} compute "
                                    f"({compute_s[i]:g}s/round)"}})
        ev.append({"ph": "M", "pid": 0, "tid": j + i, "name": "thread_name",
                   "args": {"name": f"node {i} wire"}})
        for k in range(int(clock.rounds_done[i])):
            t0 = k * compute_s[i]
            ev.append({"ph": "X", "pid": 0, "tid": i, "cat": "compute",
                       "name": f"round {k}", "ts": t0 * us,
                       "dur": compute_s[i] * us})
            if clock.wire_s > 0:
                ev.append({"ph": "X", "pid": 0, "tid": j + i, "cat": "wire",
                           "name": f"send {k}",
                           "ts": (t0 + compute_s[i]) * us,
                           "dur": clock.wire_s * us})
    tick = getattr(clock, "tick_s", 0.0)
    for t in range(int(clock.ticks)):
        ev.append({"ph": "i", "pid": 0, "tid": 2 * j, "s": "g",
                   "name": f"fleet tick {t + 1}",
                   "ts": (t + 1) * tick * us})
    ev.append({"ph": "M", "pid": 0, "tid": 2 * j, "name": "thread_name",
               "args": {"name": "fleet ticks"}})
    return ev


def write_roundclock_trace(clock, path: str) -> str:
    doc = {"displayTimeUnit": "ms",
           "otherData": {
               "model": "repro_torch.async_exec.clock.RoundClock",
               "sync_round_s": float(clock.sync_round_s),
               "tick_s": float(clock.tick_s),
               "elapsed_s": float(clock.time_s)},
           "traceEvents": roundclock_trace_events(clock)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return path


# ---------------------------------------------------------- validation ----
def validate_obs_dir(obs_dir: str) -> dict:
    """Well-formedness report for one obs directory (CI's artifact gate).

    Checks every present artifact parses as (JSONL-)JSON and that metrics
    rows carry the full schema key set. Missing optional artifacts
    (roundclock trace on sync runs) are reported, not failed; a missing
    metrics/rollup file IS a failure — every ``--obs-dir`` run must leave
    them.
    """
    report = {"dir": obs_dir, "files": {}, "errors": []}

    def err(msg):
        report["errors"].append(msg)

    for name, required in ((META_FILE, True), (METRICS_FILE, True),
                           (NODE_METRICS_FILE, False),
                           (EVENTS_FILE, True), (ROLLUP_FILE, True),
                           (CLOCK_TRACE_FILE, False),
                           (DASHBOARD_FILE, False)):
        path = os.path.join(obs_dir, name)
        info = {"present": os.path.exists(path)}
        report["files"][name] = info
        if not info["present"]:
            if required:
                err(f"{name}: missing")
            continue
        try:
            with open(path) as f:
                if name.endswith(".jsonl"):
                    rows = [json.loads(ln) for ln in f if ln.strip()]
                    info["rows"] = len(rows)
                    if name == METRICS_FILE:
                        want = set(schema.RING_COLUMNS)
                        for i, r in enumerate(rows):
                            missing = want - set(r)
                            if missing:
                                err(f"{name}:{i}: missing keys "
                                    f"{sorted(missing)}")
                                break
                    if name == NODE_METRICS_FILE:
                        want = set(schema.NODE_COLUMNS)
                        for i, r in enumerate(rows):
                            missing = want - set(r)
                            if missing:
                                err(f"{name}:{i}: missing keys "
                                    f"{sorted(missing)}")
                                break
                elif name == DASHBOARD_FILE:
                    pass  # HTML; checked by `-m repro_torch.obs.dashboard --check`
                else:
                    doc = json.load(f)
                    if name == ROLLUP_FILE:
                        for k in ("rounds", "convergence", "staleness",
                                  "timing"):
                            if k not in doc:
                                err(f"{name}: missing key {k!r}")
                    if name == CLOCK_TRACE_FILE and "traceEvents" not in doc:
                        err(f"{name}: no traceEvents")
        except (json.JSONDecodeError, OSError) as e:
            err(f"{name}: {e}")
    report["ok"] = not report["errors"]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="validate an --obs-dir artifact set")
    ap.add_argument("--validate", required=True, metavar="DIR",
                    help="obs directory to check for well-formed artifacts")
    args = ap.parse_args(argv)
    report = validate_obs_dir(args.validate)
    print(json.dumps(report, indent=1, sort_keys=True))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
