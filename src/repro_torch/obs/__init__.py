"""Observability: metrics rings, spans, journal, health monitor, exporters
and dashboard (port of ``repro/obs``; the same public names).

  * ``obs.schema``    — the per-round key set and ring columns
    (``ROUND_METRICS``) and the per-node ones (``NODE_METRICS``) that every
    round path emits.
  * ``obs.ring``      — the ``[cap, n_metrics]`` scalar metrics ring on the
    trainer's device, riding in ``TrainState``; appended in the round with
    no host sync, drained every K rounds.
  * ``obs.node_ring`` — the per-node ``[cap, J, n_cols]`` ring beside it.
  * ``obs.trace``     — ``torch.profiler.record_function`` span factories
    with the round-phase names.
  * ``obs.journal``   — host JSONL event journal from diffing drained
    ``TopologyState``/``PenaltyState`` snapshots (plus ``emit`` for health
    events).
  * ``obs.health``    — the detector bank over drained node rows:
    divergence, eta stall/oscillation, straggler, drift; per-node scores
    and advisory recommendations.
  * ``obs.export``    — the per-run artifact writer (``--obs-dir``) and the
    artifact validator CLI.
  * ``obs.dashboard`` — one obs directory -> one self-contained HTML file.

Everything is off by default: ``ConsensusConfig.obs=None`` (or
``ObsConfig(enabled=False)``) runs the round with the same launches and
numbers as without the subsystem; ``ObsConfig(with_node_ring=False)``
keeps the scalar ring only.
"""
from repro_torch.obs.export import (ObsWriter, build_rollup,
                                    roundclock_trace_events,
                                    validate_obs_dir, write_roundclock_trace)
from repro_torch.obs.health import (HEALTH_EVENTS, HealthConfig,
                                    HealthMonitor, analyze_trace)
from repro_torch.obs.journal import EventJournal, diff_events, snapshot
from repro_torch.obs.node_ring import (NodeRing, drain_node_rows,
                                       init_node_ring, node_ring_append)
from repro_torch.obs.ring import (MetricsRing, ObsConfig, drain, drain_rows,
                                  init_ring, ring_append)
from repro_torch.obs.schema import (COLUMN_INDEX, NODE_COLUMN_INDEX,
                                    NODE_COLUMNS, NODE_METRICS, NUM_COLUMNS,
                                    NUM_NODE_COLUMNS, RING_COLUMNS,
                                    ROUND_METRICS, SCHEMA_VERSION,
                                    decode_step, encode_step, metrics_row,
                                    node_row, node_row_to_dict, row_to_dict,
                                    unify_node_metrics, unify_round_metrics)
from repro_torch.obs.trace import (host_span, host_span_factory, span,
                                   span_factory)

__all__ = [
    "COLUMN_INDEX", "EventJournal", "HEALTH_EVENTS", "HealthConfig",
    "HealthMonitor", "MetricsRing", "NODE_COLUMNS", "NODE_COLUMN_INDEX",
    "NODE_METRICS", "NUM_COLUMNS", "NUM_NODE_COLUMNS", "NodeRing",
    "ObsConfig", "ObsWriter", "RING_COLUMNS", "ROUND_METRICS",
    "SCHEMA_VERSION", "analyze_trace", "build_rollup", "decode_step",
    "diff_events", "drain", "drain_node_rows", "drain_rows", "encode_step",
    "host_span", "host_span_factory", "init_node_ring", "init_ring",
    "metrics_row", "node_ring_append", "node_row", "node_row_to_dict",
    "ring_append", "roundclock_trace_events", "row_to_dict", "snapshot",
    "span", "span_factory", "unify_node_metrics", "unify_round_metrics",
    "validate_obs_dir", "write_roundclock_trace",
]
