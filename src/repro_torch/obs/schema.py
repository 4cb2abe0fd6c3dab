"""The unified consensus-metrics schema: one key set for every round path
(port of ``repro/obs/schema.py``).

* ``ROUND_METRICS`` is the ordered tuple of metric names every consensus
  round emits (sync, dynamic, async, and the J <= 1 rounds alike);
* ``RING_COLUMNS`` prepends the ``step`` stamp and is the column order of
  the device-resident ``MetricsRing`` (``obs.ring``); ``COLUMN_INDEX`` maps
  a name to its column and never renumbers (new metrics append);
* ``NODE_METRICS``/``NODE_COLUMNS`` is the same contract per node: one
  ``[J, NUM_NODE_COLUMNS]`` slab per round in the ``NodeRing``
  (``obs.node_ring``).

The registries, ``SCHEMA_VERSION`` and the host-side conversions are the
reference's, so that drained artifacts of either package read alike.

The ``step`` stamp is stored exactly: the int32 step id is bitcast into the
f32 cell (``encode_step``, a view of the device tensor) and bitcast back on
the host (``decode_step``). A float-valued stamp would lose ids above 2^24.

``unify_round_metrics``, ``metrics_row``, ``unify_node_metrics`` and
``node_row`` take the round's device tensors and build the ring rows on
the same device without a host copy; ``row_to_dict`` and
``node_row_to_dict`` take drained host arrays.
"""
from __future__ import annotations

import numpy as np
import torch

# bump when RING_COLUMNS/NODE_COLUMNS change meaning (append-only growth
# does not require it for readers that index by name via COLUMN_INDEX).
# v2: step cells are int32-bitcast (exact above 2^24), NODE_COLUMNS added.
SCHEMA_VERSION = 2

# the unified per-round metric key set, in ring-column order. Zero is the
# defined "not applicable" value for every async-only metric on the sync
# path (no stale edges, zero max age) — the same values the async round
# reports when nothing is actually stale, so the sync/async unification
# is value-exact, not just key-exact.
ROUND_METRICS = (
    "r_max",         # max over alive nodes of the primal residual (eq. 5)
    "s_max",         # max over alive nodes of the dual residual (eq. 5)
    "f_mean",        # mean local objective over alive, connected nodes
    "eta_mean",      # mean per-edge penalty over the static graph edges
    "active_edges",  # |mask| / |adj| — the dynamic-topology gate fraction
    "stale_edges",   # fraction of masked edges gated by staleness (async)
    "age_max",       # max symmetrized staleness age on the mask (async)
)

# ring columns: the step stamp first, then the metrics in registry order
RING_COLUMNS = ("step",) + ROUND_METRICS
COLUMN_INDEX = {name: i for i, name in enumerate(RING_COLUMNS)}
NUM_COLUMNS = len(RING_COLUMNS)

# the per-NODE metric key set, in node-ring column order. Same registry
# rules as ROUND_METRICS: append-only, zero is the defined
# not-applicable value (sync rounds have no staleness age; a static
# topology has every node alive and advancing).
NODE_METRICS = (
    "r",              # this node's primal residual ||theta_i - bar_i||
    "s",              # this node's dual residual (eq. 5)
    "f_local",        # f_i(theta_i) on the probe batch (eq. 7 diagonal)
    "eta_row_mean",   # mean penalty over the node's graph row — "is the
                      # paper's adaptation still moving for THIS node"
    "age_max",        # max symmetrized staleness age over incident edges
    "alive",          # liveness flag (0 = ghost row after churn)
    "advance",        # did this node run a real round this fleet tick
    "wire_rx_bytes",  # fresh wire bytes this node consumed this round
)
NODE_COLUMNS = ("step",) + NODE_METRICS
NODE_COLUMN_INDEX = {name: i for i, name in enumerate(NODE_COLUMNS)}
NUM_NODE_COLUMNS = len(NODE_COLUMNS)

# metrics that are integers in the round dicts (stored as f32 ring cells,
# exported back as ints by the drain path)
_INT_METRICS = frozenset({"age_max"})
_INT_NODE_METRICS = frozenset({"age_max"})


# ------------------------------------------------------ step stamping ----
def encode_step(step) -> torch.Tensor:
    """The int32 step id (a 0-dim tensor or an int) -> its exact f32 ring
    cell: a bitcast view, on the step's device."""
    return torch.as_tensor(step).to(torch.int32).view(torch.float32)


def decode_step(cell) -> int:
    """The exact step id back out of a drained f32 cell (host side)."""
    return int(np.float32(cell).view(np.int32))


def _device_of(metrics: dict, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    for v in metrics.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def unify_round_metrics(metrics: dict, device=None) -> dict:
    """Pad a round's metrics dict to the full ``ROUND_METRICS`` key set.

    Missing keys become zeros (int32 for ``_INT_METRICS``, f32 otherwise)
    on ``device`` (default: the device of the dict's tensors). Key order
    follows the registry, so two unified dicts always zip cleanly. Extra
    keys are rejected: a new metric must be registered in ``ROUND_METRICS``
    (and thereby get a stable ring column) first.
    """
    extra = set(metrics) - set(ROUND_METRICS)
    if extra:
        raise ValueError(
            f"unregistered consensus metrics {sorted(extra)}; add them to "
            f"obs.schema.ROUND_METRICS (append-only) first")
    dev = _device_of(metrics, device)
    out = {}
    for name in ROUND_METRICS:
        if name in metrics:
            out[name] = metrics[name]
        elif name in _INT_METRICS:
            out[name] = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            out[name] = torch.zeros((), dtype=torch.float32, device=dev)
    return out


def metrics_row(step, metrics: dict) -> torch.Tensor:
    """Stack a round's metrics into the ``[NUM_COLUMNS]`` f32 ring row on
    the step's device: the exact step stamp, then the metrics in registry
    order."""
    step = torch.as_tensor(step)
    metrics = unify_round_metrics(metrics, step.device)
    cells = [encode_step(step)]
    cells += [torch.as_tensor(metrics[name], device=step.device)
              .to(torch.float32) for name in ROUND_METRICS]
    return torch.stack(cells)


def row_to_dict(row) -> dict:
    """One drained ring row (host array / list) -> a plain-python dict."""
    out = {}
    for name, i in COLUMN_INDEX.items():
        if name == "step":
            out[name] = decode_step(row[i])
        else:
            v = float(row[i])
            out[name] = int(v) if name in _INT_METRICS else v
    return out


# --------------------------------------------------- per-node metrics ----
def unify_node_metrics(metrics: dict, num_nodes: int, device=None) -> dict:
    """Pad a round's per-node metrics dict to the full ``NODE_METRICS`` key
    set of ``[J]`` tensors.

    Missing keys become the defined not-applicable value: zeros, except the
    flags, where an unreported ``alive``/``advance`` means every node is
    live and ran the round (the sync path). Extra keys are rejected like
    ``unify_round_metrics``.
    """
    extra = set(metrics) - set(NODE_METRICS)
    if extra:
        raise ValueError(
            f"unregistered per-node metrics {sorted(extra)}; add them to "
            f"obs.schema.NODE_METRICS (append-only) first")
    dev = _device_of(metrics, device)
    out = {}
    for name in NODE_METRICS:
        if name in metrics:
            out[name] = torch.broadcast_to(
                torch.as_tensor(metrics[name], device=dev), (num_nodes,))
        elif name in ("alive", "advance"):
            out[name] = torch.ones((num_nodes,), dtype=torch.float32,
                                   device=dev)
        elif name in _INT_NODE_METRICS:
            out[name] = torch.zeros((num_nodes,), dtype=torch.int32,
                                    device=dev)
        else:
            out[name] = torch.zeros((num_nodes,), dtype=torch.float32,
                                    device=dev)
    return out


def node_row(step, metrics: dict, num_nodes: int) -> torch.Tensor:
    """Stack per-node metrics into the ``[J, NUM_NODE_COLUMNS]`` f32 slab
    the node ring stores (one slab per round), on the step's device."""
    step = torch.as_tensor(step)
    metrics = unify_node_metrics(metrics, num_nodes, step.device)
    cells = [encode_step(step).expand(num_nodes)]
    cells += [metrics[name].to(torch.float32) for name in NODE_METRICS]
    return torch.stack(cells, dim=1)


def node_row_to_dict(row) -> dict:
    """One drained ``[J, NUM_NODE_COLUMNS]`` slab -> a plain-python dict:
    ``{"step": int, "<metric>": [J values]}`` (ints for int metrics)."""
    row = np.asarray(row)
    out = {"step": decode_step(row[0, NODE_COLUMN_INDEX["step"]])}
    for name in NODE_METRICS:
        col = row[:, NODE_COLUMN_INDEX[name]]
        if name in _INT_NODE_METRICS:
            out[name] = [int(v) for v in col]
        else:
            out[name] = [float(v) for v in col]
    return out
