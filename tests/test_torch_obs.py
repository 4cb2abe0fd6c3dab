"""The port's observability (``repro_torch.obs`` and its hooks in the
trainer, the async executor and the train launcher) against the reference
``repro.obs``.

* Units, on inputs equal for both packages: the schema's column registries;
  the step stamp exact at 2^24 + 1 and 2^31 - 1; ring and node-ring appends,
  wraparound, dropped-row counts and chronological drains; a ring carried
  over mid-run (``from_numpy``); ``ObsConfig`` validation; the journal's
  ``diff_events`` on random snapshot pairs; the health monitor over
  synthetic traces that fire every detector (events, scores and
  recommendations equal); ``build_rollup``; and the round clock's Perfetto
  events for a replayed clock (JSON-equal).
* Trainer parity: the reference runs on a (4, 1, 1) mesh of four fake CPU
  devices, reduced qwen3-4b in float32, nap, one local step per round, the
  fused Pallas round (interpret mode), ``ObsConfig(ring_capacity=4,
  drain_every=2)``, 6 rounds: sync on a static ring; dynamic on the
  complete graph under the budget scheduler with churn, node 2 dropped
  after round 2; async on a ring under the stale scheduler,
  ``max_staleness`` 1, node 0 3x slow. It drains both rings every 2 rounds
  and journals the topology at each drain. The port replays each run from
  the reference's initial parameters, topology, ledger and rings. The
  drained rows are compared column by column: the step stamp, the integer
  columns, ``alive``, ``advance`` and ``wire_rx_bytes`` exactly; the float
  columns at rtol 1e-3, the trainer tests' tolerance (float32 round-off
  carried through the steps). The journal's events equal, their floats at
  the same rtol; the health monitor fed the reference's own drained rows
  gives the reference's verdicts exactly.
* The round's key set: every path (sync static and dynamic, async,
  ``max_staleness`` 0, J = 1 sync and async) returns exactly
  ``ROUND_METRICS``, with the reference's values at J = 1.
* In the port alone: ``obs=None`` and ``ObsConfig(enabled=False)`` give
  bit-identical state and the same profiler op list with no ``consensus/``
  span, and obs on gives bit-identical state; a profiled obs-on round holds
  every span name, with the round's kernel call (its plain version on the
  CPU) under ``consensus/fused_round``; the drained rows equal the values
  the rounds returned, bit for bit.
* The launcher: ``--reduced --device cpu --obs-dir D --health`` (sync and
  ``--async``) leaves a directory that the reference's ``python -m
  repro.obs.export --validate D`` and ``python -m repro.obs.dashboard D
  --check`` accept, each in a subprocess, and whose ``run.json`` has the
  keys of the reference launcher's own.

Every reference runs in a fresh process (``torch_round_cases
.run_reference``); the inputs of both sides come from the generators
below.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import async_exec
from repro_torch import obs
from repro_torch import topology as topo
from repro_torch import tree as tree_lib
from repro_torch.configs import get_reduced_config
from repro_torch.core.graph import build_graph
from repro_torch.core.penalty import PenaltyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.params import from_jax
from repro_torch.obs import node_ring as obs_node_ring
from repro_torch.obs import ring as obs_ring
from repro_torch.optim import ConsensusConfig, ConsensusTrainer
from repro_torch.optim.adamw import AdamWConfig
from torch_round_cases import SRC, run_reference

ROUNDS = 6
DRAIN = 2
CAP = 4
SLOW = 3.0
DROP_AFTER = 2                 # dynamic case: node 2 dropped after round 2
CASES = {
    "sync": dict(topology="ring", dyn={}, async_=False),
    "dynamic": dict(topology="complete", budget_init=0.1, async_=False,
                    dyn=dict(scheduler="budget", churn=True, gate_tol=10.0)),
    "async": dict(topology="ring", async_=True,
                  dyn=dict(scheduler="stale", max_staleness=1)),
}
STEP_STAMPS = (0, 1, 7, 2**24, 2**24 + 1, 2**31 - 1)
BAD_OBS = (dict(ring_capacity=0), dict(drain_every=0),
           dict(ring_capacity=-3))
# the ring drill: ("append", n) or ("drain",), the same on both sides
RING_OPS = (("append", 3), ("drain",), ("append", 6), ("drain",), ("drain",),
            ("append", 9), ("drain",), ("append", 2))
MID_APPEND = 3                 # rows appended after the carry-over
SPANS = ("consensus/pack", "consensus/probe", "consensus/fused_round",
         "consensus/penalty", "wire/encode", "wire/decode")
INT_COLUMNS = ("step", "age_max")
EXACT_NODE_COLUMNS = ("step", "age_max", "alive", "advance",
                      "wire_rx_bytes")


# ------------------------------------------------------- shared inputs ----
def _row(k, j=None):
    """Ring row k (or node slab k of J rows): an exact step stamp 100 + k
    and values that differ per row, column and node."""
    step = np.asarray(100 + k, np.int32).view(np.float32)
    if j is None:
        vals = np.arange(1, obs.NUM_COLUMNS, dtype=np.float32) * 0.5 + k
        return np.concatenate([[step], vals]).astype(np.float32)
    vals = (np.arange(1, obs.NUM_NODE_COLUMNS, dtype=np.float32)[None]
            + 10.0 * np.arange(j, dtype=np.float32)[:, None] + k)
    return np.concatenate([np.full((j, 1), step, np.float32), vals],
                          axis=1).astype(np.float32)


def _ring_drill(append, drain):
    """Run ``RING_OPS`` through ``append(k)`` and ``drain(cursor)``; the
    drains' (rows, cursor, dropped) in order."""
    out, k, cursor = [], 0, 0
    for op in RING_OPS:
        if op[0] == "append":
            for _ in range(op[1]):
                append(k)
                k += 1
        else:
            rows, cursor, dropped = drain(cursor)
            out.append((np.asarray(rows), cursor, dropped))
    return out


def _snapshot_pairs():
    """(prev, cur, step) snapshot pairs of a J=5 fleet that flip every kind
    of journal event: gates and revivals, a node drop, repair edges, stale
    crossings, kicks parked and absorbed, budgets spent and topped up."""
    rng = np.random.default_rng(19)
    j = 5

    def sym(a):
        a = np.triu(a, 1)
        return a | a.T

    def snap():
        kick = np.where(sym(rng.uniform(size=(j, j)) < 0.2),
                        rng.uniform(0.1, 1, (j, j)), 0).astype(np.float32)
        return {"mask": sym(rng.uniform(size=(j, j)) < 0.6),
                "node_alive": rng.uniform(size=j) < 0.85,
                "repair": sym(rng.uniform(size=(j, j)) < 0.15),
                "age": rng.integers(0, 5, (j, j)).astype(np.int32),
                "kick": np.maximum(kick, kick.T),
                "eta": rng.uniform(0.05, 2, (j, j)).astype(np.float32),
                "cum_tau": rng.uniform(0, 2, (j, j)).astype(np.float32),
                "budget": rng.uniform(0.5, 2, (j, j)).astype(np.float32),
                "n_incr": rng.integers(0, 3, (j, j)).astype(np.int32)}

    pairs = []
    for t in range(4):
        prev, cur = snap(), snap()
        cur["node_alive"] &= prev["node_alive"]
        pairs.append((prev, cur, 10 * t + 3))
    return pairs


def _health_cases():
    """Named synthetic node-row traces: (rows, J, HealthConfig kwargs,
    max_staleness, executor summary or None)."""
    rng = np.random.default_rng(23)

    def rows(j, n, r, eta, age=None, alive=None):
        out = []
        for t in range(n):
            out.append({"step": 4 * t + 1,
                        "r": [float(r(t, i)) for i in range(j)],
                        "eta_row_mean": [float(eta(t, i)) for i in range(j)],
                        "age_max": [int(age(t, i)) if age else 0
                                    for i in range(j)],
                        "alive": [float(alive(t, i)) if alive else 1.0
                                  for i in range(j)]})
        return out

    cases = {}
    # node 1's residual grows after row 6; the others decay
    cases["divergence"] = (rows(
        4, 16, lambda t, i: 0.1 * 3.0 ** max(0, t - 6) if i == 1
        else 0.5 * 0.8 ** t, lambda t, i: 1.0 + 0.05 * t), 4, {}, None, None)
    # node 2's eta frozen with a material residual (stall), node 0's eta
    # flapping (oscillation), the rest drifting monotonically
    cases["eta"] = (rows(
        4, 14, lambda t, i: 0.5,
        lambda t, i: (1.0 if i == 2 else 1.0 + 0.3 * (-1) ** t if i == 0
                      else 1.0 + 0.1 * t)), 4, {}, None, None)
    # node 3 lags: ages at the bound on every row, and a round lag of 5
    cases["straggler"] = (rows(
        4, 10, lambda t, i: 0.3, lambda t, i: 1.0 + 0.1 * t,
        age=lambda t, i: 2 if i == 3 else (t % 2)), 4, {}, 2,
        {"round_lag": [0, 1, 0, 5]})
    # node 0 sits far above the fleet median, recovers, and drifts again
    cases["drift"] = (rows(
        4, 24, lambda t, i: (10.0 if (i == 0 and not 9 <= t < 15) else 1.0),
        lambda t, i: 1.0 + 0.1 * t), 4, {"window": 4}, None, None)
    # node 2 is a ghost with a huge stale residual: no verdict on it
    cases["ghost"] = (rows(
        3, 12, lambda t, i: 1e3 * 2.0 ** t if i == 2 else 0.2,
        lambda t, i: 1.0, alive=lambda t, i: 0.0 if i == 2 and t > 2
        else 1.0), 3, {"window": 4}, None, None)
    # random rows at a small window and looser thresholds
    r = rng.lognormal(size=(20, 5))
    e = np.cumsum(rng.normal(scale=0.05, size=(20, 5)), axis=0) + 1.0
    a = rng.integers(0, 4, (20, 5))
    cases["random"] = (rows(5, 20, lambda t, i: r[t, i],
                            lambda t, i: e[t, i], age=lambda t, i: a[t, i]),
                       5, {"window": 3, "divergence_ratio": 1.5,
                           "drift_ratio": 2.0, "osc_flip_frac": 0.5},
                       3, {"round_lag": [0, 2, 4, 1, 0]})
    return cases


def _rollup_inputs():
    rows = [obs.row_to_dict(_row(k)) for k in range(5)]
    node_rows = [obs.node_row_to_dict(_row(k, 3)) for k in range(5)]
    drain_log = [{"step": 4, "rounds": 2, "wall_s": 0.5},
                 {"step": 8, "rounds": 3, "wall_s": 0.25}]
    meta = {"wire_codec": "int8", "wire_bytes_per_round": 1234,
            "offsets": [1, 2], "arch": "x"}
    return rows, node_rows, drain_log, meta


def _clock_args():
    return dict(factor=SLOW, wire_s=0.25, offsets=(1, 2, 3), ticks=10)


# ----------------------------------------------------------- reference ----
def _jax_tree(out, prefix, nt):
    for k, v in nt._asdict().items():
        if k != "key":
            out[f"{prefix}/{k}"] = np.asarray(v)


def _reference_outputs():
    """The reference's unit outputs (JAX on one CPU device)."""
    import jax
    import jax.numpy as jnp
    from repro import obs as jo
    from repro.async_exec import (AsyncConfig, RoundClock,
                                  straggler_compute)
    from repro.configs import get_reduced_config as jget_reduced
    from repro.core.penalty import PenaltyConfig as JPenaltyConfig
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticTokens as JSyntheticTokens
    from repro.launch.mesh import make_mesh
    from repro.models import build_model as jbuild_model
    from repro.obs import node_ring as jnode_ring
    from repro.obs import ring as jring
    from repro.optim import ConsensusConfig as JConsensusConfig
    from repro.optim import ConsensusTrainer as JConsensusTrainer
    from repro.optim.adamw import AdamWConfig as JAdamWConfig

    out = {"ring_columns": np.asarray(jo.RING_COLUMNS),
           "node_columns": np.asarray(jo.NODE_COLUMNS),
           "schema_version": np.asarray(jo.SCHEMA_VERSION),
           "round_metrics": np.asarray(jo.ROUND_METRICS),
           "node_metrics": np.asarray(jo.NODE_METRICS)}
    out["stamps"] = np.asarray([np.asarray(jo.encode_step(s)).view(np.int32)
                                for s in STEP_STAMPS])
    out["stamps_back"] = np.asarray(
        [jo.decode_step(np.asarray(jo.encode_step(s))) for s in STEP_STAMPS],
        np.int64)
    row = jo.metrics_row(jnp.int32(2**24 + 1), {
        "r_max": jnp.float32(1.5), "eta_mean": jnp.float32(0.25),
        "age_max": jnp.int32(3)})
    out["metrics_row"] = np.asarray(row)
    out["metrics_row_dict"] = np.asarray(json.dumps(jo.row_to_dict(
        np.asarray(row))))
    slab = jo.node_row(jnp.int32(2**31 - 1), {
        "r": jnp.arange(3, dtype=jnp.float32),
        "age_max": jnp.asarray([0, 2, 1], jnp.int32),
        "alive": jnp.asarray([1.0, 0.0, 1.0])}, 3)
    out["node_row"] = np.asarray(slab)
    out["node_row_dict"] = np.asarray(json.dumps(jo.node_row_to_dict(
        np.asarray(slab))))

    # the ring drills, and the carry-over
    for name, init, append, drain, j in (
            ("ring", lambda: jring.init_ring(4), jring.ring_append,
             jring.drain, None),
            ("node_ring", lambda: jnode_ring.init_node_ring(4, 3),
             jnode_ring.node_ring_append, jnode_ring.drain, 3)):
        box = [init()]

        def app(k, box=box, append=append, j=j):
            box[0] = append(box[0], jnp.asarray(_row(k, j)))

        for n, (rows, cursor, dropped) in enumerate(_ring_drill(
                app, lambda c, box=box, drain=drain: drain(box[0], c))):
            out[f"{name}/drain{n}/rows"] = rows
            out[f"{name}/drain{n}/meta"] = np.asarray([cursor, dropped])
        out[f"{name}/mid/buf"] = np.asarray(box[0].buf)
        out[f"{name}/mid/head"] = np.asarray(box[0].head)
        cursor = int(box[0].head) - 2
        for k in range(100, 100 + MID_APPEND):
            app(k)
        rows, cursor, dropped = drain(box[0], cursor)
        out[f"{name}/after"] = rows
        out[f"{name}/after/meta"] = np.asarray([cursor, dropped])

    refused = []
    for bad in BAD_OBS:
        try:
            jo.ObsConfig(**bad)
            refused.append(False)
        except ValueError:
            refused.append(True)
    out["obs/refused"] = np.asarray(refused)
    d = jo.ObsConfig()
    out["obs/default"] = np.asarray([d.enabled, d.ring_capacity,
                                     d.drain_every, d.with_spans,
                                     d.with_node_ring], np.int64)

    for n, (prev, cur, step) in enumerate(_snapshot_pairs()):
        for bound in (None, 2):
            out[f"journal/{n}/{bound}"] = np.asarray(json.dumps(
                jo.diff_events(prev, cur, step=step, max_staleness=bound)))

    for name, (rows, j, kw, bound, summary) in _health_cases().items():
        res = jo.analyze_trace(rows, j, cfg=jo.HealthConfig(**kw),
                               executor_summary=summary,
                               max_staleness=bound)
        out[f"health/{name}"] = np.asarray(json.dumps(res, sort_keys=True))

    rows, node_rows, drain_log, meta = _rollup_inputs()
    out["rollup"] = np.asarray(json.dumps(jo.build_rollup(
        rows, meta=meta, dropped_rows=2, journal_events=7,
        node_rows=node_rows, dropped_node_rows=1, drain_log=drain_log),
        sort_keys=True))

    c = _clock_args()
    clock = RoundClock(compute_s=straggler_compute(4, factor=c["factor"]),
                       wire_s=c["wire_s"], offsets=c["offsets"])
    for _ in range(c["ticks"]):
        clock.tick()
    out["clock_events"] = np.asarray(json.dumps(
        jo.roundclock_trace_events(clock)))
    out["clock_other"] = np.asarray([clock.sync_round_s, clock.tick_s,
                                     clock.time_s])

    # a J = 1 trainer: its rounds return at once, through _finish_round
    cfg = dataclasses.replace(jget_reduced("qwen3-4b"), dtype="float32")
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    data = JSyntheticTokens(JDataConfig(vocab=cfg.vocab, seq_len=32,
                                        batch_per_node=2, num_nodes=1))
    for kind in ("sync", "async"):
        tr = JConsensusTrainer(
            jbuild_model(cfg), mesh, adamw=JAdamWConfig(lr=1e-2),
            consensus=JConsensusConfig(
                penalty=JPenaltyConfig(scheme="nap", eta0=0.1),
                async_exec=(AsyncConfig(max_staleness=1)
                            if kind == "async" else None)))
        state = tr.init_state(jax.random.PRNGKey(0))
        if kind == "sync":
            _, cm = tr.consensus_step(state, data.batch(0))
        else:
            _, cm = tr.consensus_step_async(
                state, data.batch(0), jnp.ones((1, 1), bool))
        out[f"j1/{kind}/keys"] = np.asarray(list(cm))
        out[f"j1/{kind}/values"] = np.asarray([float(v) for v in cm.values()])
    return out


def _save_params(out, params):
    import jax
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["p/" + "/".join(k.key for k in path)] = np.asarray(leaf[0])


def _trainer_reference_outputs():
    """The reference trainer with obs on in each case of ``CASES`` (JAX on
    four fake CPU devices)."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import tempfile

    import jax
    from repro import obs as jo
    from repro.async_exec import (AsyncConfig, AsyncExecutor, RoundClock,
                                  straggler_compute)
    from repro.configs import get_reduced_config as jget_reduced
    from repro.core.penalty import PenaltyConfig as JPenaltyConfig
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticTokens as JSyntheticTokens
    from repro.launch.mesh import make_mesh
    from repro.models import build_model as jbuild_model
    from repro.optim import ConsensusConfig as JConsensusConfig
    from repro.optim import ConsensusTrainer as JConsensusTrainer
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    from repro.topology import TopologyConfig as JTopologyConfig

    cfg = dataclasses.replace(jget_reduced("qwen3-4b"), dtype="float32")
    model = jbuild_model(cfg)
    mesh = make_mesh((4, 1, 1), ("pod", "data", "model"))
    data = JSyntheticTokens(JDataConfig(vocab=cfg.vocab, seq_len=32,
                                        batch_per_node=2, num_nodes=4))
    out = {}
    for name, case in CASES.items():
        tr = JConsensusTrainer(
            model, mesh, adamw=JAdamWConfig(lr=1e-2),
            consensus=JConsensusConfig(
                penalty=JPenaltyConfig(scheme="nap", eta0=0.1,
                                       budget_init=case.get("budget_init",
                                                            1.0)),
                topology=case["topology"], local_steps=1,
                use_fused_kernel=True,
                dyn_topology=JTopologyConfig(**case["dyn"]),
                async_exec=(AsyncConfig(max_staleness=1)
                            if case["async_"] else None),
                obs=jo.ObsConfig(ring_capacity=CAP, drain_every=DRAIN)))
        state = tr.init_state(jax.random.PRNGKey(0))
        if name == "sync":
            _save_params(out, state.params)
        _jax_tree(out, f"{name}/topo0", state.topo)
        _jax_tree(out, f"{name}/ring0", state.ring)
        _jax_tree(out, f"{name}/node_ring0", state.node_ring)
        if state.ledger is not None:
            _jax_tree(out, f"{name}/ledger0", state.ledger)
        ex = None
        if case["async_"]:
            ex = AsyncExecutor(tr, RoundClock(
                compute_s=straggler_compute(4, factor=SLOW), wire_s=0.25,
                offsets=tuple(tr.offsets)))
        train, cons = jax.jit(tr.train_step), jax.jit(tr.consensus_step)
        journal = jo.EventJournal(os.path.join(tempfile.mkdtemp(),
                                               "events.jsonl"),
                                  max_staleness=1 if case["async_"] else None)
        journal.observe(state.topo, state.penalty, step=0)
        cur = ncur = 0
        rows, nrows, events, meta = [], [], [], []
        for step in range(ROUNDS):
            state, _ = train(state, data.batch(step))
            probe = data.batch(10**6 + step)
            state, _ = ex.consensus_round(state, probe) if ex is not None \
                else cons(state, probe)
            if (step + 1) % DRAIN == 0:
                r, cur, dropped = jo.drain(state.ring, cur)
                nr, ncur, ndropped = jo.node_ring.drain(state.node_ring,
                                                        ncur)
                rows.append(r)
                nrows.append(nr)
                meta.append([cur, dropped, ncur, ndropped])
                events += journal.observe(state.topo, state.penalty,
                                          step=step + 1)
            if name == "dynamic" and step == DROP_AFTER:
                state = tr.apply_churn(state, 2)
        out[f"{name}/rows"] = np.concatenate(rows)
        out[f"{name}/node_rows"] = np.concatenate(nrows)
        out[f"{name}/drain_meta"] = np.asarray(meta)
        out[f"{name}/events"] = np.asarray(json.dumps(events))
        node_dicts = [jo.node_row_to_dict(s) for s in out[f"{name}/node_rows"]]
        out[f"{name}/health"] = np.asarray(json.dumps(jo.analyze_trace(
            node_dicts, 4, cfg=jo.HealthConfig(window=2, stall_tol=0.05),
            max_staleness=1 if case["async_"] else None), sort_keys=True))
    return out


def _launcher_reference_outputs():
    """The reference launcher's run.json and file set for an obs run (JAX
    on its debug mesh of eight fake CPU devices)."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import tempfile

    from repro.launch import train as jtrain
    d = os.path.join(tempfile.mkdtemp(), "obs")
    jtrain.main(["--arch", "qwen3-4b", "--reduced", "--steps", "2",
                 "--local-steps", "1", "--no-async-collectives",
                 "--obs-dir", d, "--health"])
    with open(os.path.join(d, "run.json")) as f:
        run = json.load(f)
    with open(os.path.join(d, "rollup.json")) as f:
        rollup = json.load(f)
    return {"run_keys": np.asarray(sorted(run)),
            "rollup_keys": np.asarray(sorted(rollup)),
            "files": np.asarray(sorted(os.listdir(d)))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One CPU thread per test process while this module runs (the
    reference's processes and the other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("test_torch_obs", tmp_path_factory)


@pytest.fixture(scope="module")
def trainer_ref(tmp_path_factory):
    return run_reference("test_torch_obs", tmp_path_factory,
                         fn="_trainer_reference_outputs")


@pytest.fixture(scope="module")
def launcher_ref(tmp_path_factory):
    return run_reference("test_torch_obs", tmp_path_factory,
                         fn="_launcher_reference_outputs")


# -------------------------------------------------------------- units ----
def test_schema_registries_match_reference(ref):
    assert list(obs.RING_COLUMNS) == ref["ring_columns"].tolist()
    assert list(obs.NODE_COLUMNS) == ref["node_columns"].tolist()
    assert list(obs.ROUND_METRICS) == ref["round_metrics"].tolist()
    assert list(obs.NODE_METRICS) == ref["node_metrics"].tolist()
    assert obs.SCHEMA_VERSION == int(ref["schema_version"])
    assert all(obs.COLUMN_INDEX[c] == i
               for i, c in enumerate(ref["ring_columns"].tolist()))
    assert all(obs.NODE_COLUMN_INDEX[c] == i
               for i, c in enumerate(ref["node_columns"].tolist()))


def test_step_stamp_is_exact_past_f32_significand(ref):
    cells = [obs.encode_step(torch.tensor(s, dtype=torch.int32))
             for s in STEP_STAMPS]
    assert all(c.dtype == torch.float32 and c.shape == () for c in cells)
    bits = [int(c.numpy().view(np.int32)) for c in cells]
    assert bits == ref["stamps"].tolist()
    back = [obs.decode_step(c.numpy()) for c in cells]
    assert back == list(STEP_STAMPS) == ref["stamps_back"].tolist()
    # 2^24 + 1 has no float32 value: a value-cast stamp would lose it
    assert int(np.float32(2**24 + 1)) != 2**24 + 1


def test_rows_and_slabs_match_reference(ref):
    row = obs.metrics_row(torch.tensor(2**24 + 1, dtype=torch.int32), {
        "r_max": torch.tensor(1.5), "eta_mean": torch.tensor(0.25),
        "age_max": torch.tensor(3, dtype=torch.int32)})
    np.testing.assert_array_equal(row.numpy().view(np.int32),
                                  ref["metrics_row"].view(np.int32))
    assert json.dumps(obs.row_to_dict(row.numpy())) \
        == str(ref["metrics_row_dict"])
    slab = obs.node_row(torch.tensor(2**31 - 1, dtype=torch.int32), {
        "r": torch.arange(3, dtype=torch.float32),
        "age_max": torch.tensor([0, 2, 1], dtype=torch.int32),
        "alive": torch.tensor([1.0, 0.0, 1.0])}, 3)
    np.testing.assert_array_equal(slab.numpy().view(np.int32),
                                  ref["node_row"].view(np.int32))
    assert json.dumps(obs.node_row_to_dict(slab.numpy())) \
        == str(ref["node_row_dict"])
    with pytest.raises(ValueError, match="unregistered"):
        obs.unify_round_metrics({"bogus": torch.zeros(())})
    with pytest.raises(ValueError, match="unregistered"):
        obs.unify_node_metrics({"bogus": torch.zeros(3)}, 3)


def _port_ring(name):
    if name == "ring":
        return obs_ring.init_ring(4, "cpu"), obs.ring_append, \
            obs_ring.drain, obs_ring.from_numpy, None
    return obs_node_ring.init_node_ring(4, 3, "cpu"), \
        obs.node_ring_append, obs_node_ring.drain, \
        obs_node_ring.from_numpy, 3


@pytest.mark.parametrize("name", ["ring", "node_ring"])
def test_ring_drill_matches_reference(ref, name):
    """Appends, wraparound, dropped rows and chronological drains; the ring
    is written in place and a drain never writes it."""
    ring, append, drain, _, j = _port_ring(name)

    def app(k):
        assert append(ring, torch.from_numpy(_row(k, j))) is ring

    def drn(cursor):
        before = ring.buf.clone(), ring.head.clone()
        got = drain(ring, cursor)
        assert torch.equal(ring.buf, before[0])
        assert torch.equal(ring.head, before[1])
        return got

    drains = _ring_drill(app, drn)
    for n, (rows, cursor, dropped) in enumerate(drains):
        np.testing.assert_array_equal(
            rows.view(np.int32), ref[f"{name}/drain{n}/rows"].view(np.int32))
        assert [cursor, dropped] == ref[f"{name}/drain{n}/meta"].tolist()
    steps = [obs.decode_step(r[0] if j is None else r[0, 0])
             for rows, _, _ in drains for r in rows]
    assert steps == sorted(steps)                   # chronological
    assert sum(d for _, _, d in drains) > 0          # the drill overflows
    np.testing.assert_array_equal(ring.buf.numpy().view(np.int32),
                                  ref[f"{name}/mid/buf"].view(np.int32))
    assert int(ring.head) == int(ref[f"{name}/mid/head"])
    assert ring.head.dtype == torch.int32


@pytest.mark.parametrize("name", ["ring", "node_ring"])
def test_ring_carried_over_mid_run(ref, name):
    """The reference's ring (wrapped, head past the capacity) comes across
    with ``from_numpy`` and goes on as the reference's does."""
    _, append, drain, from_numpy, j = _port_ring(name)
    ring = from_numpy({"buf": ref[f"{name}/mid/buf"],
                       "head": ref[f"{name}/mid/head"]}, "cpu")
    assert ring.buf.dtype == torch.float32 and ring.head.dtype == torch.int32
    cursor = int(ring.head) - 2
    for k in range(100, 100 + MID_APPEND):
        append(ring, torch.from_numpy(_row(k, j)))
    rows, cursor, dropped = drain(ring, cursor)
    np.testing.assert_array_equal(rows.view(np.int32),
                                  ref[f"{name}/after"].view(np.int32))
    assert [cursor, dropped] == ref[f"{name}/after/meta"].tolist()


def test_obs_config_validates_like_reference(ref):
    refused = []
    for bad in BAD_OBS:
        try:
            obs.ObsConfig(**bad)
            refused.append(False)
        except ValueError:
            refused.append(True)
    assert refused == ref["obs/refused"].tolist() == [True] * len(BAD_OBS)
    d = obs.ObsConfig()
    assert [d.enabled, d.ring_capacity, d.drain_every, d.with_spans,
            d.with_node_ring] == ref["obs/default"].tolist()


@pytest.mark.parametrize("bound", [None, 2])
@pytest.mark.parametrize("n", range(4))
def test_journal_diff_matches_reference(ref, n, bound):
    prev, cur, step = _snapshot_pairs()[n]
    got = obs.diff_events(prev, cur, step=step, max_staleness=bound)
    assert json.dumps(got) == str(ref[f"journal/{n}/{bound}"])
    assert got, "the pair flips nothing"


def test_journal_snapshot_reads_tensors(tmp_path):
    """``snapshot`` takes the port's tensors; the journal writes one JSON
    line per transition and ``emit`` appends to the same stream."""
    rt = topo.TopologyRuntime(build_graph("complete", 4),
                              topo.TopologyConfig(scheduler="budget",
                                                  churn=True))
    st0 = rt.init_state("cpu")
    st1 = rt.drop_node(st0, 2)
    snap = obs.snapshot(st1)
    assert snap["mask"].dtype == bool and snap["age"].dtype == np.int32
    np.testing.assert_array_equal(snap["mask"], st1.mask.numpy())
    path = str(tmp_path / "events.jsonl")
    with obs.EventJournal(path) as journal:
        assert journal.observe(st0, step=0) == []
        events = journal.observe(st1, step=4)
        journal.emit({"step": 5, "event": "health_drift", "node": 1})
    assert events[0] == {"step": 4, "event": "node_dropped", "node": 2}
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines == events + [{"step": 5, "event": "health_drift",
                               "node": 1}]
    assert journal.num_events == len(events) + 1


@pytest.mark.parametrize("name", sorted(_health_cases()))
def test_health_monitor_matches_reference(ref, name):
    rows, j, kw, bound, summary = _health_cases()[name]
    got = obs.analyze_trace(rows, j, cfg=obs.HealthConfig(**kw),
                            executor_summary=summary, max_staleness=bound)
    assert json.dumps(got, sort_keys=True) == str(ref[f"health/{name}"])
    fired = {e["event"] for e in got["events"]}
    want = {"divergence": "health_divergence", "eta": "health_eta_stall",
            "straggler": "health_straggler", "drift": "health_drift"}
    if name in want:
        assert want[name] in fired
    if name == "eta":
        assert "health_eta_oscillation" in fired
    if name == "ghost":
        assert all(e["node"] != 2 for e in got["events"] if e["step"] > 9)


def test_build_rollup_matches_reference(ref):
    rows, node_rows, drain_log, meta = _rollup_inputs()
    got = obs.build_rollup(rows, meta=meta, dropped_rows=2, journal_events=7,
                           node_rows=node_rows, dropped_node_rows=1,
                           drain_log=drain_log)
    assert json.dumps(got, sort_keys=True) == str(ref["rollup"])


def test_roundclock_trace_matches_reference(ref, tmp_path):
    c = _clock_args()
    clock = async_exec.RoundClock(
        compute_s=async_exec.straggler_compute(4, factor=c["factor"]),
        wire_s=c["wire_s"], offsets=c["offsets"])
    for _ in range(c["ticks"]):
        clock.tick()
    assert json.dumps(obs.roundclock_trace_events(clock)) \
        == str(ref["clock_events"])
    path = obs.write_roundclock_trace(clock, str(tmp_path / "rc.json"))
    with open(path) as f:
        doc = json.load(f)
    assert [doc["otherData"][k] for k in ("sync_round_s", "tick_s",
                                          "elapsed_s")] \
        == ref["clock_other"].tolist()
    assert doc["traceEvents"] == json.loads(str(ref["clock_events"]))


# ----------------------------------------------------------- trainers ----
def _transplanted(ref):
    tree = {}
    for key, arr in ref.items():
        if key.startswith("p/"):
            node = tree
            *parents, leaf = key[2:].split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = arr
    return from_jax(tree)


def _sub(ref, prefix):
    return {k[len(prefix) + 1:]: v for k, v in ref.items()
            if k.startswith(prefix + "/")}


def _trainer(name, obs_cfg, num_nodes=4, max_staleness=1):
    case = CASES[name]
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    tr = ConsensusTrainer(
        build_model(cfg), num_nodes=num_nodes, device="cpu",
        adamw=AdamWConfig(lr=1e-2),
        consensus=ConsensusConfig(
            penalty=PenaltyConfig(scheme="nap", eta0=0.1,
                                  budget_init=case.get("budget_init", 1.0)),
            topology=case["topology"], local_steps=1,
            dyn_topology=topo.TopologyConfig(**case["dyn"]),
            async_exec=(async_exec.AsyncConfig(max_staleness=max_staleness)
                        if case["async_"] else None),
            obs=obs_cfg))
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      batch_per_node=2,
                                      num_nodes=num_nodes), device="cpu")
    return tr, data


def _executor(tr):
    return async_exec.AsyncExecutor(tr, async_exec.RoundClock(
        compute_s=async_exec.straggler_compute(tr.num_nodes, factor=SLOW),
        wire_s=0.25, offsets=tuple(tr.offsets)))


def _run_port(ref, name):
    tr, data = _trainer(name, obs.ObsConfig(ring_capacity=CAP,
                                            drain_every=DRAIN))
    state = tr.init_state(_transplanted(ref))
    state = state._replace(
        topo=topo.from_numpy(_sub(ref, f"{name}/topo0"), "cpu"),
        ring=obs_ring.from_numpy(_sub(ref, f"{name}/ring0"), "cpu"),
        node_ring=obs_node_ring.from_numpy(_sub(ref, f"{name}/node_ring0"),
                                           "cpu"))
    if state.ledger is not None:
        state = state._replace(ledger=async_exec.from_numpy(
            _sub(ref, f"{name}/ledger0"), "cpu"))
    ex = _executor(tr) if CASES[name]["async_"] else None
    journal = obs.EventJournal(os.devnull,
                               max_staleness=1 if ex is not None else None)
    journal.observe(state.topo, state.penalty, step=0)
    cur = ncur = 0
    rows, nrows, events, meta, returned = [], [], [], [], []
    for step in range(ROUNDS):
        state, _ = tr.train_step(state, data.batch(step))
        probe = data.batch(10**6 + step)
        state, cm = ex.consensus_round(state, probe) if ex is not None \
            else tr.consensus_step(state, probe)
        returned.append(cm)
        if (step + 1) % DRAIN == 0:
            r, cur, dropped = obs.drain(state.ring, cur)
            nr, ncur, ndropped = obs_node_ring.drain(state.node_ring, ncur)
            rows.append(r)
            nrows.append(nr)
            meta.append([cur, dropped, ncur, ndropped])
            events += journal.observe(state.topo, state.penalty,
                                      step=step + 1)
        if name == "dynamic" and step == DROP_AFTER:
            state = tr.apply_churn(state, 2)
    journal.close()
    return dict(rows=np.concatenate(rows), node_rows=np.concatenate(nrows),
                meta=np.asarray(meta), events=events, returned=returned,
                state=state)


def _events_close(got, want, rtol):
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert set(g) == set(w), (g, w)
        for k in g:
            if isinstance(w[k], float):
                np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                           err_msg=str(w))
            else:
                assert g[k] == w[k], (g, w)


@pytest.fixture(scope="module")
def port_runs(trainer_ref):
    return {name: _run_port(trainer_ref, name) for name in CASES}


@pytest.mark.parametrize("name", sorted(CASES))
def test_drained_rows_match_reference(trainer_ref, port_runs, name):
    got = port_runs[name]
    np.testing.assert_array_equal(got["meta"],
                                  trainer_ref[f"{name}/drain_meta"])
    rows, want = got["rows"], trainer_ref[f"{name}/rows"]
    assert rows.shape == want.shape == (ROUNDS, obs.NUM_COLUMNS)
    for c, i in obs.COLUMN_INDEX.items():
        if c in INT_COLUMNS:
            np.testing.assert_array_equal(rows[:, i].view(np.int32)
                                          if c == "step" else rows[:, i],
                                          want[:, i].view(np.int32)
                                          if c == "step" else want[:, i],
                                          err_msg=c)
        else:
            np.testing.assert_allclose(rows[:, i], want[:, i], rtol=1e-3,
                                       err_msg=c)
    assert [obs.decode_step(r[0]) for r in rows] == list(range(1, ROUNDS + 1))


@pytest.mark.parametrize("name", sorted(CASES))
def test_drained_node_rows_match_reference(trainer_ref, port_runs, name):
    got = port_runs[name]["node_rows"]
    want = trainer_ref[f"{name}/node_rows"]
    assert got.shape == want.shape == (ROUNDS, 4, obs.NUM_NODE_COLUMNS)
    for c, i in obs.NODE_COLUMN_INDEX.items():
        g, w = got[..., i], want[..., i]
        if c == "step":
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
        elif c in EXACT_NODE_COLUMNS:
            np.testing.assert_array_equal(g, w, err_msg=c)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-3, err_msg=c)
    col = obs.NODE_COLUMN_INDEX
    if name == "dynamic":       # node 2 is a ghost from round 4 on
        assert (want[3:, 2, col["alive"]] == 0).all()
        assert (want[:3, :, col["alive"]] == 1).all()
    if name == "async":         # node 0 advances on one tick in three
        assert want[:, 0, col["advance"]].tolist() \
            == [float(t % 3 == 2) for t in range(ROUNDS)]
        assert want[..., col["age_max"]].max() >= 2


@pytest.mark.parametrize("name", sorted(CASES))
def test_journal_events_match_reference(trainer_ref, port_runs, name):
    want = json.loads(str(trainer_ref[f"{name}/events"]))
    _events_close(port_runs[name]["events"], want, rtol=1e-3)
    if name == "dynamic":
        assert {"step": 4, "event": "node_dropped", "node": 2} in want


@pytest.mark.parametrize("name", sorted(CASES))
def test_health_on_reference_rows_matches(trainer_ref, name):
    rows = [obs.node_row_to_dict(s) for s in trainer_ref[f"{name}/node_rows"]]
    got = obs.analyze_trace(rows, 4, cfg=obs.HealthConfig(
        window=2, stall_tol=0.05), max_staleness=1 if name == "async"
        else None)
    assert json.dumps(got, sort_keys=True) == str(trainer_ref[f"{name}/health"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_drained_rows_equal_returned_metrics(port_runs, name):
    """The ring holds, bit for bit, what each round returned."""
    got = port_runs[name]
    for row, cm in zip(got["rows"], got["returned"], strict=True):
        assert tuple(cm) == obs.ROUND_METRICS
        for k, v in cm.items():
            assert row[obs.COLUMN_INDEX[k]] == np.float32(float(v)), k
    col = obs.NODE_COLUMN_INDEX
    for slab, row in zip(got["node_rows"], got["rows"], strict=True):
        live = slab[:, col["alive"]] * slab[:, col["advance"]] > 0
        assert slab[live, col["r"]].max() == row[obs.COLUMN_INDEX["r_max"]]


# ------------------------------------------------------------ key set ----
def _key_set_rounds():
    """One round of every path, with obs off: sync static and dynamic,
    async, max_staleness 0, and J = 1 (sync and async)."""
    params1 = None
    out = {}
    for label, name, kw in (("sync", "sync", {}),
                            ("dynamic", "dynamic", {}),
                            ("async", "async", {}),
                            ("async0", "async", {"max_staleness": 0}),
                            ("j1/sync", "sync", {"num_nodes": 1}),
                            ("j1/async", "async", {"num_nodes": 1})):
        tr, data = _trainer(name, None, **kw)
        if params1 is None:
            params1 = tr.model.init(torch.Generator().manual_seed(4), "cpu")
        state = tr.init_state(params1)
        state, _ = tr.train_step(state, data.batch(0))
        if CASES[name]["async_"]:
            _, cm = async_exec.AsyncExecutor(tr).consensus_round(
                state, data.batch(10**6))
        else:
            _, cm = tr.consensus_step(state, data.batch(10**6))
        out[label] = cm
    return out


def test_every_round_path_returns_the_reference_key_set(ref):
    rounds = _key_set_rounds()
    for label, cm in rounds.items():
        assert tuple(cm) == obs.ROUND_METRICS, (label, list(cm))
        assert cm["age_max"].dtype == torch.int32, label
        assert all(v.shape == () for v in cm.values()), label
    for label in ("sync", "dynamic", "async0"):    # no staleness on these
        assert float(rounds[label]["stale_edges"]) == 0.0
        assert int(rounds[label]["age_max"]) == 0
    for kind in ("sync", "async"):
        cm = rounds[f"j1/{kind}"]
        assert list(cm) == ref[f"j1/{kind}/keys"].tolist()
        assert [float(v) for v in cm.values()] \
            == ref[f"j1/{kind}/values"].tolist()


# --------------------------------------------------------- port alone ----
def _two_rounds(name, obs_cfg, profile=False):
    tr, data = _trainer(name, obs_cfg)
    state = tr.init_state(tr.model.init(torch.Generator().manual_seed(5),
                                        "cpu"))
    ex = _executor(tr) if CASES[name]["async_"] else None
    ops_seen = []
    for step in range(2):
        state, _ = tr.train_step(state, data.batch(step))
        probe = data.batch(10**6 + step)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) \
                if profile else _null() as prof:
            state, _ = ex.consensus_round(state, probe) if ex is not None \
                else tr.consensus_step(state, probe)
        if profile:
            ops_seen.append([e.name for e in prof.events()])
    return state, ops_seen


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _same_state(a, b):
    leaves = zip(tree_lib.leaves(a.params), tree_lib.leaves(b.params),
                 strict=True)
    return all(torch.equal(u, v) for u, v in leaves) and all(
        torch.equal(getattr(a, f), getattr(b, f))
        for f in ("lam", "theta_bar_prev", "step")) and all(
        torch.equal(u, v) for u, v in zip(a.penalty, b.penalty)) and all(
        torch.equal(getattr(a.topo, f), getattr(b.topo, f))
        for f in ("mask", "node_alive", "age", "kick", "epoch"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_obs_off_runs_the_same_round(name):
    """``obs=None`` and ``ObsConfig(enabled=False)``: bit-identical state
    and the same op list, with no obs span; obs on: the same state."""
    none, ops_none = _two_rounds(name, None, profile=True)
    off, ops_off = _two_rounds(name, obs.ObsConfig(enabled=False),
                               profile=True)
    on, ops_on = _two_rounds(name, obs.ObsConfig(ring_capacity=CAP),
                             profile=True)
    assert _same_state(none, off) and _same_state(none, on)
    assert off.ring is None and off.node_ring is None
    assert int(on.ring.head) == 2 and int(on.node_ring.head) == 2
    assert ops_none == ops_off and ops_none
    assert not any(n.startswith(("consensus/", "wire/", "round/"))
                   for ops in ops_off for n in ops)
    assert any(n == "consensus/fused_round" for ops in ops_on for n in ops)


@pytest.mark.parametrize("name", sorted(CASES))
def test_profiled_round_holds_every_span(name, monkeypatch):
    """Every span name in a profiled obs-on round, with the round's kernel
    call (its plain version on the CPU) inside ``consensus/fused_round``."""
    plain = ops._ref.consensus_round_ref

    def marked(*args, **kw):
        with torch.profiler.record_function("plain consensus_round"):
            return plain(*args, **kw)

    monkeypatch.setattr(ops._ref, "consensus_round_ref", marked)
    tr, data = _trainer(name, obs.ObsConfig(ring_capacity=CAP))
    state = tr.init_state(tr.model.init(torch.Generator().manual_seed(6),
                                        "cpu"))
    ex = _executor(tr) if CASES[name]["async_"] else None
    state, _ = tr.train_step(state, data.batch(0))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if ex is not None:
            state, _ = ex.consensus_round(state, data.batch(10**6))
        else:
            with obs.host_span("round/sync"):
                state, _ = tr.consensus_step(state, data.batch(10**6))
    events = prof.events()
    names = {e.name for e in events}
    want = set(SPANS) | {"round/async" if ex is not None else "round/sync"}
    want |= {f"consensus/exchange/off{o}" for o in tr.offsets
             if ex is None}
    if ex is not None:          # node 0 is slow: on tick 1 its payload is
        want.add("consensus/exchange/off1")         # the only one missing
    assert want <= names, sorted(want - names)
    kernel = [e for e in events if e.name == "plain consensus_round"]
    assert len(kernel) == 1

    def ancestors(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            yield e.name

    assert "consensus/fused_round" in ancestors(kernel[0])


# ------------------------------------------------------------ launcher ----
def _launch(tmp_path, extra):
    from repro_torch.launch.train import parse_args, run
    d = str(tmp_path / "obs")
    args = parse_args(["--reduced", "--nodes", "3", "--local-steps", "1",
                       "--steps", "6", "--obs-dir", d, "--health",
                       "--obs-ring-cap", "4", "--obs-drain-every", "2",
                       "--device", "cpu"] + extra)
    return d, run(get_reduced_config("qwen3-4b"), args)


def _reference_cli(module, *argv):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-m", module, *argv], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_launcher_obs_dir_passes_reference_checks(tmp_path, launcher_ref,
                                                  mode):
    extra = (["--async", "--max-staleness", "1", "--slow-node", "0:4.0"]
             if mode == "async" else
             ["--topo-scheduler", "budget", "--drop-node", "2:1"])
    d, record = _launch(tmp_path, extra)
    rollup = record["obs"]
    assert rollup["rounds"] == 6 and rollup["dropped_rows"] == 0
    assert "health" in rollup
    proc = _reference_cli("repro.obs.export", "--validate", d)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    report = json.loads(proc.stdout)
    assert report["ok"] and report["files"]["metrics.jsonl"]["rows"] == 6
    assert report["files"]["node_metrics.jsonl"]["rows"] == 6
    assert report["files"]["roundclock_trace.json"]["present"] \
        == (mode == "async")
    proc = _reference_cli("repro.obs.dashboard", d, "--check")
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    with open(os.path.join(d, "run.json")) as f:
        assert sorted(json.load(f)) == launcher_ref["run_keys"].tolist()
    with open(os.path.join(d, "rollup.json")) as f:
        assert set(launcher_ref["rollup_keys"].tolist()) <= set(json.load(f))
    files = set(os.listdir(d))
    assert set(launcher_ref["files"].tolist()) <= files
    # the launcher's per-round record and the drained rows agree
    with open(os.path.join(d, "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    assert [r["r_max"] for r in rows] \
        == [r["r_max"] for r in record["rounds"]]
    if mode == "sync":
        with open(os.path.join(d, "events.jsonl")) as f:
            events = [json.loads(ln) for ln in f]
        assert {"step": 4, "event": "node_dropped", "node": 1} in events


def test_launcher_profile_and_no_node_ring(tmp_path, capsys):
    d, record = _launch(tmp_path, ["--no-node-ring", "--profile-rounds",
                                   "2"])
    with open(record["profile"]) as f:
        trace = json.load(f)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"round/sync", "consensus/fused_round"} <= names
    assert not os.path.exists(os.path.join(d, "node_metrics.jsonl"))
    report = obs.validate_obs_dir(d)
    assert report["ok"], report["errors"]
    out = capsys.readouterr().out
    assert re.search(r"^obs: 6 rounds, \d+ topology events, 0 dropped rows",
                     out, re.M)
    # the monitor feeds off node rows: without the node ring it never runs
    assert "health" not in record["obs"] and "health scores" not in out
