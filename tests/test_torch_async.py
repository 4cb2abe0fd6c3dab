"""The port's bounded-staleness async executor against the reference
``repro.async_exec`` and ``ConsensusTrainer.consensus_step_async``.

* Units (exact): ``tick_age`` and ``sym_age``; a ``stale`` scheduler trace
  with a node drop; ``staleness_damping`` (exactly 1.0 at age 0),
  ``effective_eta`` with ``age``, ``freeze_penalty`` (per edge) and
  ``aged_out_nodes`` on random inputs; ``AsyncConfig`` validation; the
  wire ledger's shapes and dtypes for the native, int8 and fp8_e4m3 wires
  on the reduced qwen3-4b layout, unsharded and 2-way sharded
  (``init_wire_ledger(slayout=...)``, ``wire_width``); ``RoundClock`` tick
  sequences
  (``arrivals``, ``advance``, ``time_s``, ``rounds_done``) for a
  homogeneous fleet and a 2x and a 4x straggler, with ``wire_s`` 0 and 0.25.
* Trainer trajectories: the reference runs on a (4, 1, 1) mesh of four
  fake CPU devices, reduced qwen3-4b in float32, nap, one local step per
  round, the fused Pallas round (interpret mode), through its
  ``AsyncExecutor`` with ``max_staleness`` 1 and a clock whose node 0 is 3x
  slow, for 8 ticks: on a ring under the ``stale`` scheduler with the
  native, int8 and fp8_e4m3 wires, and on the complete graph under the
  ``budget`` scheduler with churn (node 3 dropped after round 4), where the
  scheduler's kicks and the staleness kicks meet; and sharded, J 2 x S 2
  on a (2, 2, 1) mesh of the same devices (``shard_consensus``, the
  fp8_e4m3 wire, the ``stale`` scheduler), which the port replays as one
  process computing the sharded run whole (``trivial_grid(2, shards=2)``,
  a ledger row S slab messages). One reference process a case, shared
  by the xdist workers; each saves the initial
  parameters, topology and ledger; the port replays the run from them
  (``from_jax``, ``topology.from_numpy``, ``async_exec.from_numpy``) with
  its own executor and clock. Tolerances as in
  ``test_torch_dynamic_trainer.py``: losses rtol 1e-4; the round metrics,
  eta, the kicks and ``w_prev`` rtol 1e-3 (float32 round-off carried
  through the steps); ages, masks, liveness, arrivals, advance and the
  kicks' support exactly.
* In the port alone: ``max_staleness=0`` through the executor equals
  ``consensus_step`` bit for bit; a frozen node's rows are untouched; the
  launcher's async lines, summary and aged-out drop.

Every reference runs in a fresh process (``torch_round_cases
.run_reference``); the inputs of both sides come from the generators
below.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import async_exec
from repro_torch import tree as tree_lib
from repro_torch import wire as wire_lib
from repro_torch.configs import get_reduced_config
from repro_torch.core import graph, penalty
from repro_torch.core.penalty import PenaltyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.distributed import trivial_grid
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.params import from_jax
from repro_torch.optim import ConsensusConfig, ConsensusTrainer, flatten
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import aged_out_nodes
from repro_torch import topology as topo
from torch_round_cases import run_reference

TICKS = 8
SLOW = 3.0                     # node 0's factor in the trainer runs
DROP_AFTER = 4                 # budget case: node 3 dropped after round 4
CASES = {
    "native": dict(topology="ring", codec="native",
                   dyn=dict(scheduler="stale", max_staleness=1)),
    "int8": dict(topology="ring", codec="int8",
                 dyn=dict(scheduler="stale", max_staleness=1)),
    "fp8_e4m3": dict(topology="ring", codec="fp8_e4m3",
                     dyn=dict(scheduler="stale", max_staleness=1)),
    # the budget of 0.1 spends within the run, so the scheduler gates
    "budget": dict(topology="complete", codec="native", budget_init=0.1,
                   dyn=dict(scheduler="budget", churn=True, gate_tol=10.0,
                            max_staleness=1)),
    # J 2 x S 2: the flat state sharded in-pod, a ledger row S slab
    # messages (the reference on a (2, 2, 1) mesh of the same four devices)
    "sharded": dict(topology="ring", codec="fp8_e4m3", nodes=2, shards=2,
                    dyn=dict(scheduler="stale", max_staleness=1)),
}
CLOCKS = {f"{name}/{wire}": (factor, wire)
          for name, factor in (("even", 1.0), ("slow2", 2.0), ("slow4", 4.0))
          for wire in (0.0, 0.25)}
BAD_ASYNC = (dict(max_staleness=-1), dict(stale_gamma=-0.1))
CLOCK_OFFSETS = (1, 2, 3)           # complete J=4
GAMMAS = (0.0, 0.5, 1.7)
CODECS = ("native", "int8", "fp8_e4m3")
SHARDS = (1, 2)
RECORDED = ("loss", "r_max", "s_max", "eta_mean", "active", "stale",
            "age_max", "eta", "kick", "w_prev", "age", "mask", "alive",
            "arrivals", "advance", "round")


# ------------------------------------------------------- shared inputs ----
def _unit_inputs():
    rng = np.random.default_rng(18)
    j = 6
    age = rng.integers(0, 5, size=(j, j)).astype(np.int32)
    np.fill_diagonal(age, 0)
    fresh = rng.uniform(size=(j, j)) < 0.4

    def pen():
        return dict(eta=rng.uniform(0.05, 0.3, size=(j, j)).astype(np.float32),
                    cum_tau=rng.uniform(0, 2, size=(j, j)).astype(np.float32),
                    budget=rng.uniform(0.5, 2, size=(j, j)).astype(np.float32),
                    n_incr=rng.integers(0, 3, size=(j, j)).astype(np.int32),
                    f_prev=rng.uniform(1, 2, size=j).astype(np.float32),
                    t=np.asarray(3, np.int32))

    adj = rng.uniform(size=(j, j)) < 0.6
    advance = np.array([True, False, False, True, False, True])
    aged = np.zeros((5, 5), np.int32)
    aged[:, 2] = 60                 # every payload from node 2 is ancient,
    aged[2, :] = 60                 # and so is its inbox
    np.fill_diagonal(aged, 0)
    return dict(age=age, fresh=fresh, new=pen(), old=pen(), adj=adj,
                advance=advance, aged=aged,
                ages=np.arange(0, 12, dtype=np.int32).reshape(3, 4))


def _stale_trace_ages(j):
    """Per-epoch [J, J] ages for the stale scheduler trace: mostly fresh,
    some past the bound of 1."""
    rng = np.random.default_rng(7 + j)
    return [rng.choice([0, 1, 2, 3], p=[0.5, 0.2, 0.2, 0.1],
                       size=(j, j)).astype(np.int32) for _ in range(6)]


# ----------------------------------------------------------- reference ----
def _reference_outputs():
    """The reference's unit outputs (runs with JAX on one CPU device)."""
    import jax.numpy as jnp
    from repro import async_exec as ja
    from repro import topology as jt
    from repro.configs import get_reduced_config as jget_reduced
    from repro.core import graph as jg
    from repro.core import penalty as jp
    from repro.models import build_model as jbuild_model
    from repro.optim import flatten as jflatten
    from repro.runtime import aged_out_nodes as jaged_out

    u = _unit_inputs()
    out = {}
    rt = jt.TopologyRuntime(jg.build_graph("complete", 6),
                            jt.TopologyConfig(scheduler="stale"))
    st = rt.init_state()._replace(age=jnp.asarray(u["age"]))
    out["tick_age"] = np.asarray(jt.tick_age(st, jnp.asarray(u["fresh"])).age)
    out["sym_age"] = np.asarray(jt.sym_age(st))
    for graph_kind in ("ring", "complete"):
        rt = jt.TopologyRuntime(
            jg.build_graph(graph_kind, 6),
            jt.TopologyConfig(scheduler="stale", churn=True, max_staleness=1))
        st = rt.init_state()
        for t, age in enumerate(_stale_trace_ages(6)):
            if t == 3:
                st = rt.drop_node(st, 4)
            st = rt.update(st._replace(age=jnp.asarray(age)))
            for f in ("mask", "epoch", "age", "node_alive"):
                out[f"stale/{graph_kind}/{t}/{f}"] = np.asarray(
                    getattr(st, f))

    def pstate(a):
        return jp.PenaltyState(**{k: jnp.asarray(v) for k, v in a.items()})

    cfg = jp.PenaltyConfig(scheme="nap")
    for g in GAMMAS:
        out[f"damping/{g}"] = np.asarray(jp.staleness_damping(
            jnp.asarray(u["ages"]), g))
        out[f"eff/{g}"] = np.asarray(jp.effective_eta(
            cfg, pstate(u["new"]), jnp.asarray(u["adj"]),
            age=jnp.asarray(u["age"]), stale_gamma=g))
    out["eff/none"] = np.asarray(jp.effective_eta(cfg, pstate(u["new"]),
                                                  jnp.asarray(u["adj"])))
    fr = jp.freeze_penalty(jnp.asarray(u["advance"]), pstate(u["new"]),
                           pstate(u["old"]))
    for f in ("eta", "cum_tau", "budget", "n_incr", "f_prev", "t"):
        out[f"freeze/{f}"] = np.asarray(getattr(fr, f))

    rt5 = jt.TopologyRuntime(jg.build_graph("ring", 5), jt.TopologyConfig(
        scheduler="stale", max_staleness=1))
    st5 = rt5.init_state()
    for name, age, bound in (("ancient", u["aged"], 1),
                             ("recent", u["aged"] // 30, 1),
                             ("bound", u["aged"], 20)):
        out[f"aged/{name}"] = np.asarray(jaged_out(
            st5._replace(age=jnp.asarray(age)), max_staleness=bound) + [-1])
    st5 = rt5.drop_node(st5, 1)
    out["aged/ghost"] = np.asarray(jaged_out(
        st5._replace(age=jnp.asarray(u["aged"] + 60)), max_staleness=1)
        + [-1])

    refused = []
    for bad in BAD_ASYNC:
        try:
            ja.AsyncConfig(**bad)
            refused.append(False)
        except ValueError:
            refused.append(True)
    out["async/refused"] = np.asarray(refused)
    out["async/default"] = np.asarray([ja.AsyncConfig().max_staleness,
                                       ja.AsyncConfig().stale_gamma])

    for dtype, shards in ((d, s) for d in ("float32", "bfloat16")
                          for s in SHARDS):
        cfg_m = dataclasses.replace(jget_reduced("qwen3-4b"), dtype=dtype)
        ap = jbuild_model(cfg_m).abstract_params()
        lay = jflatten.FlatLayout.for_tree(
            ap, block_size=jflatten.auto_block_size(ap), node_axis=False,
            shards=shards)
        slay = lay.shard(shards) if shards > 1 else None
        for codec in CODECS:
            led = ja.init_wire_ledger(lay, 3, 4, compression=codec,
                                      slayout=slay)
            k = f"ledger/{dtype}/S{shards}/{codec}"
            out[f"{k}/shape"] = np.asarray(led.wires.shape)
            out[f"{k}/dtype"] = np.asarray(str(led.wires.dtype))
            out[f"{k}/width"] = np.asarray(ja.wire_width(lay, codec, slay))
            out[f"{k}/row_dtype"] = np.asarray(
                str(np.dtype(ja.wire_row_dtype(lay, codec))))
            out[f"{k}/zero"] = np.asarray([
                float(jnp.abs(led.wires.astype(jnp.float32)).max()),
                int(led.round), float(jnp.abs(led.w_prev).max())]
                + list(led.w_prev.shape))

    for name, (factor, wire) in CLOCKS.items():
        clock = ja.RoundClock(
            compute_s=ja.straggler_compute(4, factor=factor),
            wire_s=wire, offsets=CLOCK_OFFSETS)
        rec = {k: [] for k in ("arrivals", "advance", "time", "rounds")}
        for _ in range(10):
            arr, adv = clock.tick()
            rec["arrivals"].append(arr)
            rec["advance"].append(adv)
            rec["time"].append(clock.time_s)
            rec["rounds"].append(clock.rounds_done.copy())
        for k, v in rec.items():
            out[f"clock/{name}/{k}"] = np.asarray(v)
        out[f"clock/{name}/wall"] = np.asarray([clock.tick_s,
                                                clock.sync_round_s])
    return out


def _save_params(out, params):
    import jax
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["p/" + "/".join(k.key for k in path)] = np.asarray(leaf[0])


def _trainer_reference_outputs(name="native"):
    """The reference async trainer in case ``name`` of ``CASES`` (runs
    with JAX on four fake CPU devices). One case a process
    (``_trainer_ref``): a test waits only for its own case's run."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
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
    out = {}
    case = CASES[name]
    j, shards = case.get("nodes", 4), case.get("shards", 1)
    mesh = make_mesh((j, shards, 1), ("pod", "data", "model"))
    data = JSyntheticTokens(JDataConfig(vocab=cfg.vocab, seq_len=32,
                                        batch_per_node=2, num_nodes=j))
    tr = JConsensusTrainer(
        model, mesh, adamw=JAdamWConfig(lr=1e-2),
        consensus=JConsensusConfig(
            penalty=JPenaltyConfig(scheme="nap", eta0=0.1,
                                   budget_init=case.get("budget_init", 1.0)),
            topology=case["topology"], local_steps=1,
            wire_codec=case["codec"], use_fused_kernel=True,
            shard_consensus=shards > 1,
            dyn_topology=JTopologyConfig(**case["dyn"]),
            async_exec=AsyncConfig(max_staleness=1)))
    assert tr.n_shards == shards
    state = tr.init_state(jax.random.PRNGKey(0))
    _save_params(out, state.params)
    for k, v in state.topo._asdict().items():
        if k != "key":
            out[f"{name}/topo0/{k}"] = np.asarray(v)
    for k, v in state.ledger._asdict().items():
        out[f"{name}/ledger0/{k}"] = np.asarray(v)
    ex = AsyncExecutor(tr, RoundClock(
        compute_s=straggler_compute(j, factor=SLOW), wire_s=0.25,
        offsets=tuple(tr.offsets)))
    ticks = []
    tick = ex.clock.tick
    ex.clock.tick = lambda: ticks.append(tick()) or ticks[-1]
    train = jax.jit(tr.train_step)
    rec = {k: [] for k in RECORDED}
    for step in range(TICKS):
        state, m = train(state, data.batch(step))
        state, cm = ex.consensus_round(state, data.batch(10**6 + step))
        if name == "budget" and step == DROP_AFTER:
            state = tr.apply_churn(state, 3)
        for k, key in (("r_max", "r_max"), ("s_max", "s_max"),
                       ("eta_mean", "eta_mean"),
                       ("active", "active_edges"),
                       ("stale", "stale_edges"), ("age_max", "age_max")):
            rec[k].append(float(cm[key]))
        rec["loss"].append(float(m["loss"]))
        rec["eta"].append(np.asarray(state.penalty.eta))
        for k in ("kick", "age", "mask"):
            rec[k].append(np.asarray(getattr(state.topo, k)))
        rec["alive"].append(np.asarray(state.topo.node_alive))
        rec["w_prev"].append(np.asarray(state.ledger.w_prev))
        rec["round"].append(int(state.ledger.round))
        rec["arrivals"].append(ticks[-1][0])
        rec["advance"].append(ticks[-1][1])
    for k, v in rec.items():
        out[f"{name}/{k}"] = np.asarray(v)
    out[f"{name}/rounds_done"] = np.asarray(ex.summary()["rounds_done"])
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One CPU thread per test process while this module runs: the
    reference's JAX process and the other pytest workers share the cores,
    and oversubscribed torch threads slowed these tests some 50x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("test_torch_async", tmp_path_factory)


def _trainer_ref(tmp_path_factory, name):
    """Case ``name``'s reference run, once a test run (the native one is
    also ``test_torch_ranks.py``'s, read with the default argument)."""
    return run_reference("test_torch_async", tmp_path_factory,
                         fn="_trainer_reference_outputs",
                         arg=None if name == "native" else name)


# -------------------------------------------------------------- units ----
def _pstate(a):
    return penalty.PenaltyState(**{k: torch.from_numpy(np.asarray(v))
                                   for k, v in a.items()})


def test_staleness_clocks_match_reference(ref):
    u = _unit_inputs()
    rt = topo.TopologyRuntime(graph.build_graph("complete", 6),
                              topo.TopologyConfig(scheduler="stale"))
    st = rt.init_state("cpu")._replace(age=torch.from_numpy(u["age"]))
    ticked = topo.tick_age(st, torch.from_numpy(u["fresh"]))
    assert ticked.age.dtype == torch.int32
    np.testing.assert_array_equal(ticked.age.numpy(), ref["tick_age"])
    np.testing.assert_array_equal(topo.sym_age(st).numpy(), ref["sym_age"])
    assert torch.equal(topo.sym_age(st), topo.sym_age(st).T)


@pytest.mark.parametrize("graph_kind", ["ring", "complete"])
def test_stale_scheduler_trace_matches_reference(ref, graph_kind):
    rt = topo.TopologyRuntime(graph.build_graph(graph_kind, 6),
                              topo.TopologyConfig(scheduler="stale",
                                                  churn=True,
                                                  max_staleness=1))
    st = rt.init_state("cpu")
    gated = 0
    for t, age in enumerate(_stale_trace_ages(6)):
        if t == 3:
            st = rt.drop_node(st, 4)
        st = rt.update(st._replace(age=torch.from_numpy(age)))
        for f in ("mask", "epoch", "age", "node_alive"):
            np.testing.assert_array_equal(
                getattr(st, f).numpy(), ref[f"stale/{graph_kind}/{t}/{f}"],
                err_msg=f"{graph_kind} {t} {f}")
        gated += int((~st.mask & torch.as_tensor(rt.graph.adj)).sum())
    assert gated > 0


@pytest.mark.parametrize("gamma", GAMMAS)
def test_damping_and_effective_eta_match_reference(ref, gamma):
    u = _unit_inputs()
    d = penalty.staleness_damping(torch.from_numpy(u["ages"]), gamma)
    assert d.dtype == torch.float32
    np.testing.assert_array_equal(d.numpy(), ref[f"damping/{gamma}"])
    assert float(d[0, 0]) == 1.0             # age 0: exactly undamped
    cfg = PenaltyConfig(scheme="nap")
    eff = penalty.effective_eta(cfg, _pstate(u["new"]),
                                torch.from_numpy(u["adj"]),
                                age=torch.from_numpy(u["age"]),
                                stale_gamma=gamma)
    np.testing.assert_array_equal(eff.numpy(), ref[f"eff/{gamma}"])
    np.testing.assert_array_equal(
        penalty.effective_eta(cfg, _pstate(u["new"]),
                              torch.from_numpy(u["adj"])).numpy(),
        ref["eff/none"])


def test_freeze_penalty_matches_reference(ref):
    u = _unit_inputs()
    adv = torch.from_numpy(u["advance"])
    fr = penalty.freeze_penalty(adv, _pstate(u["new"]), _pstate(u["old"]))
    for f in ("eta", "cum_tau", "budget", "n_incr", "f_prev", "t"):
        np.testing.assert_array_equal(getattr(fr, f).numpy(),
                                      ref[f"freeze/{f}"], err_msg=f)
    # per edge: an edge between two frozen nodes keeps its old value only
    frozen = np.nonzero(~u["advance"])[0]
    np.testing.assert_array_equal(
        fr.eta.numpy()[np.ix_(frozen, frozen)],
        u["old"]["eta"][np.ix_(frozen, frozen)])
    np.testing.assert_array_equal(fr.eta.numpy()[0], u["new"]["eta"][0])


def test_aged_out_nodes_matches_reference(ref):
    u = _unit_inputs()
    rt = topo.TopologyRuntime(graph.build_graph("ring", 5),
                              topo.TopologyConfig(scheduler="stale",
                                                  max_staleness=1))
    st = rt.init_state("cpu")
    for name, age, bound in (("ancient", u["aged"], 1),
                             ("recent", u["aged"] // 30, 1),
                             ("bound", u["aged"], 20)):
        got = aged_out_nodes(st._replace(age=torch.from_numpy(age)),
                             max_staleness=bound)
        assert got + [-1] == ref[f"aged/{name}"].tolist(), name
    st = rt.drop_node(st, 1)
    got = aged_out_nodes(st._replace(age=torch.from_numpy(u["aged"] + 60)),
                         max_staleness=1)
    assert got + [-1] == ref["aged/ghost"].tolist()
    assert ref["aged/ancient"].tolist() == [2, -1]


def test_async_config_validates_like_reference(ref):
    refused = []
    for bad in BAD_ASYNC:
        try:
            async_exec.AsyncConfig(**bad)
            refused.append(False)
        except ValueError:
            refused.append(True)
    assert refused == ref["async/refused"].tolist() == [True, True]
    d = async_exec.AsyncConfig()
    assert [d.max_staleness, d.stale_gamma] == ref["async/default"].tolist()


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ledger_shapes_and_dtypes_match_reference(ref, dtype, codec, shards):
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"), dtype=dtype)
    defs = build_model(cfg).param_defs()
    lay = flatten.FlatLayout.for_tree(
        defs, block_size=flatten.auto_block_size(defs), node_axis=False,
        shards=shards)
    slay = lay.shard(shards) if shards > 1 else None
    led = async_exec.init_wire_ledger(lay, 3, 4, compression=codec,
                                      slayout=slay, device="cpu")
    k = f"ledger/{dtype}/S{shards}/{codec}"
    assert list(led.wires.shape) == ref[f"{k}/shape"].tolist()
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.int8: "int8"}
    assert names[led.wires.dtype] == str(ref[f"{k}/dtype"])
    assert names[async_exec.wire_row_dtype(lay, codec)] \
        == str(ref[f"{k}/row_dtype"])
    assert async_exec.wire_width(lay, codec, slay) == int(ref[f"{k}/width"])
    if slay is not None:
        # a slab rank's rows: its slab's message of each of its nodes, and
        # the reference's rows cut to that slab
        codec_ = wire_lib.get_codec(codec, lay, slay)
        w = codec_.shard_wire_width
        assert shards * w == led.wires.shape[-1]
        mine = async_exec.init_wire_ledger(lay, 3, 4, codec=codec_,
                                           device="cpu", rows=1, slab=True)
        assert tuple(mine.wires.shape) == (3, 1, w)
        assert mine.wires.dtype == led.wires.dtype
        wires = np.arange(np.prod(ref[f"{k}/shape"])).reshape(
            ref[f"{k}/shape"]).astype(np.int8)
        cut = async_exec.from_numpy(
            {"wires": wires, "round": np.int32(0),
             "w_prev": np.zeros((4, 4), np.float32)}, "cpu", nodes=(2, 3),
            shard=(1, w))
        np.testing.assert_array_equal(cut.wires.numpy(),
                                      wires[:, 2:3, w:2 * w])
    assert [float(led.wires.float().abs().max()), int(led.round),
            float(led.w_prev.abs().max())] + list(led.w_prev.shape) \
        == ref[f"{k}/zero"].tolist()
    assert led.round.dtype == torch.int32 and led.w_prev.dtype \
        == torch.float32


def test_ledger_from_numpy_keeps_bits():
    """The reference's ledger crosses over bit for bit: a bfloat16 wire
    (numpy's ``ml_dtypes`` type, as JAX hands it over) and an int8 one."""
    import ml_dtypes
    rng = np.random.default_rng(5)
    bf = rng.normal(size=(2, 3, 64)).astype(ml_dtypes.bfloat16)
    i8 = rng.integers(-128, 128, size=(2, 3, 80)).astype(np.int8)
    w_prev = rng.uniform(size=(3, 3)).astype(np.float32)
    for wires, dtype in ((bf, torch.bfloat16), (i8, torch.int8)):
        led = async_exec.from_numpy({"wires": wires, "round": np.int32(7),
                                     "w_prev": w_prev}, "cpu")
        assert led.wires.dtype == dtype and int(led.round) == 7
        assert led.round.dtype == torch.int32
        got = led.wires.view(torch.int16 if dtype == torch.bfloat16
                             else torch.int8).numpy()
        np.testing.assert_array_equal(
            got, wires.view(np.int16 if dtype == torch.bfloat16
                            else np.int8))
        np.testing.assert_array_equal(led.w_prev.numpy(), w_prev)


@pytest.mark.parametrize("name", sorted(CLOCKS))
def test_round_clock_ticks_match_reference(ref, name):
    factor, wire = CLOCKS[name]
    clock = async_exec.RoundClock(
        compute_s=async_exec.straggler_compute(4, factor=factor),
        wire_s=wire, offsets=CLOCK_OFFSETS)
    rec = {k: [] for k in ("arrivals", "advance", "time", "rounds")}
    for _ in range(10):
        arr, adv = clock.tick()
        rec["arrivals"].append(arr)
        rec["advance"].append(adv)
        rec["time"].append(clock.time_s)
        rec["rounds"].append(clock.rounds_done.copy())
    for k, v in rec.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      ref[f"clock/{name}/{k}"], err_msg=k)
    assert [clock.tick_s, clock.sync_round_s] \
        == ref[f"clock/{name}/wall"].tolist()
    if factor > 1:              # the straggler advances one tick in factor
        assert clock.rounds_done[0] == 10 // int(factor)


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


def _trainer(name, max_staleness=1, dtype="float32"):
    """The port's trainer for case ``name``; a sharded case's is one
    process computing the S-way sharded run whole."""
    case = CASES[name]
    j, shards = case.get("nodes", 4), case.get("shards", 1)
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"), dtype=dtype)
    tr = ConsensusTrainer(
        build_model(cfg), num_nodes=j, device="cpu",
        adamw=AdamWConfig(lr=1e-2),
        ranks=trivial_grid(j, "cpu", shards=shards) if shards > 1 else None,
        consensus=ConsensusConfig(
            penalty=PenaltyConfig(scheme="nap", eta0=0.1,
                                  budget_init=case.get("budget_init", 1.0)),
            topology=case["topology"], local_steps=1,
            wire_codec=case["codec"], shard_consensus=shards > 1,
            dyn_topology=topo.TopologyConfig(**case["dyn"]),
            async_exec=async_exec.AsyncConfig(max_staleness=max_staleness)))
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      batch_per_node=2, num_nodes=j),
                           device="cpu")
    return tr, data


def _run_port(ref, name):
    tr, data = _trainer(name)
    j = tr.num_nodes
    state = tr.init_state(_transplanted(ref))
    sub = {k[len(f"{name}/topo0/"):]: v for k, v in ref.items()
           if k.startswith(f"{name}/topo0/")}
    led = {k[len(f"{name}/ledger0/"):]: v for k, v in ref.items()
           if k.startswith(f"{name}/ledger0/")}
    state = state._replace(topo=topo.from_numpy(sub, "cpu"),
                           ledger=async_exec.from_numpy(led, "cpu"))
    assert state.ledger.wires.dtype == tr.codec.wire_dtype
    assert state.ledger.wires.shape[-1] == tr.codec.wire_width
    ex = async_exec.AsyncExecutor(tr, async_exec.RoundClock(
        compute_s=async_exec.straggler_compute(j, factor=SLOW), wire_s=0.25,
        offsets=tuple(tr.offsets)))
    ticks = []
    tick = ex.clock.tick
    ex.clock.tick = lambda: ticks.append(tick()) or ticks[-1]
    rec = {k: [] for k in RECORDED}
    before = ops.consensus_round.masked_launches
    for step in range(TICKS):
        state, m = tr.train_step(state, data.batch(step))
        state, cm = ex.consensus_round(state, data.batch(10**6 + step))
        if name == "budget" and step == DROP_AFTER:
            state = tr.apply_churn(state, 3)
        for k, key in (("r_max", "r_max"), ("s_max", "s_max"),
                       ("eta_mean", "eta_mean"), ("active", "active_edges"),
                       ("stale", "stale_edges"), ("age_max", "age_max")):
            rec[k].append(float(cm[key]))
        rec["loss"].append(float(m["loss"]))
        rec["eta"].append(state.penalty.eta.numpy())
        for k in ("kick", "age", "mask"):
            rec[k].append(getattr(state.topo, k).numpy())
        rec["alive"].append(state.topo.node_alive.numpy())
        rec["w_prev"].append(state.ledger.w_prev.numpy())
        rec["round"].append(int(state.ledger.round))
        rec["arrivals"].append(ticks[-1][0])
        rec["advance"].append(ticks[-1][1])
    # on the CPU the plain version runs: nothing is launched
    assert ops.consensus_round.masked_launches == before
    out = {k: np.asarray(v) for k, v in rec.items()}
    out["rounds_done"] = np.asarray(ex.summary()["rounds_done"])
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_async_trajectory_matches_reference(tmp_path_factory, name):
    trainer_ref = _trainer_ref(tmp_path_factory, name)
    got = _run_port(trainer_ref, name)
    want = {k: trainer_ref[f"{name}/{k}"] for k in got}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    for k in ("r_max", "s_max", "eta_mean", "active", "stale", "eta",
              "w_prev"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    for k in ("age_max", "age", "mask", "alive", "arrivals", "advance",
              "round", "rounds_done"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["kick"] != 0, want["kick"] != 0)
    np.testing.assert_allclose(got["kick"], want["kick"], rtol=1e-3)
    # node 0 (3x slow) advances on one tick in three; edges go stale, are
    # gated, absorbed and revived
    assert got["advance"][:, 0].tolist() == [t % 3 == 2
                                             for t in range(TICKS)]
    assert max(got["stale"]) > 0 and min(got["stale"]) == 0
    assert max(got["age_max"]) >= 2
    if name == "budget":
        # the scheduler gated edges and parked kicks; node 3 is a ghost
        assert (got["kick"] != 0).any() and min(got["active"]) < 1.0
        assert got["alive"][-1].tolist() == [True, True, True, False]


def test_staleness_kick_not_double_absorbed(tmp_path_factory):
    """An edge that ages out is absorbed in that round, from the ledger: the
    scheduler gating it at the end of the round must park no second kick
    for it (budget case, where both kinds of kick occur). The round parks
    kicks at this round's applied weights, which are zero on an edge past
    the bound, so this holds by construction; the test pins it."""
    trainer_ref = _trainer_ref(tmp_path_factory, "budget")
    got = _run_port(trainer_ref, "budget")
    want = trainer_ref["budget/kick"]
    newly_seen = 0
    for t in range(1, TICKS):
        prev = np.maximum(got["age"][t - 1], got["age"][t - 1].T) <= 1
        now = np.maximum(got["age"][t], got["age"][t].T) <= 1
        newly = prev & ~now & got["mask"][t - 1]
        newly_seen += int(newly.sum())
        assert not got["kick"][t][newly].any()
        assert not want[t][newly].any()
    assert newly_seen > 0


# ---------------------------------------------------------- port only ----
def _params_rows(state, rows):
    return [x[rows].clone() for x in tree_lib.leaves(state.params)]


def test_max_staleness_zero_is_the_sync_round():
    """Through the executor, ``max_staleness=0`` is ``consensus_step`` bit
    for bit, and the ledger passes through untouched."""
    params1 = build_model(dataclasses.replace(
        get_reduced_config("qwen3-4b"), dtype="float32")).init(
            torch.Generator().manual_seed(2), "cpu")
    states = []
    for zero in (False, True):
        tr, data = _trainer("int8", max_staleness=0)
        state = tr.init_state(params1)
        ex = async_exec.AsyncExecutor(tr)
        for step in range(2):
            state, _ = tr.train_step(state, data.batch(step))
            if zero:
                state, m = ex.consensus_round(state, data.batch(10**6 + step))
            else:
                state, m = tr.consensus_step(state, data.batch(10**6 + step))
        states.append((state, m))
    (a, ma), (b, mb) = states
    for u, v in zip(tree_lib.leaves(a.params), tree_lib.leaves(b.params),
                    strict=True):
        assert torch.equal(u, v)
    for f in ("lam", "theta_bar_prev"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.penalty.eta, b.penalty.eta)
    assert {k: float(v) for k, v in ma.items()} \
        == {k: float(v) for k, v in mb.items()}
    assert not b.ledger.wires.any() and int(b.ledger.round) == 0
    assert ex.summary()["ticks"] == 2


@pytest.mark.parametrize("codec", ["native", "fp8_e4m3"])
def test_frozen_rows_are_untouched(codec):
    """A node that does not advance keeps its parameter, dual and
    neighbour-mean rows bit for bit, while the others move; its clocks
    still tick."""
    tr, data = _trainer("native" if codec == "native" else "fp8_e4m3")
    state = tr.init_state(tr.model.init(torch.Generator().manual_seed(3),
                                        "cpu"))
    ex = async_exec.AsyncExecutor(tr, async_exec.RoundClock(
        compute_s=async_exec.straggler_compute(4, factor=2.0), wire_s=0.25,
        offsets=tuple(tr.offsets)))
    frozen_rounds = 0
    for step in range(4):
        state, _ = tr.train_step(state, data.batch(step))
        p0 = _params_rows(state, 0)
        lam0 = state.lam[0].clone()
        bar0 = state.theta_bar_prev[0].clone()
        p1 = _params_rows(state, 1)
        state, m = ex.consensus_round(state, data.batch(10**6 + step))
        if step % 2 == 0:                   # node 0 is mid-compute
            frozen_rounds += 1
            assert all(torch.equal(x, y) for x, y in zip(
                p0, _params_rows(state, 0)))
            assert torch.equal(state.lam[0], lam0)
            assert torch.equal(state.theta_bar_prev[0], bar0)
        assert not all(torch.equal(x, y) for x, y in zip(
            p1, _params_rows(state, 1)))
        assert np.isfinite(float(m["r_max"]))
    assert frozen_rounds == 2 and int(state.ledger.round) == 4


def test_async_step_needs_async_config():
    cfg = get_reduced_config("qwen3-4b")
    tr = ConsensusTrainer(build_model(cfg), num_nodes=2, device="cpu",
                          adamw=AdamWConfig(), consensus=ConsensusConfig())
    with pytest.raises(ValueError, match="async_exec"):
        tr.consensus_step_async(None, None, np.ones((1, 2), bool))
    with pytest.raises(ValueError, match="async_exec"):
        async_exec.AsyncExecutor(tr)
    assert tr.init_state(build_model(cfg).init(
        torch.Generator().manual_seed(0), "cpu")).ledger is None


def test_launcher_async_lines_on_cpu(capsys):
    from repro_torch.launch.train import main
    assert main(["--reduced", "--async", "--max-staleness", "1",
                 "--slow-node", "0:4.0", "--nodes", "3", "--local-steps",
                 "1", "--steps", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert len(lines) == 8
    assert all(" stale=" in ln and " age_max=" in ln for ln in lines)
    assert "async executor: {" in out and "'rounds_done': [2, 8, 8]" in out


def test_launcher_async_record_and_aged_out_drop():
    from repro_torch.launch.train import parse_args, run
    args = parse_args(["--reduced", "--async", "--max-staleness", "1",
                       "--slow-node", "0:4.0", "--nodes", "3",
                       "--local-steps", "1", "--steps", "8",
                       "--device", "cpu"])
    record = run(get_reduced_config("qwen3-4b"), args)
    rounds = record["rounds"]
    assert [r["advance"][0] for r in rounds] == [t % 4 == 3
                                                for t in range(8)]
    assert all(r["masked_launches"] == 0 and r["launches"] == 0
               for r in rounds)        # the CPU runs the plain version
    assert record["async"]["rounds_done"] == [2, 8, 8]
    # a 20x slow node ages out and is ghosted through the topology runtime
    args = parse_args(["--reduced", "--async", "--max-staleness", "1",
                       "--slow-node", "0:20.0", "--drop-stragglers",
                       "--nodes", "4", "--topology", "complete",
                       "--local-steps", "1", "--steps", "12",
                       "--device", "cpu"])
    record = run(get_reduced_config("qwen3-4b"), args)
    alive = [r["alive"] for r in record["rounds"]]
    assert alive[0] == [True] * 4 and alive[-1] == [False, True, True, True]


def test_launcher_async_needs_a_card_unless_asked(monkeypatch):
    """``--device`` defaults to ``cuda``: without a card the async launcher
    raises instead of falling back to the CPU."""
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--reduced", "--async", "--max-staleness", "1", "--slow-node",
              "0:4.0", "--nodes", "3", "--local-steps", "1", "--steps", "1"])
