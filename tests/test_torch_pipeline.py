"""The round pipeline (``ConsensusConfig.pipeline_offsets``) in one
process: every depth equals depth 1 bit for bit.

The port of the reference's covering matrix (``tests/test_pipeline.py``):
reduced qwen3-4b in float32, J 4 on a ring (offsets [1, 3]), one shared
local step, then 2 rounds; every penalty scheme, the native, int8 and
fp8_e4m3 wires, replicated and sharded state (``trivial_grid(4,
shards=2)``: one process computing the 2-way sharded run whole), the
static, budget, budget-with-kick and stale schedulers, sync and async
rounds (the async ones with the reference's arrival gaps: nodes 1 and 3
miss offset 0 in round 2, so held ledger rows meet pipelined merges).
Each pinned depth holds the parameters, ``lam``, ``theta_bar_prev``, eta
and the round metrics, and on the async cases ``ledger.wires`` and
``w_prev``, bit for bit against depth 1. One test per case and depth.

The per-row decode of the pipelined consume loop (one offset's received
rows decoded as they land) gives the bytes of the stacked decode that
feeds the kernel, for all four wire codecs, replicated and sharded.

The round kernel refuses to run while an exchange of its round is still
in flight (it overwrites a native wire in place).

No reference process: the reference pins the same property of its own
round in ``tests/test_pipeline.py``. Torch runs on one thread.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch import wire as wire_lib
from repro_torch.async_exec import AsyncConfig
from repro_torch.configs import get_reduced_config
from repro_torch.core.penalty import PenaltyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.distributed import trivial_grid
from repro_torch.models import build_model
from repro_torch.optim import ConsensusConfig, ConsensusTrainer, flatten
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.topology import TopologyConfig

J = 4
ROUNDS = 2
STATIC = TopologyConfig()
# gate_tol big enough that edges gate within two rounds: the dead-offset
# skip holds rows that were never issued
BUDGET = TopologyConfig(scheduler="budget", gate_tol=1e2,
                        skip_dead_offsets=True)
BUDGET_KICK = TopologyConfig(scheduler="budget", gate_tol=1e2,
                             skip_dead_offsets=True, churn=True)
STALE = TopologyConfig(scheduler="stale")
ASYNC = AsyncConfig(max_staleness=1)
# scheme, codec, sharded, scheduler, async, the depths held to depth 1
CASES = {
    "fixed_native_repl_static": ("fixed", "native", False, STATIC, None,
                                 (2, 4)),
    "vp_int8_repl_static": ("vp", "int8", False, STATIC, None, (4,)),
    "ap_fp8_repl_static": ("ap", "fp8_e4m3", False, STATIC, None, (4,)),
    "nap_fp8_repl_budget_kick": ("nap", "fp8_e4m3", False, BUDGET_KICK,
                                 None, (4,)),
    "vp_nap_int8_repl_budget": ("vp_nap", "int8", False, BUDGET, None,
                                (2,)),
    "vp_ap_native_repl_stale": ("vp_ap", "native", False, STALE, ASYNC,
                                (4,)),
    "nap_int8_shard_static": ("nap", "int8", True, STATIC, None, (4,)),
    "vp_nap_fp8_shard_stale": ("vp_nap", "fp8_e4m3", True, STALE, ASYNC,
                               (2,)),
}
PAIRS = [(name, depth) for name, case in CASES.items() for depth in case[5]]
CODECS = ("native", "int8", "fp8_e4m3", "fp8_e5m2")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model():
    return build_model(dataclasses.replace(get_reduced_config("qwen3-4b"),
                                           dtype="float32"))


def _trainer(model, depth, scheme, codec, sharded, topo, acfg):
    return ConsensusTrainer(
        model, num_nodes=J, device="cpu", adamw=AdamWConfig(lr=1e-2),
        ranks=trivial_grid(J, "cpu", shards=2 if sharded else 1),
        consensus=ConsensusConfig(
            penalty=PenaltyConfig(scheme=scheme, eta0=0.1),
            topology="ring", local_steps=1, wire_codec=codec,
            shard_consensus=sharded, dyn_topology=topo, async_exec=acfg,
            pipeline_offsets=depth))


_SHARED = {}


def _shared_start():
    """The model, the data and one local step's state, shared by every
    run: the node replicas differ before the rounds."""
    if not _SHARED:
        model = _model()
        data = SyntheticTokens(DataConfig(vocab=model.cfg.vocab, seq_len=32,
                                          batch_per_node=2, num_nodes=J),
                               device="cpu")
        base = _trainer(model, 1, "fixed", "native", False, STATIC, None)
        state = base.init_state(model.init(torch.Generator().manual_seed(0),
                                           "cpu"))
        state, _ = base.train_step(state, data.batch(0))
        assert len(base.offsets) >= 2, base.offsets   # depth > 1 is real
        _SHARED.update(model=model, data=data, state=state)
    return _SHARED


def _arrivals(deg, r):
    """Round 2's arrival gaps: nodes 1 and 3 miss offset 0."""
    a = np.ones((deg, J), dtype=bool)
    if r > 0:
        a[0, 1] = a[0, 3] = False
    return a


_DEPTH1 = {}


def _run(name, depth):
    if (name, depth) in _DEPTH1:
        return _DEPTH1[name, depth]
    shared = _shared_start()
    scheme, codec, sharded, topo, acfg, _ = CASES[name]
    tr = _trainer(shared["model"], depth, scheme, codec, sharded, topo, acfg)
    assert tr.pipeline_depth == depth and tr.pipelined == (depth > 1)
    st0 = shared["state"]
    clone = lambda t: tree_lib.tree_map(lambda x: x.clone(), t)  # noqa: E731
    state = tr.init_state(tree_lib.tree_map(lambda x: x[0], st0.params))
    opt = st0.opt._replace(m=clone(st0.opt.m), v=clone(st0.opt.v))
    state = state._replace(params=clone(st0.params), opt=opt,
                           step=st0.step.clone())
    probe = shared["data"].batch(0, probe=True)
    for r in range(ROUNDS):
        if acfg is not None:
            state, m = tr.consensus_step_async(
                state, probe, _arrivals(len(tr.offsets), r))
        else:
            state, m = tr.consensus_step(state, probe)
    out = {"params": tree_lib.leaves(state.params), "lam": state.lam,
           "bar": state.theta_bar_prev, "eta": state.penalty.eta,
           "metrics": {k: v.clone() for k, v in m.items()}}
    if acfg is not None:
        out["ledger"] = [state.ledger.wires, state.ledger.w_prev,
                         state.ledger.round]
    if depth == 1:
        _DEPTH1[name, depth] = out
    return out


def _bits(t):
    t = t.contiguous().reshape(-1)
    return t.view(torch.uint8) if t.is_floating_point() else t


def _same(a, b, where):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(_bits(a), _bits(b)), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    else:
        assert len(a) == len(b), where
        for n, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{n}]")


def test_matrix_covers_every_axis_value():
    """Vacuity guard on the covering matrix itself."""
    cases = list(CASES.values())
    assert {c[0] for c in cases} == {"fixed", "vp", "ap", "nap", "vp_ap",
                                     "vp_nap"}
    assert {c[1] for c in cases} == {"native", "int8", "fp8_e4m3"}
    assert {c[2] for c in cases} == {False, True}
    for sched in (STATIC, BUDGET, BUDGET_KICK, STALE):
        assert any(c[3] is sched for c in cases)
    assert {c[4] is None for c in cases} == {False, True}
    assert any(c[2] and c[4] is not None for c in cases)
    assert len(PAIRS) >= 9 and all(d > 1 for _, d in PAIRS)


@pytest.mark.parametrize("name,depth", PAIRS,
                         ids=[f"{n}-d{d}" for n, d in PAIRS])
def test_pipelined_bit_identical_to_depth_one(name, depth):
    want = _run(name, 1)
    got = _run(name, depth)
    assert got.keys() == want.keys()
    _same(got, want, name)
    for k, v in got["metrics"].items():
        assert torch.isfinite(v).all(), k
    if CASES[name][4] is not None:
        # the ledger held the gap rows: it was written and it advanced
        assert got["ledger"][0].any() and int(got["ledger"][2]) == ROUNDS


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("shards", [1, 2])
def test_per_row_decode_equals_stacked(codec, shards):
    """Each offset's rows decoded alone give the stacked decode's bytes:
    the payload and the scales (a slab's message too)."""
    defs = _model().param_defs()
    lay = flatten.FlatLayout.for_tree(
        defs, block_size=flatten.auto_block_size(defs), node_axis=False,
        shards=shards)
    slay = lay.shard(shards) if shards > 1 else None
    codec_ = wire_lib.get_codec(codec, lay, slay)
    rng = np.random.default_rng(25)
    deg, rows = 3, 2
    buf = torch.from_numpy(rng.normal(size=(deg * rows, lay.total)).astype(
        np.float32))
    stacked = codec_.encode(buf).reshape(deg, rows, -1)
    cases = [(codec_.decode, stacked)]
    if slay is not None:
        w = codec_.shard_wire_width
        for s in range(shards):
            cases.append((lambda x, s=s: codec_.decode_slab(x, s),
                          stacked[..., s * w:(s + 1) * w].contiguous()))
    for decode, wires in cases:
        payload, scales = decode(wires)
        payload = payload.contiguous()
        for d in range(deg):
            p_d, s_d = decode(wires[d])
            _same(p_d.contiguous(), payload[d], f"{codec} payload {d}")
            if scales is None:
                assert s_d is None
            else:
                _same(s_d.contiguous(), scales.contiguous()[d],
                      f"{codec} scales {d}")


def test_kernel_refuses_an_exchange_in_flight():
    """The round kernel overwrites a native wire in place: it does not run
    while one of its round's exchanges has not been waited on."""
    from repro_torch.distributed import Pending
    from repro_torch.optim.consensus import _Window
    tr = _trainer(_model(), 2, "nap", "native", False, STATIC, None)
    issued = []
    window = _Window([0, 1], 2, lambda d, slot: issued.append(
        (d, slot)) or Pending([], [], None))
    assert issued == [(0, 0), (1, 1)] and window.in_flight == 2
    window.wait(0)
    with pytest.raises(RuntimeError, match="1 exchange"):
        tr._fused_round(window, None, None, None, None, None, None, None,
                        None, {})
    window.wait(1)
    assert window.in_flight == 0
