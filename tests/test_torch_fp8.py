"""The port's fp8 wire path against the reference.

* ``Fp8Codec`` (both formats, bf16 and f32 buffers, the reduced qwen3-4b
  layout and one with all-padding blocks): the wire bytes equal the
  reference's ``repro.wire.Fp8Codec.encode`` exactly, whatever the encode's
  chunking; decoding gives the reference's payload and scales; the probe's
  per-block ``unpack`` gives the reference's parameters exactly.
* The plain per-block round (``scales_per_block=True``; ungated, gated, and
  gated with the zero-kick; fp8 wires of both formats; f32 and bf16 theta)
  against the reference oracle and its Pallas kernel in interpret mode, in
  both tilings, on the ``_round_case`` shapes. Tolerances as in
  ``test_torch_dynamic_round.py``: theta', lam' and bar to 1e-6 (rtol and
  atol; fp8 codes upcast exactly, and both sides round after every multiply
  and add), r^2 and s^2 to rtol 1e-5 (block partials summed in another
  order), a bf16 theta' within one bf16 ulp.
* Trainer trajectories at reduced size in float32: 6 static steps with
  ``fp8_e4m3`` (J = 2, ring, nap, H = 2) and 5 dynamic rounds with
  ``fp8_e5m2`` (J = 4, complete, round_robin with churn, node 2 dropped
  after round 2), against the reference ``ConsensusTrainer`` with its fused
  Pallas round. Tolerances as in ``test_torch_trainer.py`` and
  ``test_torch_dynamic_trainer.py``: losses rtol 1e-4, round metrics rtol
  1e-3, masks and liveness exactly.

Every reference runs in a fresh process (``torch_round_cases.run_reference``:
``_reference_outputs`` for the codec and the round, the two trainer
functions with 2 and 4 fake CPU devices); the inputs of both sides come
from the numpy generators below.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch import wire
from repro_torch.configs import get_reduced_config
from repro_torch.core.penalty import PenaltyConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.params import from_jax
from repro_torch.optim import ConsensusConfig, ConsensusTrainer, flatten
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.topology import TopologyConfig, from_numpy
from torch_round_cases import (ARGS, NAMES, bf16_round, fp8_round_case,
                               masked_round_case, masked_torch_args,
                               run_reference, torch_args)
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

FORMATS = ("fp8_e4m3", "fp8_e5m2")
DTYPES = ("float32", "bfloat16")
LAYOUTS = ("reduced", "allpad")
BS = 64
VARIANTS = ("ungated", "gated", "kick")
WHICH = ("rows", "blocks", "oracle")
STEPS = 6
ROUNDS = 5
DROP_AFTER = 2
DYN = dict(scheduler="round_robin", churn=True)


# ------------------------------------------------------- shared inputs ----
def _layout(kind):
    """The reduced qwen3-4b layout; ``allpad`` adds two blocks of padding
    to its last leaf, so that two blocks hold no parameter at all."""
    defs = build_model(get_reduced_config("qwen3-4b")).param_defs()
    lay = flatten.FlatLayout.for_tree(
        defs, block_size=flatten.auto_block_size(defs), node_axis=False)
    if kind == "allpad":
        last = lay.leaves[-1]
        lay = flatten.FlatLayout(
            lay.leaves[:-1] + (last._replace(
                padded=last.padded + 2 * lay.block_size),), lay.block_size)
    return lay


def _buf(kind):
    """[2, total] float32 buffer with zero padding; magnitudes spread over
    the blocks (e^-6 .. e^6) so that the per-block scales differ."""
    lay = _layout(kind)
    rng = np.random.default_rng(4 + len(kind))
    buf = rng.normal(size=(2, lay.total)).astype(np.float32)
    mag = np.exp(rng.uniform(-6, 6, size=(2, lay.num_blocks)))
    buf *= np.repeat(mag, lay.block_size, axis=1).astype(np.float32)
    for lf in lay.leaves:
        buf[:, lf.offset + lf.size:lf.offset + lf.padded] = 0.0
    return buf


def _round_case(fmt, theta_dtype, variant):
    rng = np.random.default_rng(41)
    if variant == "ungated":
        case = fp8_round_case(rng, j=4, deg=3, nleaves=4, bs=BS, fmt=fmt)
        case["theta_dtype"] = theta_dtype
        if theta_dtype == "bfloat16":
            case["theta"] = bf16_round(case["theta"])
        return case
    return masked_round_case(rng, j=4, deg=3, nleaves=4, bs=BS, wire=fmt,
                             theta_dtype=theta_dtype,
                             kick=variant == "kick")


def _round_args(case):
    """(positional args, gate keywords) on the CPU."""
    if "bar_w" in case:
        return masked_torch_args(case)
    args = torch_args(case)
    if case["theta_dtype"] == "bfloat16":
        args[0] = args[0].to(torch.bfloat16)
    return args, {}


def _reference_outputs():
    """The reference codec's wires, decodes and unpacks, and its per-block
    rounds (runs with JAX)."""
    import jax
    import jax.numpy as jnp
    from repro import wire as jwire
    from repro.configs import get_reduced_config as jget_reduced
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import build_model as jbuild_model
    from repro.optim import flatten as jflatten

    jap = jbuild_model(jget_reduced("qwen3-4b")).abstract_params()
    base = jflatten.FlatLayout.for_tree(
        jap, block_size=jflatten.auto_block_size(jap), node_axis=False)
    last = base.leaves[-1]
    layouts = {"reduced": base, "allpad": jflatten.FlatLayout(
        base.treedef, base.leaves[:-1] + (last._replace(
            padded=last.padded + 2 * base.block_size),), base.block_size)}
    out = {}
    for kind, lay in layouts.items():
        out[f"layout/{kind}"] = np.asarray([lay.total, lay.num_blocks],
                                           np.int64)
        for fmt in FORMATS:
            codec = jwire.get_codec(fmt, lay)
            out[f"sizes/{kind}/{fmt}"] = np.asarray(
                [codec.wire_width, codec.wire_bytes()], np.int64)
            for dtype in DTYPES:
                key = f"{kind}/{fmt}/{dtype}"
                w = codec.encode(jnp.asarray(_buf(kind), jnp.dtype(dtype)))
                p, s = codec.decode(w)
                out[f"wire/{key}"] = np.asarray(w)
                out[f"payload/{key}"] = np.asarray(p, np.float32)
                out[f"scales/{key}"] = np.asarray(s)
                leaves = jax.tree_util.tree_leaves(codec.unpack(p, s))
                for n, x in enumerate(leaves):
                    out[f"unpack/{key}/{n}"] = np.asarray(x, np.float32)

    fp8 = {"fp8_e4m3": jnp.float8_e4m3fn, "fp8_e5m2": jnp.float8_e5m2}
    for fmt in FORMATS:
        for theta_dtype in DTYPES:
            for variant in VARIANTS:
                case = _round_case(fmt, theta_dtype, variant)
                args = [jnp.asarray(case[k]) for k in ARGS]
                args[3] = jax.lax.bitcast_convert_type(args[3], fp8[fmt])
                if theta_dtype == "bfloat16":
                    args[0] = args[0].astype(jnp.bfloat16)
                kw = {k: jnp.asarray(case[k])
                      for k in ("bar_w", "inv_deg", "kick_w") if k in case}
                for which in WHICH:
                    if which == "oracle":
                        res = jref.consensus_round_ref(
                            *args, block_leaf=case["block_leaf"],
                            block_size=BS, scales_per_block=True, **kw)
                    else:                         # Pallas, interpret mode
                        res = jops.consensus_round(
                            *args,
                            block_leaf=tuple(case["block_leaf"].tolist()),
                            block_size=BS, whole_rows=(which == "rows"),
                            scales_per_block=True, **kw)
                    for name, x in zip(NAMES, res):
                        out[f"round/{fmt}/{theta_dtype}/{variant}/{which}/"
                            f"{name}"] = np.asarray(x, dtype=np.float32)
    return out


def _save_params(out, params):
    import jax
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["p/" + "/".join(k.key for k in path)] = np.asarray(leaf[0])


def _static_reference_outputs():
    """The reference trainer, static ring, fp8_e4m3 wire (runs with JAX on
    two fake CPU devices)."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    from repro.configs import get_reduced_config as jget_reduced
    from repro.core.penalty import PenaltyConfig as JPenaltyConfig
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticTokens as JSyntheticTokens
    from repro.launch.mesh import make_mesh
    from repro.models import build_model as jbuild_model
    from repro.optim import ConsensusConfig as JConsensusConfig
    from repro.optim import ConsensusTrainer as JConsensusTrainer
    from repro.optim.adamw import AdamWConfig as JAdamWConfig

    cfg = dataclasses.replace(jget_reduced("qwen3-4b"), dtype="float32")
    tr = JConsensusTrainer(
        jbuild_model(cfg), make_mesh((2, 1, 1), ("pod", "data", "model")),
        adamw=JAdamWConfig(lr=1e-2),
        consensus=JConsensusConfig(
            penalty=JPenaltyConfig(scheme="nap", eta0=0.1), topology="ring",
            local_steps=2, wire_codec="fp8_e4m3", use_fused_kernel=True))
    data = JSyntheticTokens(JDataConfig(vocab=cfg.vocab, seq_len=32,
                                        batch_per_node=4, num_nodes=2))
    state = tr.init_state(jax.random.PRNGKey(0))
    out = {}
    _save_params(out, state.params)
    train, cons = jax.jit(tr.train_step), jax.jit(tr.consensus_step)
    rec = {k: [] for k in ("losses", "r_max", "s_max", "eta")}
    for step in range(STEPS):
        state, m = train(state, data.batch(step))
        rec["losses"].append(float(m["loss"]))
        if tr.should_sync(step):
            state, cm = cons(state, data.batch(10**6 + step))
            rec["r_max"].append(float(cm["r_max"]))
            rec["s_max"].append(float(cm["s_max"]))
            rec["eta"].append(float(cm["eta_mean"]))
    out.update({k: np.asarray(v) for k, v in rec.items()})
    out["eta_final"] = np.asarray(state.penalty.eta)
    return out


def _dynamic_reference_outputs():
    """The reference trainer, complete graph, round_robin with churn, node
    2 dropped after round 2, fp8_e5m2 wire (runs with JAX on four fake CPU
    devices)."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
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
    tr = JConsensusTrainer(
        jbuild_model(cfg), make_mesh((4, 1, 1), ("pod", "data", "model")),
        adamw=JAdamWConfig(lr=1e-2),
        consensus=JConsensusConfig(
            penalty=JPenaltyConfig(scheme="nap", eta0=0.1),
            topology="complete", local_steps=1, wire_codec="fp8_e5m2",
            use_fused_kernel=True, dyn_topology=JTopologyConfig(**DYN)))
    data = JSyntheticTokens(JDataConfig(vocab=cfg.vocab, seq_len=32,
                                        batch_per_node=2, num_nodes=4))
    state = tr.init_state(jax.random.PRNGKey(0))
    out = {}
    _save_params(out, state.params)
    for k, v in state.topo._asdict().items():
        if k != "key":
            out[f"topo0/{k}"] = np.asarray(v)
    train, cons = jax.jit(tr.train_step), jax.jit(tr.consensus_step)
    rec = {k: [] for k in ("loss", "r_max", "eta", "active", "mask",
                           "alive", "kick")}
    for step in range(ROUNDS):
        state, m = train(state, data.batch(step))
        state, cm = cons(state, data.batch(10**6 + step))
        rec["loss"].append(float(m["loss"]))
        rec["r_max"].append(float(cm["r_max"]))
        rec["eta"].append(float(cm["eta_mean"]))
        rec["active"].append(float(cm["active_edges"]))
        if step == DROP_AFTER:
            state = tr.apply_churn(state, 2)
        rec["mask"].append(np.asarray(state.topo.mask))
        rec["alive"].append(np.asarray(state.topo.node_alive))
        rec["kick"].append(np.asarray(state.topo.kick))
    out.update({k: np.asarray(v) for k, v in rec.items()})
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_fp8", tmp_path_factory)


@pytest.fixture(scope="module")
def static_reference(tmp_path_factory):
    return run_reference("test_torch_fp8", tmp_path_factory,
                         fn="_static_reference_outputs")


@pytest.fixture(scope="module")
def dynamic_reference(tmp_path_factory):
    return run_reference("test_torch_fp8", tmp_path_factory,
                         fn="_dynamic_reference_outputs")


# ------------------------------------------------------------- codec ----
def _encode(kind, fmt, dtype, chunk_blocks=None):
    lay = _layout(kind)
    codec = wire.get_codec(fmt, lay)
    if chunk_blocks is not None:
        codec.chunk_blocks = chunk_blocks
    buf = torch.from_numpy(_buf(kind)).to(getattr(torch, dtype))
    return lay, codec, buf, codec.encode(buf)


CODEC_CASES = pytest.mark.parametrize("kind,fmt,dtype", [
    (k, f, d) for k in LAYOUTS for f in FORMATS for d in DTYPES])


@CODEC_CASES
def test_fp8_wire_is_byte_identical(reference, kind, fmt, dtype):
    lay, codec, _, tw = _encode(kind, fmt, dtype)
    total, num_blocks = reference[f"layout/{kind}"].tolist()
    assert (lay.total, lay.num_blocks) == (total, num_blocks)
    jw = reference[f"wire/{kind}/{fmt}/{dtype}"]
    assert tw.dtype == torch.int8 and tw.shape == jw.shape
    np.testing.assert_array_equal(tw.numpy(), jw)
    # the bytes do not depend on the encode's chunking
    np.testing.assert_array_equal(
        _encode(kind, fmt, dtype, chunk_blocks=3)[3].numpy(), jw)
    wire_width, wire_bytes = reference[f"sizes/{kind}/{fmt}"].tolist()
    assert codec.wire_width == wire_width == total + 4 * num_blocks
    assert codec.wire_bytes() == wire_bytes


@CODEC_CASES
def test_fp8_decode_round_trips(reference, kind, fmt, dtype):
    lay, codec, buf, tw = _encode(kind, fmt, dtype)
    payload, scales = codec.decode(tw)
    assert payload.dtype == codec.qdtype
    assert payload.shape == (2, lay.total)
    assert scales.dtype == torch.float32 and scales.shape == (
        2, lay.num_blocks)
    key = f"{kind}/{fmt}/{dtype}"
    np.testing.assert_array_equal(payload.float().numpy(),
                                  reference[f"payload/{key}"])
    np.testing.assert_array_equal(scales.numpy(), reference[f"scales/{key}"])
    # any leading dims: a [deg, J, W] stack decodes row by row
    p3, s3 = codec.decode(torch.stack([tw, tw.flip(0)]))
    assert torch.equal(p3[1, 0].view(torch.int8), payload[1].view(torch.int8))
    assert torch.equal(s3[1, 0], scales[1])
    # dequantized, each element lies within half an fp8 step of the buffer:
    # 2^-4 (e4m3, 3 significand bits) or 2^-3 (e5m2) of its block's absmax
    bs = lay.block_size
    deq = payload.float().reshape(2, -1, bs) * scales[..., None]
    x = buf.float().reshape(2, -1, bs)
    amax = x.abs().amax(dim=2, keepdim=True)
    step = 2.0 ** -4 if fmt == "fp8_e4m3" else 2.0 ** -3
    assert bool(((deq - x).abs() <= step * amax).all())
    # blocks of padding decode to zeros with a finite, positive scale
    empty = amax[..., 0] == 0
    assert (kind == "allpad") == bool(empty.any())
    assert not deq[empty].any()
    assert bool((scales[empty] == np.float32(1e-12) / codec.fp8_max).all())


@CODEC_CASES
def test_fp8_probe_unpack_matches_reference(reference, kind, fmt, dtype):
    lay, codec, _, tw = _encode(kind, fmt, dtype)
    leaves = tree_lib.leaves(codec.unpack(*codec.decode(tw)))
    key = f"{kind}/{fmt}/{dtype}"
    assert f"unpack/{key}/{len(leaves)}" not in reference
    for n, (a, lf) in enumerate(zip(leaves, lay.leaves, strict=True)):
        assert a.dtype == lf.dtype and tuple(a.shape) == (2,) + lf.shape
        np.testing.assert_array_equal(a.float().numpy(),
                                      reference[f"unpack/{key}/{n}"])


# ------------------------------------------------------------- round ----
def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.abs(x))
    return np.ldexp(1.0, e - 8)             # bf16: 8 significand bits


@pytest.mark.parametrize("which", WHICH)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("theta_dtype", DTYPES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_per_block_round_matches_reference(reference, fmt, theta_dtype,
                                           variant, which):
    case = _round_case(fmt, theta_dtype, variant)
    args, kw = _round_args(case)
    assert args[3].dtype == wire.get_codec(fmt, _layout("reduced")).qdtype
    counts = ("launches", "masked_launches", "per_block_launches")
    before = [getattr(ops.consensus_round, c) for c in counts]
    port = ops.consensus_round(*args, block_leaf=case["block_leaf"],
                               block_size=BS, scales_per_block=True, **kw)
    # the CPU path is the plain version: no kernel launch is counted
    assert [getattr(ops.consensus_round, c) for c in counts] == before
    want = [reference[f"round/{fmt}/{theta_dtype}/{variant}/{which}/{name}"]
            for name in NAMES]
    got = [x.float().numpy() for x in port]
    if theta_dtype == "bfloat16":
        assert port[0].dtype == torch.bfloat16
        assert np.all(np.abs(got[0] - want[0]) <= _bf16_ulp(want[0])), \
            "theta"
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6,
                                   err_msg="theta")
    for a, b, name in zip(got[1:3], want[1:3], NAMES[1:3]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)
    for a, b, name in zip(got[3:], want[3:], NAMES[3:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=name)
    if variant != "ungated":
        # the ghost row has no neighbor mean, the dead offset added nothing
        assert not got[2][-1].any()


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


def _trainer(j, codec, topology, local_steps, batch, dyn=None):
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"),
                              dtype="float32")
    tr = ConsensusTrainer(
        build_model(cfg), num_nodes=j, device="cpu",
        adamw=AdamWConfig(lr=1e-2),
        consensus=ConsensusConfig(
            penalty=PenaltyConfig(scheme="nap", eta0=0.1), topology=topology,
            local_steps=local_steps, wire_codec=codec,
            dyn_topology=dyn or TopologyConfig()))
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      batch_per_node=batch, num_nodes=j),
                           device="cpu")
    return tr, data


def test_fp8_static_trajectory_matches_reference(static_reference):
    ref = static_reference
    tr, data = _trainer(2, "fp8_e4m3", "ring", 2, 4)
    assert tr.dequant_spec.per_block
    state = tr.init_state(_transplanted(ref))
    rec = {k: [] for k in ("losses", "r_max", "s_max", "eta")}
    for step in range(STEPS):
        state, m = tr.train_step(state, data.batch(step))
        rec["losses"].append(float(m["loss"]))
        if tr.should_sync(step):
            state, cm = tr.consensus_step(state, data.batch(10**6 + step))
            rec["r_max"].append(float(cm["r_max"]))
            rec["s_max"].append(float(cm["s_max"]))
            rec["eta"].append(float(cm["eta_mean"]))
    assert len(rec["r_max"]) == STEPS // 2
    np.testing.assert_allclose(rec["losses"], ref["losses"], rtol=1e-4)
    for k in ("r_max", "s_max", "eta"):
        np.testing.assert_allclose(rec[k], ref[k], rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(state.penalty.eta.numpy(), ref["eta_final"],
                               rtol=1e-3)
    # nap moved the penalties off eta0
    assert np.any(np.abs(np.asarray(rec["eta"]) - 0.1) > 1e-6)


def test_fp8_dynamic_trajectory_matches_reference(dynamic_reference):
    ref = dynamic_reference
    tr, data = _trainer(4, "fp8_e5m2", "complete", 1, 2,
                        TopologyConfig(**DYN))
    assert tr.dynamic and tr.dequant_spec.per_block
    topo0 = {k[len("topo0/"):]: v for k, v in ref.items()
             if k.startswith("topo0/")}
    state = tr.init_state(_transplanted(ref))
    state = state._replace(topo=from_numpy(topo0, "cpu"))
    got = {k: [] for k in ("loss", "r_max", "eta", "active", "mask",
                           "alive", "kick")}
    for step in range(ROUNDS):
        state, m = tr.train_step(state, data.batch(step))
        state, cm = tr.consensus_step(state, data.batch(10**6 + step))
        got["loss"].append(float(m["loss"]))
        got["r_max"].append(float(cm["r_max"]))
        got["eta"].append(float(cm["eta_mean"]))
        got["active"].append(float(cm["active_edges"]))
        if step == DROP_AFTER:
            state = tr.apply_churn(state, 2)
        got["mask"].append(state.topo.mask.numpy())
        got["alive"].append(state.topo.node_alive.numpy())
        got["kick"].append(state.topo.kick.numpy())
    got = {k: np.asarray(v) for k, v in got.items()}
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    for k in ("r_max", "eta", "active"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-3, err_msg=k)
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    np.testing.assert_array_equal(got["kick"] != 0, ref["kick"] != 0)
    np.testing.assert_allclose(got["kick"], ref["kick"], rtol=1e-3)
    # round-robin gated edges and parked kicks; node 2 became a ghost
    assert (got["kick"] != 0).any() and min(got["active"]) < 1.0
    assert got["alive"][-1].tolist() == [True, True, False, True]


def test_fp8_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.train import main, parse_args, run
    assert main(["--arch", "qwen3-4b", "--reduced", "--device", "cpu",
                 "--wire-codec", "fp8_e4m3", "--steps", "4",
                 "--local-steps", "2"]) == 0
    assert capsys.readouterr().out.count("consensus r=") == 2
    record = run(get_reduced_config("qwen3-4b"), parse_args(
        ["--reduced", "--device", "cpu", "--wire-codec", "fp8_e5m2",
         "--steps", "2", "--local-steps", "2"]))
    lay = record["layout"]
    assert record["wire_bytes"] == lay.total + 4 * lay.num_blocks
    # on the CPU the plain version runs: nothing is launched
    assert [r["per_block_launches"] for r in record["rounds"]] == [0]
