"""The port's sharded flat layout, sharded wires and slab round against the
reference (``repro/optim/flatten.py:ShardedLayout``, ``repro/wire``'s
codecs with a shard view, ``consensus_round(block_leaf_arr=...)``).

* Layout tables: for several trees (odd sizes, empty and scalar leaves,
  mixed f32 and bf16) at S in {1, 2, 4}, the port's
  ``FlatLayout.for_tree(..., shards=S)`` and ``shard(S)`` tables equal the
  reference's: offsets, sizes, padded spans, the block->leaf table and its
  slabs, the tail tables. ``shards=1`` is the unsharded layout, and a
  block count that S does not divide raises.
* Wires: the sharded native, int8, fp8_e4m3 and fp8_e5m2 messages (three
  trees, at S 1, 2 and 4) equal the reference codecs' ``encode`` byte for
  byte, whole and slab by slab
  (``encode_slab``); decodes and widths are equal; ``decode_slab`` gives
  each slab's payload and its kernel scales.
* The slab round: for each slab, the port's plain ``consensus_round`` with
  the slab's block->leaf table against the reference's Pallas kernel in
  interpret mode with ``block_leaf_arr`` (ungated int8, edge-gated int8
  with the zero-kick, per-block fp8), at rtol 1e-5 / atol 1e-5 in float32
  (the reference's own kernel tolerance: the block partials are summed in
  another order); the slabs joined equal the port's call on whole rows
  bit for bit, its block partials included.

The reference runs once per test run in a fresh process
(``_reference_outputs``, through ``torch_round_cases.run_reference``); the
inputs of both sides come from the numpy generators below.
"""
import numpy as np
import pytest
import torch

from repro_torch import wire
from repro_torch.kernels import ops
from repro_torch.optim import flatten
from torch_round_cases import (ARGS, NAMES, fp8_round_case,
                               masked_round_case, masked_torch_args,
                               round_case, run_reference, torch_args)
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

SHARDS = (1, 2, 4)
CODECS = ("native", "int8", "fp8_e4m3", "fp8_e5m2")
J = 2
# name -> (block size, leaves as (shape, dtype)); leaf k is named "lKK"
TREES = {
    "mixed": (16, [((37,), "float32"), ((), "float32"), ((0,), "bfloat16"),
                   ((5, 9), "bfloat16"), ((130,), "float32"),
                   ((1,), "float32")]),
    "empty_last": (32, [((64,), "float32"), ((3, 7), "float32"),
                        ((0,), "float32")]),
    "scalars": (8, [((), "float32"), ((), "bfloat16"), ((17,), "float32")]),
    "spanning": (64, [((1000,), "float32"), ((3,), "float32"),
                      ((0,), "float32"), ((77, 3), "float32"),
                      ((129,), "float32")]),
}
WIRE_DTYPES = {"mixed": "float32", "empty_last": "float32",
               "scalars": "bfloat16", "spanning": "bfloat16"}
# (tree, S) of the wire cases (the reference's codecs run eagerly, one
# compile an op: a few cases keep its process short)
WIRE_CASES = [("mixed", 2), ("scalars", 1), ("spanning", 4)]
# slab round cases: name -> (S, kind); kind picks the generator
ROUNDS = {"int8-S4": (4, "int8"), "masked-S2": (2, "masked"),
          "fp8-S2": (2, "fp8")}
RBS = 64


def _tree_arrays(name):
    """The tree's [J, ...] leaves as float32 numpy (seeded)."""
    rng = np.random.default_rng(sorted(TREES).index(name))
    return {f"l{k:02d}": rng.normal(size=(J,) + shape).astype(np.float32)
            for k, (shape, _) in enumerate(TREES[name][1])}


def _torch_tree(name):
    dts = [dt for _, dt in TREES[name][1]]
    return {k: torch.from_numpy(v).to(getattr(torch, dt))
            for (k, v), dt in zip(sorted(_tree_arrays(name).items()), dts)}


def _buf(name, lay):
    """[J, total] float32 (seeded), zero on every leaf's padding."""
    rng = np.random.default_rng(100 + sorted(TREES).index(name))
    buf = rng.normal(size=(J, lay.total)).astype(np.float32)
    for lf in lay.leaves:
        buf[:, lf.offset + lf.size:lf.offset + lf.padded] = 0.0
    return buf


def _round_case(name):
    """A slab round's inputs on whole rows, the block count padded to a
    multiple of S (the extra blocks folded into the last leaf, as
    ``for_tree(..., shards=S)`` does; zero in theta, lam, bar_prev and the
    wires)."""
    s, kind = ROUNDS[name]
    rng = np.random.default_rng(7 + sorted(ROUNDS).index(name))
    if kind == "int8":
        case = round_case(rng, j=3, deg=2, nleaves=4, bs=RBS)
    elif kind == "masked":
        case = masked_round_case(rng, j=3, deg=2, nleaves=4, bs=RBS)
    else:
        case = fp8_round_case(rng, j=3, deg=2, nleaves=4, bs=RBS,
                              fmt="fp8_e4m3")
    nb = case["block_leaf"].shape[0]
    extra = -nb % s
    if extra:
        for k in ("theta", "lam", "barp", "wires"):
            pad = [(0, 0)] * (case[k].ndim - 1) + [(0, extra * RBS)]
            case[k] = np.pad(case[k], pad)
        case["block_leaf"] = np.concatenate(
            [case["block_leaf"], np.full(extra, case["block_leaf"][-1],
                                         np.int32)])
        if kind == "fp8":
            case["scales"] = np.concatenate(
                [case["scales"], np.full(case["scales"].shape[:2] + (extra,),
                                         0.01, np.float32)], axis=2)
    return case


def _slab(case, s, n_shards):
    """Slab s of a round case: the flat operands' columns, per-block
    scales' blocks, and the slab's block->leaf table."""
    nb = case["block_leaf"].shape[0]
    bps = nb // n_shards
    cols = slice(s * bps * RBS, (s + 1) * bps * RBS)
    out = dict(case)
    for k in ("theta", "lam", "barp", "wires"):
        out[k] = np.ascontiguousarray(case[k][..., cols])
    if _per_block(case):
        out["scales"] = np.ascontiguousarray(
            case["scales"][..., s * bps:(s + 1) * bps])
    out["block_leaf"] = case["block_leaf"][s * bps:(s + 1) * bps]
    return out


def _per_block(case):
    return case.get("wire_kind") == "fp8_e4m3"


def _reference_outputs():
    """The reference's layout tables, sharded wires and slab rounds (runs
    with JAX)."""
    import jax
    import jax.numpy as jnp
    from repro import wire as jwire
    from repro.kernels import ops as jops
    from repro.optim import flatten as jflatten

    out = {}
    for name, (bs, leaves) in TREES.items():
        tree = {k: jnp.asarray(v).astype(jnp.dtype(dt)) for (k, v), (_, dt)
                in zip(sorted(_tree_arrays(name).items()), leaves)}
        for s in SHARDS:
            lay = jflatten.FlatLayout.for_tree(tree, block_size=bs, shards=s)
            key = f"{name}/{s}"
            out[f"{key}/leaves"] = np.asarray(
                [[lf.offset, lf.size, lf.padded] for lf in lay.leaves],
                np.int64)
            out[f"{key}/meta"] = np.asarray([lay.total, lay.num_blocks],
                                            np.int64)
            out[f"{key}/block_leaf"] = np.asarray(lay.block_leaf)
            sl = lay.shard(s)
            out[f"{key}/shard_meta"] = np.asarray(
                [sl.shard_total, sl.blocks_per_shard, sl.tail_leaves],
                np.int64)
            out[f"{key}/specs"] = np.asarray(
                [[sp.index, sp.start, sp.size, sp.leaf_lo, sp.leaf_hi]
                 for sp in sl.shards], np.int64)
            for t in ("block_leaf_shards", "tail_leaf_lo", "tail_gather",
                      "leaf_shard", "leaf_pos"):
                out[f"{key}/{t}"] = np.asarray(getattr(sl, t))
            if (name, s) not in WIRE_CASES:
                continue
            buf = jnp.asarray(_buf(name, lay)).astype(
                jnp.dtype(WIRE_DTYPES[name]))
            for codec_name in CODECS:
                codec = jwire.get_codec(codec_name, lay, sl)
                w = codec.encode(buf)
                p, sc = codec.decode(w)
                ck = f"{key}/{codec_name}"
                out[f"{ck}/wire"] = np.asarray(w).view(np.uint8)
                out[f"{ck}/payload"] = np.asarray(p).view(np.uint8)
                if sc is not None:
                    out[f"{ck}/scales"] = np.asarray(sc)
                out[f"{ck}/sizes"] = np.asarray(
                    [codec.wire_width, codec.shard_wire_width,
                     codec.wire_row_bytes(), codec.wire_bytes(),
                     sl.wire_width(codec_name), sl.wire_row_bytes(codec_name),
                     sl.wire_bytes(codec_name)], np.int64)

    for name, (n_shards, kind) in ROUNDS.items():
        case = _round_case(name)
        for s in range(n_shards):
            sc = _slab(case, s, n_shards)
            args = [jnp.asarray(sc[k]) for k in ARGS]
            if kind == "fp8":
                args[3] = jax.lax.bitcast_convert_type(args[3],
                                                       jnp.float8_e4m3fn)
            kw = {k: jnp.asarray(sc[k])
                  for k in ("bar_w", "inv_deg", "kick_w") if k in sc}
            res = jops.consensus_round(
                *args, block_leaf=None, block_size=RBS,
                block_leaf_arr=jnp.asarray(sc["block_leaf"], jnp.int32),
                scales_per_block=(kind == "fp8"), **kw)
            for k, x in zip(NAMES, res):
                out[f"round/{name}/{s}/{k}"] = np.asarray(x, np.float32)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_flatten_sharded", tmp_path_factory)


def _layout(name, s):
    bs = TREES[name][0]
    return flatten.FlatLayout.for_tree(_torch_tree(name), block_size=bs,
                                       shards=s)


# ------------------------------------------------------------ layouts ----
@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", list(TREES))
def test_sharded_layout_tables_match_reference(reference, name, s):
    lay = _layout(name, s)
    key = f"{name}/{s}"
    np.testing.assert_array_equal(
        [[lf.offset, lf.size, lf.padded] for lf in lay.leaves],
        reference[f"{key}/leaves"])
    np.testing.assert_array_equal([lay.total, lay.num_blocks],
                                  reference[f"{key}/meta"])
    np.testing.assert_array_equal(lay.block_leaf,
                                  reference[f"{key}/block_leaf"])
    sl = lay.shard(s)
    np.testing.assert_array_equal(
        [sl.shard_total, sl.blocks_per_shard, sl.tail_leaves],
        reference[f"{key}/shard_meta"])
    np.testing.assert_array_equal(
        [[sp.index, sp.start, sp.size, sp.leaf_lo, sp.leaf_hi]
         for sp in sl.shards], reference[f"{key}/specs"])
    for t in ("block_leaf_shards", "tail_leaf_lo", "tail_gather",
              "leaf_shard", "leaf_pos"):
        np.testing.assert_array_equal(getattr(sl, t),
                                      reference[f"{key}/{t}"], err_msg=t)
    assert lay.total % (s * lay.block_size) == 0


@pytest.mark.parametrize("name", list(TREES))
def test_one_shard_is_the_unsharded_layout(name):
    tree, bs = _torch_tree(name), TREES[name][0]
    a = flatten.FlatLayout.for_tree(tree, block_size=bs)
    b = flatten.FlatLayout.for_tree(tree, block_size=bs, shards=1)
    assert a.leaves == b.leaves and a.total == b.total
    np.testing.assert_array_equal(a.block_leaf, b.block_leaf)
    for codec in CODECS:
        assert wire.get_codec(codec, a).wire_bytes() \
            == wire.get_codec(codec, b).wire_bytes()


def test_shard_requires_divisible_blocks():
    lay = _layout("mixed", 4)
    assert lay.num_blocks % 3
    with pytest.raises(ValueError, match="not divisible by 3 shards"):
        lay.shard(3)
    with pytest.raises(ValueError, match="n_shards 0 < 1"):
        lay.shard(0)


# -------------------------------------------------------------- wires ----
def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("name,s", WIRE_CASES,
                         ids=[f"{n}-{s}" for n, s in WIRE_CASES])
def test_sharded_wire_bytes_match_reference(reference, name, s, codec_name):
    lay = _layout(name, s)
    sl = lay.shard(s)
    codec = wire.get_codec(codec_name, lay, sl)
    buf = torch.from_numpy(_buf(name, lay)).to(
        getattr(torch, WIRE_DTYPES[name]))
    ck = f"{name}/{s}/{codec_name}"
    w = codec.encode(buf)
    np.testing.assert_array_equal(_bytes(w), reference[f"{ck}/wire"])
    # slab by slab: what each in-pod rank sends
    slabs = [codec.encode_slab(buf, k) for k in range(s)]
    assert all(x.is_contiguous() and x.shape == (J, codec.shard_wire_width)
               for x in slabs)
    assert torch.equal(torch.cat(slabs, dim=1).view(torch.uint8),
                       w.view(torch.uint8))
    payload, scales = codec.decode(w)
    np.testing.assert_array_equal(_bytes(payload),
                                  reference[f"{ck}/payload"])
    if codec_name == "native":
        assert scales is None
    else:
        np.testing.assert_array_equal(scales.numpy(),
                                      reference[f"{ck}/scales"])
    # the reference's ShardedLayout width delegates agree with its codec
    sizes = [codec.wire_width, codec.shard_wire_width,
             codec.wire_row_bytes(), codec.wire_bytes()]
    np.testing.assert_array_equal(sizes + sizes[1:],
                                  reference[f"{ck}/sizes"])
    # each slab's message decodes to its payload and the kernel's scales
    for k, msg in enumerate(slabs):
        p, sc = codec.decode_slab(msg, k)
        assert torch.equal(p.contiguous().view(torch.uint8),
                           payload[:, sl.columns(k)].contiguous()
                           .view(torch.uint8))
        if codec_name == "int8":                # the leaf window, global ids
            win = sl.tail_gather[k]
            assert sc.shape == (J, lay.num_leaves)
            assert torch.equal(sc[:, win], scales[:, win])
            rest = np.setdiff1d(np.arange(lay.num_leaves), win)
            assert bool((sc[:, rest] == 1.0).all())
        elif codec_name.startswith("fp8"):     # the slab's own blocks
            bps = sl.blocks_per_shard
            assert torch.equal(sc, scales[:, k * bps:(k + 1) * bps])
        else:
            assert sc is None


# --------------------------------------------------------- slab round ----
def _port_round(case, partials=True):
    if "bar_w" in case:
        args, kw = masked_torch_args(case)
    else:
        args, kw = torch_args(case), {}
    return ops.consensus_round(
        *args, block_leaf=case["block_leaf"], block_size=RBS,
        scales_per_block=_per_block(case), partials=partials,
        **kw)


@pytest.mark.parametrize("name", list(ROUNDS))
def test_slab_round_matches_reference(reference, name):
    n_shards, _ = ROUNDS[name]
    case = _round_case(name)
    whole = _port_round(case)
    slabs = []
    for s in range(n_shards):
        out = _port_round(_slab(case, s, n_shards))
        assert out[3].shape == (3, case["block_leaf"].shape[0] // n_shards)
        got = [x.float().numpy() for x in out[:3]] \
            + [out[3].sum(dim=1).numpy(), out[4].sum(dim=1).numpy()]
        for k, a in zip(NAMES, got):
            np.testing.assert_allclose(a, reference[f"round/{name}/{s}/{k}"],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"slab {s} {k}")
        slabs.append(out)
    for n in range(5):                  # joined: the whole call, bitwise
        joined = torch.cat([o[n] for o in slabs], dim=1)
        assert torch.equal(joined.view(torch.int32),
                           whole[n].view(torch.int32)), NAMES[n]
    # and the sums of the joined partials are the whole call's sums
    plain = _port_round(case, partials=False)
    assert torch.equal(whole[3].sum(dim=1), plain[3])
    assert torch.equal(whole[4].sum(dim=1), plain[4])
