"""The port's FlatLayout and wire codecs against the reference.

Layout tables must be equal (same leaf order, offsets, block->leaf table),
packing exact, and the int8 wire byte-identical to the reference's encode.

The reference runs once per module in a fresh process
(``_reference_outputs``, through ``torch_round_cases.run_reference``); the
inputs of both sides come from the numpy generators below.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch import wire
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import build_model
from repro_torch.optim import flatten
from torch_round_cases import run_reference
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

SIZES = ("reduced", "full4")
DTYPES = ("float32", "bfloat16")


def _config(size, dtype=None):
    if size == "reduced":
        cfg = get_reduced_config("qwen3-4b")
    else:   # the chip slice: full width, 4 layers
        cfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=4)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _layout(cfg):
    defs = build_model(cfg).param_defs()
    return flatten.FlatLayout.for_tree(
        defs, block_size=flatten.auto_block_size(defs), node_axis=False)


def _reduced_layout(dtype="bfloat16"):
    return _layout(_config("reduced", dtype))


def _random_params(rng, lay, j):
    """Per-node [J, ...] params in the reduced layout, as numpy trees."""
    tree = {}
    for lf in lay.leaves:
        node = tree
        for k in lf.path[:-1]:
            node = node.setdefault(k, {})
        node[lf.path[-1]] = rng.normal(
            size=(j,) + lf.shape).astype(np.float32)
    return tree


def _pack_inputs(dtype):
    lay = _reduced_layout(dtype)
    return _random_params(np.random.default_rng(0), lay, 3)


def _int8_buf():
    lay = _reduced_layout()
    buf = np.random.default_rng(3).normal(size=(2, lay.total)).astype(
        np.float32)
    for lf in lay.leaves:                   # realistic zero padding
        buf[:, lf.offset + lf.size:lf.offset + lf.padded] = 0.0
    return buf


def _half_even_buf():
    lay = _reduced_layout()
    buf = np.zeros((1, lay.total), np.float32)
    for lf in lay.leaves:
        k = np.arange(lf.size) % 9 - 4.5            # -4.5 .. 3.5
        vals = k * 0.125
        vals[0] = 127 * 0.125                       # absmax -> scale 1/8
        buf[0, lf.offset:lf.offset + lf.size] = vals[:lf.size]
    return buf


def _reference_outputs():
    """The reference's layout tables, packed buffers and int8 wires (runs
    with JAX)."""
    import jax
    import jax.numpy as jnp
    from repro import wire as jwire
    from repro.configs import get_config as jget_config
    from repro.configs import get_reduced_config as jget_reduced
    from repro.models import build_model as jbuild_model
    from repro.optim import flatten as jflatten

    def jlayout(jcfg):
        jap = jbuild_model(jcfg).abstract_params()
        return jflatten.FlatLayout.for_tree(
            jap, block_size=jflatten.auto_block_size(jap), node_axis=False)

    def jconfig(size, dtype=None):
        if size == "reduced":
            cfg = jget_reduced("qwen3-4b")
        else:
            cfg = dataclasses.replace(jget_config("qwen3-4b"), n_layers=4)
        return cfg if dtype is None else dataclasses.replace(cfg,
                                                             dtype=dtype)

    out = {}
    for size in SIZES:
        lay = jlayout(jconfig(size))
        out[f"layout/{size}/meta"] = np.asarray(
            [lay.block_size, lay.total, lay.num_leaves], np.int64)
        out[f"layout/{size}/block_leaf"] = np.asarray(lay.block_leaf)
        out[f"layout/{size}/dtypes"] = np.asarray(
            [jnp.dtype(lf.dtype).name for lf in lay.leaves])
        for n, lf in enumerate(lay.leaves):
            out[f"layout/{size}/{n}"] = np.asarray(
                [lf.offset, lf.size, lf.padded, *lf.shape], np.int64)

    def jtree(np_tree, dtype):
        return {k: (jtree(v, dtype) if isinstance(v, dict)
                    else jnp.asarray(v, dtype)) for k, v in np_tree.items()}

    for dtype in DTYPES:
        lay = jlayout(jconfig("reduced", dtype))
        tree = jtree(_pack_inputs(dtype), jnp.dtype(dtype))
        out[f"pack/{dtype}"] = np.asarray(lay.pack(tree, dtype=jnp.dtype(
            dtype)), dtype=np.float32)

    lay = jlayout(jconfig("reduced", "bfloat16"))
    codec = jwire.get_codec("int8", lay)
    for dtype in DTYPES:
        w = codec.encode(jnp.asarray(_int8_buf(), jnp.dtype(dtype)))
        p, s = codec.decode(w)
        out[f"int8/{dtype}/wire"] = np.asarray(w)
        out[f"int8/{dtype}/payload"] = np.asarray(p)
        out[f"int8/{dtype}/scales"] = np.asarray(s)
        for n, x in enumerate(jax.tree_util.tree_leaves(codec.unpack(p, s))):
            out[f"int8/{dtype}/unpack/{n}"] = np.asarray(x, np.float32)
    out["int8/sizes"] = np.asarray([codec.wire_width, codec.wire_bytes()],
                                   np.int64)
    out["int8/half_even"] = np.asarray(codec.encode(jnp.asarray(
        _half_even_buf())))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_flatten_codec", tmp_path_factory)


@pytest.mark.parametrize("size", SIZES)
def test_layout_matches_reference(reference, size):
    tlay = _layout(_config(size))
    block_size, total, num_leaves = reference[f"layout/{size}/meta"].tolist()
    assert tlay.block_size == block_size
    assert tlay.total == total
    assert tlay.num_leaves == num_leaves
    for n, (a, name) in enumerate(zip(tlay.leaves,
                                      reference[f"layout/{size}/dtypes"],
                                      strict=True)):
        offset, sz, padded, *shape = reference[f"layout/{size}/{n}"].tolist()
        assert (a.offset, a.size, a.padded, a.shape) == \
            (offset, sz, padded, tuple(shape))
        assert str(a.dtype).split(".")[-1] == str(name)
    np.testing.assert_array_equal(tlay.block_leaf,
                                  reference[f"layout/{size}/block_leaf"])
    assert tlay.wire_dtype == torch.bfloat16
    if size == "full4":
        # the number the kernel's byte bound is computed from
        assert tlay.total == 1_181_941_760 and tlay.block_size == 65536


def _torch_tree(np_tree, dtype):
    return tree_lib.tree_map(lambda a: torch.from_numpy(a).to(dtype),
                             np_tree, is_leaf=lambda x: not isinstance(
                                 x, dict))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_unpack_match_reference(reference, dtype):
    tlay = _reduced_layout(dtype)
    ttree = _torch_tree(_pack_inputs(dtype), getattr(torch, dtype))
    tbuf = tlay.pack(ttree, dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(tbuf.float().numpy(),
                                  reference[f"pack/{dtype}"])
    back = tlay.unpack(tbuf)
    for a, b in zip(tree_lib.leaves(back), tree_lib.leaves(ttree)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # padding is zero
    mask = np.zeros(tlay.total, bool)
    for lf in tlay.leaves:
        mask[lf.offset:lf.offset + lf.size] = True
    assert not tbuf[:, ~torch.from_numpy(mask)].any()


@pytest.mark.parametrize("buf_dtype", DTYPES)
def test_int8_wire_is_byte_identical(reference, buf_dtype):
    tlay = _reduced_layout()
    tbuf = torch.from_numpy(_int8_buf()).to(getattr(torch, buf_dtype))
    tcodec = wire.get_codec("int8", tlay)
    jw = reference[f"int8/{buf_dtype}/wire"]
    tw = tcodec.encode(tbuf)
    assert tw.dtype == torch.int8 and tw.shape == jw.shape
    wire_width, wire_bytes = reference["int8/sizes"].tolist()
    assert tw.shape[1] == tcodec.wire_width == wire_width
    np.testing.assert_array_equal(tw.numpy(), jw)
    assert tcodec.wire_bytes() == wire_bytes
    # decoding gives the same payload and scales
    tp, ts = tcodec.decode(tw)
    np.testing.assert_array_equal(tp.numpy(),
                                  reference[f"int8/{buf_dtype}/payload"])
    np.testing.assert_array_equal(ts.numpy(),
                                  reference[f"int8/{buf_dtype}/scales"])
    # and dequantizes to the same parameters
    leaves = tree_lib.leaves(tcodec.unpack(tp, ts))
    assert f"int8/{buf_dtype}/unpack/{len(leaves)}" not in reference
    for n, a in enumerate(leaves):
        np.testing.assert_array_equal(
            a.float().numpy(), reference[f"int8/{buf_dtype}/unpack/{n}"])


def test_int8_rounds_half_to_even(reference):
    """Exact .5 multiples of the scale round to even in both packages."""
    tlay = _reduced_layout()
    tw = wire.get_codec("int8", tlay).encode(torch.from_numpy(
        _half_even_buf()))
    np.testing.assert_array_equal(tw.numpy(), reference["int8/half_even"])
    lf = tlay.leaves[-1]
    q = tw[0, lf.offset + 1:lf.offset + 9].tolist()
    assert q == [-4, -2, -2, 0, 0, 2, 2, 4]         # -3.5 -> -4, -2.5 -> -2


def test_native_codec_and_names():
    lay = flatten.FlatLayout.for_tree(
        build_model(get_reduced_config("qwen3-4b")).param_defs(),
        block_size=128, node_axis=False)
    codec = wire.get_codec("none", lay)
    buf = torch.randn(2, lay.total).to(torch.bfloat16)
    assert codec.encode(buf) is buf
    assert codec.decode(buf) == (buf, None)
    assert codec.wire_bytes() == 2 * lay.total
    assert wire.resolve_codec_name("") == "native"
    # the fp8 codecs are ported: 1 B per element and 4 B per block
    assert wire.WIRE_CODECS == ("native", "int8", "fp8_e4m3", "fp8_e5m2")
    for name in ("fp8_e4m3", "fp8_e5m2"):
        assert wire.resolve_codec_name(name) == name
        fp8 = wire.get_codec(name, lay)
        assert fp8.wire_bytes() == lay.total + 4 * lay.num_blocks
        assert fp8.kernel_dequant_spec() == wire.DequantSpec(
            per_block=True, scale_width=lay.num_blocks)
    with pytest.raises(ValueError):
        wire.resolve_codec_name("zip")
