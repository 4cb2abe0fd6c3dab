"""The port's FlatLayout and wire codecs against the reference.

Layout tables must be equal (same leaf order, offsets, block->leaf table),
packing exact, and the int8 wire byte-identical to the reference's encode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import wire as jwire
from repro.configs import get_config as jget_config
from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild_model
from repro.optim import flatten as jflatten
from repro_torch import tree as tree_lib
from repro_torch import wire
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import build_model
from repro_torch.models.params import from_jax
from repro_torch.optim import flatten


def _layouts(jcfg, tcfg):
    jap = jbuild_model(jcfg).abstract_params()
    jlay = jflatten.FlatLayout.for_tree(
        jap, block_size=jflatten.auto_block_size(jap), node_axis=False)
    defs = build_model(tcfg).param_defs()
    tlay = flatten.FlatLayout.for_tree(
        defs, block_size=flatten.auto_block_size(defs), node_axis=False)
    return jlay, tlay


@pytest.mark.parametrize("size", ["reduced", "full4"])
def test_layout_matches_reference(size):
    if size == "reduced":
        jcfg, tcfg = jget_reduced("qwen3-4b"), get_reduced_config("qwen3-4b")
    else:   # the chip slice: full width, 4 layers
        jcfg = dataclasses.replace(jget_config("qwen3-4b"), n_layers=4)
        tcfg = dataclasses.replace(get_config("qwen3-4b"), n_layers=4)
    jlay, tlay = _layouts(jcfg, tcfg)
    assert tlay.block_size == jlay.block_size
    assert tlay.total == jlay.total
    assert tlay.num_leaves == jlay.num_leaves
    for a, b in zip(tlay.leaves, jlay.leaves):
        assert (a.offset, a.size, a.padded, a.shape) == \
            (b.offset, b.size, b.padded, b.shape)
        assert str(a.dtype).split(".")[-1] == jnp.dtype(b.dtype).name
    np.testing.assert_array_equal(tlay.block_leaf, jlay.block_leaf)
    assert tlay.wire_dtype == torch.bfloat16
    if size == "full4":
        # the number the kernel's byte bound is computed from
        assert tlay.total == 1_181_941_760 and tlay.block_size == 65536


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


def _reduced_layouts(dtype="bfloat16"):
    return _layouts(
        dataclasses.replace(jget_reduced("qwen3-4b"), dtype=dtype),
        dataclasses.replace(get_reduced_config("qwen3-4b"), dtype=dtype))


@pytest.fixture
def reduced_layouts():
    return _reduced_layouts()


def _jax_tree(np_tree, dtype):
    return {k: (_jax_tree(v, dtype) if isinstance(v, dict)
                else jnp.asarray(v, dtype)) for k, v in np_tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_unpack_match_reference(dtype):
    jlay, tlay = _reduced_layouts(dtype)
    np_tree = _random_params(np.random.default_rng(0), tlay, 3)
    jtree = _jax_tree(np_tree, jnp.dtype(dtype))
    ttree = from_jax(tree_lib.tree_map(np.asarray, jtree))
    jbuf = np.asarray(jlay.pack(jtree, dtype=jnp.dtype(dtype)),
                      dtype=np.float32)
    tbuf = tlay.pack(ttree, dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(tbuf.float().numpy(), jbuf)
    back = tlay.unpack(tbuf)
    for a, b in zip(tree_lib.leaves(back), tree_lib.leaves(ttree)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # padding is zero
    mask = np.zeros(tlay.total, bool)
    for lf in tlay.leaves:
        mask[lf.offset:lf.offset + lf.size] = True
    assert not tbuf[:, ~torch.from_numpy(mask)].any()


@pytest.mark.parametrize("buf_dtype", ["float32", "bfloat16"])
def test_int8_wire_is_byte_identical(reduced_layouts, buf_dtype):
    jlay, tlay = reduced_layouts
    rng = np.random.default_rng(3)
    buf = rng.normal(size=(2, tlay.total)).astype(np.float32)
    for lf in tlay.leaves:                   # realistic zero padding
        buf[:, lf.offset + lf.size:lf.offset + lf.padded] = 0.0
    jbuf = jnp.asarray(buf, jnp.dtype(buf_dtype))
    tbuf = from_jax({"b": np.asarray(jbuf)})["b"]
    jcodec = jwire.get_codec("int8", jlay)
    tcodec = wire.get_codec("int8", tlay)
    jw = np.asarray(jcodec.encode(jbuf))
    tw = tcodec.encode(tbuf)
    assert tw.dtype == torch.int8 and tw.shape == jw.shape
    assert tw.shape[1] == tcodec.wire_width == jcodec.wire_width
    np.testing.assert_array_equal(tw.numpy(), jw)
    assert tcodec.wire_bytes() == jcodec.wire_bytes()
    # decoding gives the same payload and scales
    jp, js = jcodec.decode(jnp.asarray(jw))
    tp, ts = tcodec.decode(tw)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # and dequantizes to the same parameters
    jtree = jcodec.unpack(jp, js)
    ttree = tcodec.unpack(tp, ts)
    for a, b in zip(tree_lib.leaves(ttree), jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


def test_int8_rounds_half_to_even(reduced_layouts):
    """Exact .5 multiples of the scale round to even in both packages."""
    jlay, tlay = reduced_layouts
    buf = np.zeros((1, tlay.total), np.float32)
    for lf in tlay.leaves:
        k = np.arange(lf.size) % 9 - 4.5            # -4.5 .. 3.5
        vals = k * 0.125
        vals[0] = 127 * 0.125                       # absmax -> scale 1/8
        buf[0, lf.offset:lf.offset + lf.size] = vals[:lf.size]
    tw = wire.get_codec("int8", tlay).encode(torch.from_numpy(buf))
    jw = np.asarray(jwire.get_codec("int8", jlay).encode(jnp.asarray(buf)))
    np.testing.assert_array_equal(tw.numpy(), jw)
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
    with pytest.raises(NotImplementedError):
        wire.resolve_codec_name("fp8_e4m3")
    with pytest.raises(ValueError):
        wire.resolve_codec_name("zip")
