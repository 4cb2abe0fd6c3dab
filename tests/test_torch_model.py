"""The port's dense model, AdamW and data against the reference.

Reduced qwen3-4b with parameters drawn by the reference's ``Model.init`` and
transplanted with ``from_jax``. Tolerances: in float32 the logits hold to
rtol/atol 1e-4 and the loss to 1e-5 (matmul and transcendental round-off
only); in bf16 the two frameworks round at different places, so the loss
holds to 2e-2. AdamW runs the same f32 operations: 1e-6 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch import tree as tree_lib
from repro_torch.configs import get_reduced_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import attention, build_model, transformer
from repro_torch.models.params import from_jax
from repro_torch.optim import adamw


def _pair(dtype):
    jcfg = dataclasses.replace(jget_reduced("qwen3-4b"), dtype=dtype)
    tcfg = dataclasses.replace(get_reduced_config("qwen3-4b"), dtype=dtype)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, from_jax(jax.device_get(jparams))


def _batch(step=0, seq=32):
    src = SyntheticTokens(DataConfig(vocab=256, seq_len=seq, batch_per_node=2,
                                     num_nodes=1), device="cpu")
    return src.batch_numpy(step)


def test_synthetic_tokens_match_reference():
    kw = dict(vocab=256, seq_len=16, batch_per_node=3, num_nodes=2, seed=4)
    ref = JSyntheticTokens(JDataConfig(**kw))
    port = SyntheticTokens(DataConfig(**kw), device="cpu")
    for step, probe in ((0, False), (7, False), (3, True)):
        want = ref.batch(step, probe=probe)
        got = port.batch(step, probe=probe)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int64
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_float32_logits_and_loss_match_reference():
    jcfg, tcfg, jparams, tparams = _pair("float32")
    b = {k: v[0] for k, v in _batch().items()}
    want = np.asarray(jtf.forward(jcfg, jparams, tokens=jnp.asarray(
        b["tokens"]), remat=False))
    got = transformer.forward(tcfg, tparams,
                              tokens=torch.from_numpy(b["tokens"]).long())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    jloss, _ = jtf.loss_fn(jcfg, jparams, {k: jnp.asarray(v)
                                           for k, v in b.items()})
    tloss, _ = build_model(tcfg).loss(
        tparams, {k: torch.from_numpy(v).long() for k, v in b.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_bf16_loss_matches_reference():
    jcfg, tcfg, jparams, tparams = _pair("bfloat16")
    assert tree_lib.leaves(tparams)[0].dtype == torch.bfloat16
    b = {k: v[0] for k, v in _batch(step=2).items()}
    jloss, _ = jtf.loss_fn(jcfg, jparams, {k: jnp.asarray(v)
                                           for k, v in b.items()})
    tloss, _ = build_model(tcfg).loss(
        tparams, {k: torch.from_numpy(v).long() for k, v in b.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-2)


@pytest.mark.parametrize("window", [0, 24])
def test_chunked_attention_matches_reference(window):
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jattn.chunked_causal_attention(
        *map(jnp.asarray, (q, k, v)), window=window, chunk=16))
    got = attention.chunked_causal_attention(
        *map(torch.from_numpy, (q, k, v)), window=window, chunk=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # chunking changes nothing: the single-chunk path gives the same
    whole = attention.flash_ref(*map(torch.from_numpy, (q, k, v)),
                                causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(9)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 2, 4)}}
    mk = lambda s=1.0: tree_lib.tree_map(
        lambda sh: (s * rng.normal(size=sh)).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    params, grads = mk(), mk(3.0)                 # large grads: clip engages
    jcfg = jadamw.AdamWConfig(lr=1e-2)
    tcfg = adamw.AdamWConfig(lr=1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jadamw.init(jcfg, jp)
    tp = from_jax(params)
    tst = adamw.init(tcfg, tp)
    for step in range(3):
        g = mk(3.0) if step else grads
        jp, jst, jm = jadamw.update(jcfg, jst, jp,
                                    jax.tree_util.tree_map(jnp.asarray, g))
        tp, tst, tm = adamw.update(tcfg, tst, tp, from_jax(g))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for name, a, b in (("p", tp, jp), ("m", tst.m, jst.m),
                           ("v", tst.v, jst.v)):
            for x, y in zip(tree_lib.leaves(a), jax.tree_util.tree_leaves(b)):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=name)
        assert int(tst.step) == int(jst.step) == step + 1


def test_init_rule_matches_reference():
    """Per-leaf scales follow the reference's rule, quirks included: embed
    forced to 1.0, fan-in shape[-2] for rank >= 3 leaves."""
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"), dtype="float32",
                              d_model=128, d_ff=256, vocab=512)
    jcfg = dataclasses.replace(jget_reduced("qwen3-4b"), dtype="float32",
                               d_model=128, d_ff=256, vocab=512)
    tparams = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    for (path, x), y in zip(tree_lib.leaves_with_paths(tparams),
                            jax.tree_util.tree_leaves(jparams)):
        y = np.asarray(y)
        assert tuple(x.shape) == y.shape, path
        if not y.any():
            assert not x.any(), path
            continue
        assert abs(float(x.std()) / float(y.std()) - 1) < 0.1, path
    assert abs(float(tparams["embed"].std()) - 1.0) < 0.05
    assert abs(float(tparams["blocks"]["attn"]["wq"].std())
               - 1 / np.sqrt(cfg.n_heads)) < 0.05
