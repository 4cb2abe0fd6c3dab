"""The port's dense model, AdamW and data against the reference.

Reduced qwen3-4b with parameters drawn by the reference's ``Model.init`` and
transplanted with ``from_jax``. Tolerances: in float32 the logits hold to
rtol/atol 1e-4 and the loss to 1e-5 (matmul and transcendental round-off
only); in bf16 the two frameworks round at different places, so the loss
holds to 2e-2. AdamW runs the same f32 operations: 1e-6 relative.

The reference runs once per module in a fresh process
(``_reference_outputs``, through ``torch_round_cases.run_reference``): it
saves its parameters (bf16 ones widened to float32, which is exact), its
outputs, and its draws; the inputs of both sides come from the numpy
generators below.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import get_reduced_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import attention, build_model, transformer
from repro_torch.models.params import from_jax
from repro_torch.optim import adamw
from torch_round_cases import run_reference
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

TOKEN_KW = dict(vocab=256, seq_len=16, batch_per_node=3, num_nodes=2, seed=4)
TOKEN_DRAWS = ((0, False), (7, False), (3, True))
ADAMW_STEPS = 3
INIT_DIMS = dict(d_model=128, d_ff=256, vocab=512)


def _batch(step=0, seq=32):
    src = SyntheticTokens(DataConfig(vocab=256, seq_len=seq, batch_per_node=2,
                                     num_nodes=1), device="cpu")
    return src.batch_numpy(step)


def _attention_inputs():
    rng = np.random.default_rng(2)
    return [rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
            for _ in range(3)]


def _adamw_inputs():
    """(params, [grads of each step]) as numpy trees; large grads so that
    the clip engages."""
    rng = np.random.default_rng(9)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (3, 2, 4)}}

    def mk(s=1.0):
        return tree_lib.tree_map(
            lambda sh: (s * rng.normal(size=sh)).astype(np.float32), shapes,
            is_leaf=lambda x: isinstance(x, tuple))

    params = mk()
    grads = [mk(3.0) for _ in range(ADAMW_STEPS)]
    return params, grads


def _save_tree(out, prefix, leaves_with_paths):
    for path, leaf in leaves_with_paths:
        out[prefix + "/".join(k.key for k in path)] = np.asarray(
            leaf, dtype=np.float32)


def _reference_outputs():
    """The reference's parameters, forwards, losses, AdamW steps, token
    draws and init statistics (runs with JAX)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced_config as jget_reduced
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticTokens as JSyntheticTokens
    from repro.models import attention as jattn
    from repro.models import build_model as jbuild_model
    from repro.models import transformer as jtf
    from repro.optim import adamw as jadamw

    out = {}
    src = JSyntheticTokens(JDataConfig(**TOKEN_KW))
    for step, probe in TOKEN_DRAWS:
        for k, v in src.batch(step, probe=probe).items():
            out[f"tokens/{step}/{probe}/{k}"] = np.asarray(v)

    for dtype, step in (("float32", 0), ("bfloat16", 2)):
        jcfg = dataclasses.replace(jget_reduced("qwen3-4b"), dtype=dtype)
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        _save_tree(out, f"params/{dtype}/",
                   jax.tree_util.tree_flatten_with_path(jparams)[0])
        b = {k: jnp.asarray(v[0]) for k, v in _batch(step=step).items()}
        if dtype == "float32":
            out["logits"] = np.asarray(jtf.forward(
                jcfg, jparams, tokens=b["tokens"], remat=False))
        out[f"loss/{dtype}"] = np.asarray(jtf.loss_fn(jcfg, jparams, b)[0])

    q, k, v = map(jnp.asarray, _attention_inputs())
    for window in (0, 24):
        out[f"attention/{window}"] = np.asarray(
            jattn.chunked_causal_attention(q, k, v, window=window, chunk=16))

    params, grads = _adamw_inputs()
    jcfg = jadamw.AdamWConfig(lr=1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jadamw.init(jcfg, jp)
    for step, g in enumerate(grads):
        jp, jst, jm = jadamw.update(jcfg, jst, jp,
                                    jax.tree_util.tree_map(jnp.asarray, g))
        out[f"adamw/{step}/grad_norm"] = np.asarray(jm["grad_norm"])
        out[f"adamw/{step}/step"] = np.asarray(jst.step)
        for name, tree in (("p", jp), ("m", jst.m), ("v", jst.v)):
            _save_tree(out, f"adamw/{step}/{name}/",
                       jax.tree_util.tree_flatten_with_path(tree)[0])

    jcfg = dataclasses.replace(jget_reduced("qwen3-4b"), dtype="float32",
                               **INIT_DIMS)
    leaves = jax.tree_util.tree_leaves(
        jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    for n, y in enumerate(leaves):
        y = np.asarray(y)
        out[f"init/{n}/shape"] = np.asarray(y.shape, np.int64)
        out[f"init/{n}/any"] = np.asarray(bool(y.any()))
        out[f"init/{n}/std"] = np.asarray(y.std())
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_model", tmp_path_factory)


def _tree(reference, prefix):
    """The numpy tree saved under ``prefix`` (keys ``prefix`` + path)."""
    tree = {}
    for key, arr in reference.items():
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = arr
    return tree


def _port_pair(reference, dtype):
    """(port config, the reference's parameters transplanted)."""
    tcfg = dataclasses.replace(get_reduced_config("qwen3-4b"), dtype=dtype)
    tparams = from_jax(_tree(reference, f"params/{dtype}/"))
    tparams = tree_lib.tree_map(lambda x: x.to(getattr(torch, dtype)),
                                tparams)
    return tcfg, tparams


def test_synthetic_tokens_match_reference(reference):
    port = SyntheticTokens(DataConfig(**TOKEN_KW), device="cpu")
    for step, probe in TOKEN_DRAWS:
        got = port.batch(step, probe=probe)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int64
            np.testing.assert_array_equal(
                got[k].numpy(), reference[f"tokens/{step}/{probe}/{k}"])


def test_float32_logits_and_loss_match_reference(reference):
    tcfg, tparams = _port_pair(reference, "float32")
    b = {k: v[0] for k, v in _batch().items()}
    got = transformer.forward(tcfg, tparams,
                              tokens=torch.from_numpy(b["tokens"]).long())
    np.testing.assert_allclose(got.detach().numpy(), reference["logits"],
                               rtol=1e-4, atol=1e-4)
    tloss, _ = build_model(tcfg).loss(
        tparams, {k: torch.from_numpy(v).long() for k, v in b.items()})
    np.testing.assert_allclose(float(tloss), float(reference["loss/float32"]),
                               rtol=1e-5)


def test_bf16_loss_matches_reference(reference):
    tcfg, tparams = _port_pair(reference, "bfloat16")
    assert tree_lib.leaves(tparams)[0].dtype == torch.bfloat16
    b = {k: v[0] for k, v in _batch(step=2).items()}
    tloss, _ = build_model(tcfg).loss(
        tparams, {k: torch.from_numpy(v).long() for k, v in b.items()})
    np.testing.assert_allclose(float(tloss),
                               float(reference["loss/bfloat16"]), rtol=2e-2)


@pytest.mark.parametrize("window", [0, 24])
def test_chunked_attention_matches_reference(reference, window):
    q, k, v = map(torch.from_numpy, _attention_inputs())
    got = attention.chunked_causal_attention(q, k, v, window=window,
                                             chunk=16)
    np.testing.assert_allclose(got.numpy(), reference[f"attention/{window}"],
                               rtol=1e-5, atol=1e-6)
    # chunking changes nothing: the single-chunk path gives the same
    whole = attention.flash_ref(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_adamw_update_matches_reference(reference):
    params, grads = _adamw_inputs()
    tcfg = adamw.AdamWConfig(lr=1e-2)
    tp = from_jax(params)
    tst = adamw.init(tcfg, tp)
    for step, g in enumerate(grads):
        tp, tst, tm = adamw.update(tcfg, tst, tp, from_jax(g))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(reference[f"adamw/{step}/grad_norm"]),
                                   rtol=1e-6)
        for name, a in (("p", tp), ("m", tst.m), ("v", tst.v)):
            want = _tree(reference, f"adamw/{step}/{name}/")
            for x, y in zip(tree_lib.leaves(a), tree_lib.leaves(want),
                            strict=True):
                np.testing.assert_allclose(x.numpy(), y, rtol=1e-6,
                                           atol=1e-7, err_msg=name)
        assert int(tst.step) == int(reference[f"adamw/{step}/step"]) \
            == step + 1


def test_init_rule_matches_reference(reference):
    """Per-leaf scales follow the reference's rule, quirks included: embed
    forced to 1.0, fan-in shape[-2] for rank >= 3 leaves."""
    cfg = dataclasses.replace(get_reduced_config("qwen3-4b"), dtype="float32",
                              **INIT_DIMS)
    tparams = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    pairs = tree_lib.leaves_with_paths(tparams)
    assert f"init/{len(pairs)}/std" not in reference
    for n, (path, x) in enumerate(pairs):
        assert tuple(x.shape) == tuple(reference[f"init/{n}/shape"]), path
        if not bool(reference[f"init/{n}/any"]):
            assert not x.any(), path
            continue
        assert abs(float(x.std()) / float(reference[f"init/{n}/std"])
                   - 1) < 0.1, path
    assert abs(float(tparams["embed"].std()) - 1.0) < 0.05
    assert abs(float(tparams["blocks"]["attn"]["wq"].std())
               - 1 / np.sqrt(cfg.n_heads)) < 0.05
