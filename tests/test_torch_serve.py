"""The port's serving path (``launch.serve``) against the reference's.

Reduced qwen3-4b, reduced qwen3-4b with an 8-entry sliding window (a ring
buffer that wraps: 16 prompt and 12 generated tokens), and reduced
rwkv6-7b, all in float32. The reference (in a fresh process, through
``torch_round_cases.run_reference``) draws its parameters with
``Model.init``, adds numpy noise to every leaf (so that its zero-initialised
gains, mixes, decays and bonus matter), and runs what ``serve.main`` runs:
``Model.prefill``, then the prompt replayed through a jitted
``decode_step``, then greedy steps. The port takes the same parameters
(``from_jax``) and prompts and runs ``launch.serve.run``, whose prefill
takes the kernels' path (``use_kernel=True``; on the CPU their plain
versions).

Tolerances: logits (prefill, replay, every step) to rtol 1e-4 / atol 1e-5
(float32 round-off of the same operations in other orders); the final
caches to rtol 1e-4 / atol 1e-4 of the leaf's largest magnitude (an rwkv
state entry near zero is a sum of decayed products that size, and keeps
their absolute round-off); the greedy tokens and the cache positions
exactly.
"""
import argparse
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.launch import serve
from repro_torch.models.params import from_jax
from torch_round_cases import SRC, run_reference
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)

# name -> (arch, replaced config fields, batch, prompt length, gen length)
CASES = {
    "qwen3-4b": ("qwen3-4b", {}, 3, 16, 9),
    "qwen3-4b-window8": ("qwen3-4b", {"sliding_window": 8}, 2, 16, 12),
    "rwkv6-7b": ("rwkv6-7b", {}, 3, 16, 9),
}


def _prompts(name):
    _, _, b, s, _ = CASES[name]
    return np.random.default_rng(len(name)).integers(0, 256, size=(b, s))


def _reference_outputs():
    """Each case's parameters, prefill logits, replay and step logits,
    tokens and final cache, as serve.main computes them (runs with JAX)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced_config as jget_reduced
    from repro.models import build_model as jbuild_model

    out = {}
    for name, (arch, fields, b, s, gen_len) in CASES.items():
        jcfg = dataclasses.replace(jget_reduced(arch), dtype="float32",
                                   **fields)
        model = jbuild_model(jcfg)
        rng = np.random.default_rng(3)
        params = jax.tree_util.tree_map(
            lambda a: a + jnp.asarray(0.1 * rng.normal(size=a.shape),
                                      jnp.float32),
            model.init(jax.random.PRNGKey(0)))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{name}/params/" + "/".join(k.key for k in path)] = \
                np.asarray(leaf)
        prompts = jnp.asarray(_prompts(name), jnp.int32)
        max_len = s + gen_len
        out[f"{name}/prefill"] = np.asarray(
            model.prefill(params, {"tokens": prompts}))
        state = model.init_decode_state(b, max_len)
        step = jax.jit(lambda p, st, t: model.decode_step(p, st, t,
                                                          max_len=max_len))
        for i in range(s):
            lg, state = step(params, state, prompts[:, i])
        out[f"{name}/replay"] = np.asarray(lg)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        tokens, steps = [tok], []
        for _ in range(gen_len - 1):
            lg, state = step(params, state, tok)
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            tokens.append(tok)
            steps.append(np.asarray(lg))
        out[f"{name}/steps"] = np.stack(steps)
        out[f"{name}/tokens"] = np.stack([np.asarray(t) for t in tokens], 1)
        for fam, tree in state.cache.items():
            for field, leaf in tree._asdict().items():
                out[f"{name}/cache/{fam}/{field}"] = np.asarray(leaf)
        out[f"{name}/pos"] = np.asarray(state.pos)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference("test_torch_serve", tmp_path_factory)


def _tree(reference, prefix):
    tree = {}
    for key, arr in reference.items():
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = arr
    return tree


def _args(**kw):
    args = serve.parse_args(["--device", "cpu"])
    return argparse.Namespace(**{**vars(args), **kw})


@pytest.fixture(scope="module")
def served(reference):
    """The port's serve.run on each case, from the reference's weights."""
    out = {}
    for name, (arch, fields, b, s, gen_len) in CASES.items():
        cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32",
                                  **fields)
        params = from_jax(_tree(reference, f"{name}/params/"))
        prompts = torch.from_numpy(_prompts(name))
        out[name] = serve.run(cfg, _args(batch=b, prompt_len=s,
                                         gen_len=gen_len),
                              params=params, prompts=prompts)
    return out


def _close(got, want, msg):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-4,
                               atol=1e-5, err_msg=msg)


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_logits_match_reference(reference, served, name):
    """The kernels' path of the prefill (their plain versions on the CPU)
    against the reference's Model.prefill, which runs the plain attention
    and recurrence."""
    rec = served[name]
    assert rec["prefill_launches"] == {"flash_attention": 0,
                                       "rwkv6_scan": 0}
    _close(rec["prefill_logits"], reference[f"{name}/prefill"], "prefill")


@pytest.mark.parametrize("name", list(CASES))
def test_replay_and_greedy_decode_match_reference(reference, served, name):
    """The prompt replay and the greedy steps: logits per step, tokens, and
    the final cache (the sliding-window case wraps its ring buffer)."""
    rec = served[name]
    _close(rec["replay_logits"], reference[f"{name}/replay"], "replay")
    want_steps = reference[f"{name}/steps"]
    assert rec["step_logits"].shape == want_steps.shape
    for n, (got, want) in enumerate(zip(rec["step_logits"], want_steps)):
        _close(got, want, f"step {n}")
    np.testing.assert_array_equal(rec["tokens"].numpy(),
                                  reference[f"{name}/tokens"])
    state = rec["state"]
    assert state.pos == int(reference[f"{name}/pos"])
    for fam, tree in state.cache.items():
        for field, leaf in tree._asdict().items():
            want = reference[f"{name}/cache/{fam}/{field}"]
            if field == "pos":
                np.testing.assert_array_equal(leaf.numpy(), want)
            else:
                np.testing.assert_allclose(
                    leaf.float().numpy(), want, rtol=1e-4,
                    atol=1e-4 * float(np.abs(want).max()),
                    err_msg=f"cache {fam}.{field}")


def test_sliding_window_cache_is_a_ring(served):
    """The windowed case's cache holds 8 positions, and it decoded past
    them."""
    rec = served["qwen3-4b-window8"]
    assert rec["state"].cache["kv"].k.shape[2] == 8
    assert rec["state"].pos == 16 + 12 - 1 > 8


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-7b"])
def test_serve_launcher_runs_on_cpu(arch):
    """``python -m repro_torch.launch.serve --reduced --device cpu``."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"arch={arch} batch=4" in proc.stdout
    assert "prefill launches {'flash_attention': 0, 'rwkv6_scan': 0}" \
        in proc.stdout
    assert "sample generations" in proc.stdout


def test_serve_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced"])
