"""Tensor-parallel serving from sharded parameters (``launch/steps.py``:
``decode_state_specs``, ``make_serve_fns``; ``distributed/fsdp.py:Served``;
the ``*_tp`` paths of ``models/``) against the reference.

The reference runs once per test run in a fresh process on eight fake CPU
devices (``_reference_outputs``, through
``torch_round_cases.run_reference``):

* (a) ``decode_state_specs`` of every zoo arch at full size (``eval_shape``
  only) on ``(data, model)`` meshes of (1, 2), (2, 2) and (1, 4);
* (b) its jitted ``make_serve_fns`` with ``in_shardings`` from
  ``param_specs`` and ``decode_state_specs``: the prefill's logits and the
  decode steps' from an empty state, for each case of
  ``torch_tp_cases.SERVE_CASES`` (reduced configs in float32, the
  reference's own initial parameters).

The port computes each whole in one process (``local_mesh``), shard by
shard, from the reference's parameters (``params.from_jax``); (c) four
spawned gloo ranks on (2, 2), each holding only its shards drawn from a
seed, against the one-process mesh; (d) a rank's parameter and cache
bytes against their reckoning; (e) hymba refused at ``model > 1``.

Tolerances:
* specs (a one-axis tuple entry read as its axis), shapes and dtypes
  exactly;
* logits within ``5e-5 * (1 + max|logit|)``: float32 round-off of sums in
  another order (GSPMD's reductions against the port's in-order float32
  sums over the model shards, and the decode's log-sum-exp merge over
  sequence shards). The cases show 4e-7 to 5e-6 of max|logit|, and
  rwkv6-7b 2.7e-5, which its unsharded path shows as well (the plain
  recurrence against the reference's scan);
* the ranks equal the one-process mesh bit for bit: the same shapes, the
  same exchanges, the same order of sums.
"""
import json
import os

import numpy as np
import pytest
import torch

import torch_tp_cases as cases
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import fsdp, local_mesh
from repro_torch.launch.steps import (decode_shard_shapes,
                                      decode_state_specs, make_serve_fns)
from repro_torch.models import build_model
from repro_torch.models.params import from_jax
from torch_ranks_cases import spawn
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_round_cases import run_reference

CASES = list(cases.SERVE_CASES)


def _reference_outputs():
    """The reference on eight fake CPU devices: (a) the zoo's decode state
    specs, (b) each serve case's prefill and decode logits."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from repro.configs import ARCH_IDS as JARCHS
    from repro.configs import get_config as jget_config
    from repro.configs import get_reduced_config as jget_reduced
    from repro.configs.base import ShapeCell
    from repro.distributed import sharding as shd
    from repro.launch.steps import (decode_state_specs as jspecs,
                                    make_serve_fns as jserve)
    from repro.models import build_model as jbuild
    from repro.models.model import arch_rules

    def mesh_of(shape):
        return Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(
            shape), ("data", "model"))

    def keyed(tree, is_leaf=None):
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]:
            yield "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                           for k in path), leaf

    out = {}
    # (a) the decode state's specs and shapes at full size
    specs = {}
    for shape in cases.SPEC_MESHES:
        mesh = mesh_of(shape)
        for arch in JARCHS:
            state, sh = jspecs(jget_config(arch), mesh, cases.SPEC_BATCH,
                               cases.SPEC_LEN)
            shapes = dict(keyed(state))
            for key, s in keyed(sh):
                specs[f"{shape}/{arch}/{key}"] = dict(
                    spec=[list(e) if isinstance(e, tuple) else e
                          for e in s.spec],
                    shape=list(shapes[key].shape),
                    dtype=str(shapes[key].dtype))
    out["specs"] = np.asarray(json.dumps(specs))

    # (b) the jitted serve steps on each case's mesh
    for name in cases.SERVE_CASES:
        cfg = cases.cfg_of(jget_reduced, name)
        model = jbuild(cfg)
        mesh = mesh_of(cases.SERVE_CASES[name][1])
        params = model.init(jax.random.PRNGKey(0))
        for key, leaf in keyed(params):
            out[f"{name}/p/{key}"] = np.asarray(leaf)
        with shd.use_mesh(mesh, arch_rules(cfg, mesh)):
            pspec = model.param_specs()
        psh = jax.tree_util.tree_map(
            lambda s, p: NamedSharding(mesh, shd.fit_spec(mesh, p.shape, s)),
            pspec, params, is_leaf=lambda s: isinstance(s, P))
        params = jax.device_put(params, psh)

        def rows(tree):
            return jax.tree_util.tree_map(lambda a: NamedSharding(
                mesh, shd.fit_spec(mesh, a.shape, P(("data",)))), tree)
        batch = {k: jnp.asarray(v) for k, v in cases.inputs(cfg).items()}
        b, s = cases.SHAPE
        prefill_fn, decode_fn = jserve(model, mesh,
                                       ShapeCell("tp", s, b, "decode"))
        out[f"{name}/prefill"] = np.asarray(jax.jit(
            prefill_fn, in_shardings=(psh, rows(batch)))(params, batch))
        state, ssh = jspecs(cfg, mesh, b, s)
        state = jax.device_put(model.init_decode_state(b, s), ssh)
        first = cases.step_input(batch, 0)
        step = jax.jit(decode_fn, in_shardings=(psh, ssh, rows(first)))
        logits = []
        for i in range(cases.steps_of(name)):
            lg, state = step(params, state, cases.step_input(batch, i))
            state = jax.device_put(state, ssh)
            logits.append(np.asarray(lg))
        out[f"{name}/decode"] = np.stack(logits)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("test_torch_tp_serve", tmp_path_factory)


def _ref_params(ref, name):
    prefix = f"{name}/p/"
    tree = {}
    for key, arr in ref.items():
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = arr
    return from_jax(tree)


def _tol(want):
    return 5e-5 * (1 + float(np.abs(want).max()))


def _entries(spec) -> list:
    """A spec's entries, a tuple of one mesh axis as that axis (newer
    ``PartitionSpec``s store ``("data",)`` as ``"data"``; both mean the
    same placement)."""
    out = []
    for e in spec:
        e = list(e) if isinstance(e, (tuple, list)) else e
        out.append(e[0] if isinstance(e, list) and len(e) == 1 else e)
    return out


def _flat_specs(state, specs):
    """``{"cache/<family>/<field>": (spec, shape, dtype)}`` and ``pos``."""
    out = {"pos": (_entries(specs.pos), [], "int32")}
    for name, entry in state.cache.items():
        for f, t, s in zip(entry._fields, entry, specs.cache[name]):
            out[f"cache/{name}/{f}"] = (
                _entries(s), list(t.shape),
                str(t.dtype).replace("torch.", ""))
    return out


# ---------------------------------------------------- (a) decode specs ----
@pytest.mark.parametrize("shape", cases.SPEC_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_specs_match_reference(ref, arch, shape):
    """Every leaf of the decode state, at full size: the spec after
    ``fit_spec``, the shape and the dtype equal the reference's."""
    prefix = f"{shape}/{arch}/"
    want = {k[len(prefix):]: (_entries(v["spec"]), v["shape"], v["dtype"])
            for k, v in json.loads(str(ref["specs"])).items()
            if k.startswith(prefix)}
    state, specs = decode_state_specs(get_config(arch),
                                      local_mesh(*shape, "cpu"),
                                      cases.SPEC_BATCH, cases.SPEC_LEN)
    assert _flat_specs(state, specs) == want


# ------------------------------------------------------ (b) serving ----
@pytest.fixture(scope="module")
def served(ref):
    """Each case on its one-process mesh from the reference's weights."""
    out = {}
    for name in CASES:
        cfg = cases.port_cfg(name)
        mesh = local_mesh(*cases.SERVE_CASES[name][1], "cpu")
        out[name] = cases.run_serve(build_model(cfg), mesh,
                                    _ref_params(ref, name),
                                    cases.torch_inputs(cfg),
                                    cases.steps_of(name))
    return out


@pytest.mark.parametrize("what", ("prefill", "decode"))
@pytest.mark.parametrize("name", CASES)
def test_serve_fns_match_reference(ref, served, name, what):
    """The prefill's logits [4, 16, V] and every decode step's [4, V]
    against the reference's jitted steps under its shardings."""
    want = ref[f"{name}/{what}"]
    got = served[name][what].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))


def test_mesh_changes_the_arithmetic(ref, served):
    """Guard against a vacuous comparison: the one-process (2, 2) mesh
    splits the sums (its logits are not the unsharded path's bits), and
    still lands within the tolerance of the reference."""
    name = "qwen3-4b"
    cfg = cases.port_cfg(name)
    model = build_model(cfg)
    b, s = cases.SHAPE
    from repro_torch.configs.base import ShapeCell
    prefill_fn, _ = make_serve_fns(model, None,
                                   ShapeCell("tp", s, b, "decode"))
    with torch.inference_mode():
        whole = prefill_fn(_ref_params(ref, name), cases.torch_inputs(cfg))
    assert not torch.equal(whole, served[name]["prefill"])
    want = ref[f"{name}/prefill"]
    np.testing.assert_allclose(whole.numpy(), want, rtol=0, atol=_tol(want))


# -------------------------------------------------- (c), (d) the ranks ----
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of the ``RANKS_MESH`` gloo ranks, their saved outputs."""
    d = tmp_path_factory.mktemp("tp_ranks")
    world = cases.RANKS_MESH[0] * cases.RANKS_MESH[1]
    spawn(cases.ranks_worker, world, d, str(d))
    return [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(world)]


@pytest.fixture(scope="module")
def one_process():
    """The ranks' cases on the one-process mesh, from the whole tree of
    the same seed."""
    out = {}
    for name in cases.RANKS_CASES:
        model, params = cases.drawn(name)
        out[name] = cases.run_serve(
            model, local_mesh(*cases.RANKS_MESH, "cpu"), params,
            cases.torch_inputs(cases.port_cfg(name)), cases.steps_of(name))
    return out


@pytest.mark.parametrize("what", ("prefill", "decode"))
@pytest.mark.parametrize("name", cases.RANKS_CASES)
def test_ranks_equal_one_process(ranks, one_process, name, what):
    """Every rank's global logits equal the one-process mesh's bit for
    bit."""
    want = one_process[name][what]
    for r, got in enumerate(ranks):
        assert torch.equal(got[f"{name}/{what}"], want), (r, name, what)


@pytest.mark.parametrize("name", cases.RANKS_CASES)
def test_rank_holds_its_shards_only(ranks, name):
    """A rank's parameter bytes are its shards' (``fsdp.shard_bytes``: a
    quarter of each matrix, the norms and the RWKV mixes whole, under half
    the whole tree at this size), and its decode state's bytes those of
    its shard shapes of ``decode_state_specs``."""
    cfg = cases.port_cfg(name)
    model = build_model(cfg)
    mesh = local_mesh(*cases.RANKS_MESH, "cpu")
    b, s = cases.SHAPE
    shapes = decode_shard_shapes(cfg, mesh, b, s)
    state, _ = decode_state_specs(cfg, mesh, b, s)
    state_bytes = sum(
        int(np.prod(shapes[n][f])) * t.element_size()
        for n, entry in state.cache.items()
        for f, t in zip(entry._fields, entry))
    whole_state = cases.state_nbytes(state)
    whole_params = cases.tree_nbytes(cases.drawn(name)[1])
    for got in ranks:
        assert int(got[f"{name}/param_bytes"]) == \
            fsdp.shard_bytes(model, mesh)["params"]
        assert int(got[f"{name}/param_bytes"]) < whole_params / 2
        assert int(got[f"{name}/state_bytes"]) == state_bytes
        assert state_bytes <= whole_state / 2


@pytest.mark.parametrize("name", CASES)
def test_shard_shapes_split_as_the_specs_say(name):
    """A rank's decode state: rows of its data index, and its kv heads
    (or its S / model cache slots, or its RWKV heads)."""
    cfg = cases.port_cfg(name)
    data, model = cases.SERVE_CASES[name][1]
    b, s = cases.SHAPE
    shapes = decode_shard_shapes(cfg, local_mesh(data, model, "cpu"), b, s)
    l = cfg.n_layers
    if cfg.rwkv:
        assert shapes["rwkv"]["s"] == (l, b // data, cfg.n_heads // model,
                                       cfg.head_dim, cfg.head_dim)
        assert shapes["rwkv"]["prev_tm"] == (l, b // data, cfg.d_model)
        return
    slots = min(s, cfg.sliding_window or s)
    on_heads = cfg.n_kv_heads % model == 0 and not cfg.sliding_window
    want = (l, b // data) + ((slots, cfg.n_kv_heads // model) if on_heads
                             else (slots // model, cfg.n_kv_heads)) \
        + (cfg.head_dim,)
    assert shapes["kv"]["k"] == shapes["kv"]["v"] == want
    assert shapes["kv"]["pos"] == (l,)


def test_cut_equals_the_drawn_shards():
    """``Model.init(mesh=, specs=)`` on a rank draws the blocks that
    ``fsdp.cut_for`` cuts from the whole tree of the same seed."""
    import dataclasses
    name = "qwen3-4b"
    model, whole = cases.drawn(name)
    for coords in local_mesh(*cases.RANKS_MESH, "cpu").all_coords():
        mesh = dataclasses.replace(local_mesh(*cases.RANKS_MESH, "cpu"),
                                   coords=coords)
        _, mine = cases.drawn(name, mesh=mesh)
        cut = fsdp.cut_for(model, whole, mesh)
        for a, b in zip(tree_lib.leaves(mine), tree_lib.leaves(cut),
                        strict=True):
            assert torch.equal(a, b)


# ------------------------------------------------------ (e) refusals ----
@pytest.mark.parametrize("shape", ((1, 2), (2, 2)))
def test_hymba_refused_at_model_above_one(shape):
    """hymba's SSM heads do not split at head boundaries over ``model``:
    the serve steps raise, naming the ROADMAP item, and no whole-parameter
    path runs in their place."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import ShapeCell
    model = build_model(get_reduced_config("hymba-1.5b"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, "
                                                  "item 1\\(e\\)"):
        make_serve_fns(model, local_mesh(*shape, "cpu"),
                       ShapeCell("tp", 16, 4, "decode"))


def test_hymba_served_at_model_one():
    """At ``model`` 1 hymba serves on the mesh (its SSM whole), equal to
    the unsharded steps' logits within round-off."""
    import dataclasses
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import ShapeCell
    cfg = dataclasses.replace(get_reduced_config("hymba-1.5b"),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = cases.torch_inputs(cfg)
    cell = ShapeCell("tp", cases.SHAPE[1], cases.SHAPE[0], "decode")
    with torch.inference_mode():
        want = make_serve_fns(model, None, cell)[0](params, batch)
        got = make_serve_fns(model, local_mesh(2, 1, "cpu"), cell)[0](
            params, batch)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
