"""The port's expert-parallel MoE paths and serve steps (``models/moe.py``,
``distributed/sharding.py``, ``launch/steps.py``) against the reference's.

The reference runs once per test run in a fresh process
(``_reference_outputs``, through ``torch_round_cases.run_reference``) on
eight fake CPU devices, a ``(data 2, model 4)`` mesh, as
``tests/test_moe_ep.py`` does: reduced moonshot-v1-16b-a3b in float32, its
MoE unit at capacity factors 8.0 (nothing dropped) and 1.0 (pairs
dropped), on weights and x both sides draw from the numpy generators of
``torch_ep_cases``; then ``make_serve_fns``' prefill and four decode steps
of the reduced model at its own capacity factor, 1.25, on the reference's
weights. The port computes the same mesh in one process
(``local_mesh``), shard by shard.

Tolerances:
* each shard's dispatch plan (destination, slot, source token), send
  buffer and slot ids, and the set of dropped pairs, exactly: they are
  integer bookkeeping and copies of x; the pairs' weights to rtol 1e-5
  (the router's softmax round-off, as ``tests/test_torch_moe.py``);
* outputs within ``1e-4 * (1 + max|out|)``, the reference test's own
  bound (float32 matmul round-off, and sums in another order);
* the spawned gloo ranks (a ``(2, 2)`` mesh, each on one thread) equal
  the one-process mesh bit for bit: the same shapes, the same exchanges,
  the same order of sums.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import torch_ep_cases as cases
from repro_torch.distributed import MeshStats, local_mesh, use_mesh
from repro_torch.models import moe
from repro_torch.models.params import from_jax, shard_experts
from torch_ranks_cases import spawn
from torch_round_cases import run_reference

CFS = cases.CAPACITY_FACTORS


def _shard(x, d, m, data, model):
    """Shard (d, m) of ``x`` [B, S, D] as the reference's ``P(("data",),
    "model", None)`` lays it, flattened to its tokens."""
    b, s = x.shape[0] // data, x.shape[1] // model
    return x[d * b:(d + 1) * b, m * s:(m + 1) * s].reshape(-1, x.shape[-1])


def _reference_outputs():
    """The reference's EP paths on eight fake CPU devices."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.configs.base import MoEConfig, ShapeCell
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import make_serve_fns
    from repro.models import build_model as jbuild_model
    from repro.models import moe as jmoe

    mesh = make_mesh(cases.MESH, ("data", "model"))
    data, model = cases.MESH
    p_np, x_np = cases.moe_inputs()
    p = {k: jnp.asarray(v) for k, v in p_np.items()}
    x = jnp.asarray(x_np)
    out = {}
    for cf in CFS:
        cfg = dataclasses.replace(
            get_reduced_config(cases.ARCH), dtype="float32",
            moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=32,
                          capacity_factor=cf))
        out[f"{cf}/ref"] = np.asarray(jmoe.moe_ref(cfg, p, x))
        with shd.use_mesh(mesh, shd.default_rules(mesh)):
            out[f"{cf}/a2a"] = np.asarray(jax.jit(
                lambda p_, x_: jmoe.moe_apply(cfg, p_, x_))(p, x))
            out[f"{cf}/repl"] = np.asarray(jax.jit(
                lambda p_, x_: jmoe.moe_apply(cfg, p_, x_, decode=True))(
                    p, x))
        # each shard's dispatch, as _moe_shard_a2a computes it
        e_local = cfg.moe.num_experts // model
        for d in range(data):
            for m in range(model):
                xs = _shard(x, d, m, data, model)
                t_loc, k = xs.shape[0], cfg.moe.top_k
                cap = max(k, int(t_loc * k / model
                                 * cfg.moe.capacity_factor))
                top_i, top_w = jmoe._route(cfg, p["router"], xs)
                buf, meta, plan = jmoe._dispatch_local(
                    cfg, xs, top_i, top_w, model, e_local, cap)
                key = f"{cf}/{d}{m}"
                out[key + "/buf"] = np.asarray(buf)
                out[key + "/meta"] = np.asarray(meta)
                for name in ("dest", "slot", "tok", "w"):
                    out[f"{key}/{name}"] = np.asarray(plan[name])
                # each plan entry's expert (the plan keeps its destination
                # only while the pair is kept)
                flat = top_i.reshape(-1)
                out[key + "/exp"] = np.asarray(flat[jnp.argsort(
                    flat // e_local, stable=True)])

    cfg = dataclasses.replace(get_reduced_config(cases.ARCH),
                              dtype="float32")
    jmodel = jbuild_model(cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["p/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    toks = jnp.asarray(cases.tokens(cfg.vocab))
    b, s = toks.shape
    prefill_fn, decode_fn = make_serve_fns(jmodel, mesh,
                                           ShapeCell("ep", s, b, "decode"))
    out["prefill"] = np.asarray(jax.jit(prefill_fn)(params,
                                                    {"tokens": toks}))
    state = jmodel.init_decode_state(b, s)
    step = jax.jit(decode_fn)
    steps = []
    for i in range(cases.DECODE_STEPS):
        logits, state = step(params, state, {"token": toks[:, i]})
        steps.append(np.asarray(logits))
    out["decode"] = np.stack(steps)
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One CPU thread per test process while this module runs (the ranks
    run on one each, and the one-process mesh must do their arithmetic)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("test_torch_moe_ep", tmp_path_factory)


def _unit():
    return cases.unit_on("cpu")


def _ref_params(ref):
    tree = {}
    for key, arr in ref.items():
        if key.startswith("p/"):
            node = tree
            *parents, leaf = key[2:].split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = arr
    return from_jax(tree)


def _tol(want):
    return 1e-4 * (1 + float(np.abs(want).max()))


SHARDS = [(d, m) for d in range(cases.MESH[0]) for m in range(cases.MESH[1])]


@pytest.mark.parametrize("shard", SHARDS, ids=lambda s: f"d{s[0]}m{s[1]}")
@pytest.mark.parametrize("cf", CFS)
def test_dispatch_plans_match_reference(ref, cf, shard):
    """Each shard's plan (dest, slot, token, weight), send buffer and slot
    ids equal the reference's, the slot-(0, 0) overwrite included."""
    p, x = _unit()
    cfg = cases.moe_cfg(cf)
    data, model = cases.MESH
    d, m = shard
    xs = _shard(x, d, m, data, model)
    cap = moe.capacity(cfg, xs.shape[0], model)
    top_i, top_w = moe._route(cfg, p["router"], xs)
    buf, meta, plan = moe._dispatch_local(cfg, xs, top_i, top_w, model,
                                          cfg.moe.num_experts // model, cap)
    key = f"{cf}/{d}{m}"
    for name in ("dest", "slot", "tok"):
        np.testing.assert_array_equal(plan[name].numpy(),
                                      ref[f"{key}/{name}"], err_msg=name)
    np.testing.assert_allclose(plan["w"].numpy(), ref[f"{key}/w"],
                               rtol=1e-5, atol=0)
    np.testing.assert_array_equal(buf.numpy(), ref[key + "/buf"])
    np.testing.assert_array_equal(meta.numpy(), ref[key + "/meta"])


@pytest.mark.parametrize("cf", CFS)
def test_dropped_pairs_match_reference(ref, cf):
    """The set of dropped (token, expert) pairs equals the reference's
    (weight zero in its plan, which keeps no destination for them), and the drop counts reach ``MeshStats``: none
    at 8.0, some at 1.0 (the guard against a vacuous test)."""
    p, x = _unit()
    cfg = cases.moe_cfg(cf)
    data, model = cases.MESH
    stats = MeshStats()
    cases.moe_rows(cfg, p, x, local_mesh(data, model, "cpu", stats=stats))
    n_dropped = 0
    for d in range(data):
        for m in range(model):
            key = f"{cf}/{d}{m}"
            want = sorted((int(t), int(e)) for t, e, w in zip(
                ref[key + "/tok"], ref[key + "/exp"], ref[key + "/w"])
                if w == 0)
            xs = _shard(x, d, m, data, model)
            top_i, top_w = moe._route(cfg, p["router"], xs)
            _, _, plan = moe._dispatch_local(
                cfg, xs, top_i, top_w, model, cfg.moe.num_experts // model,
                moe.capacity(cfg, xs.shape[0], model))
            gone = ~plan["ok"]
            exp = top_i.reshape(-1)[plan["order"]]
            got = sorted((int(t), int(e)) for t, e in zip(
                plan["tok"][gone], exp[gone]))
            assert got == want, key
            assert int(stats.dropped[d][m]) == len(want)
            n_dropped += len(want)
    assert (n_dropped > 0) == (cf < 2.0), n_dropped


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("path", ("a2a", "repl"))
def test_ep_outputs_match_reference(ref, cf, path):
    """``moe_apply`` on the one-process (2, 4) mesh, all-to-all and
    replicated, against the reference's under its mesh; where nothing
    drops both equal ``moe_ref``."""
    p, x = _unit()
    cfg = cases.moe_cfg(cf)
    got = cases.moe_rows(cfg, p, x, local_mesh(*cases.MESH, "cpu"),
                         decode=path == "repl").numpy()
    want = ref[f"{cf}/{path}"]
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(want))
    if path == "repl" or cf == CFS[0]:
        np.testing.assert_allclose(got, ref[f"{cf}/ref"], rtol=0,
                                   atol=_tol(want))


@pytest.mark.parametrize("path", ("a2a", "repl"))
def test_ep_in_bf16_matches_moe_ref(path):
    """In bf16 (the card's dtype), where nothing drops, both paths on the
    one-process (2, 4) mesh against ``moe_ref`` within 4 bf16 ulps of
    max|y| (``tests/test_torch_moe.py``'s bf16 bound: each rounds another
    product to bf16)."""
    p, x = _unit()
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    x = x.to(torch.bfloat16)
    cfg = dataclasses.replace(cases.moe_cfg(CFS[0]), dtype="bfloat16")
    got = cases.moe_rows(cfg, p, x, local_mesh(*cases.MESH, "cpu"),
                         decode=path == "repl")
    want = moe.moe_ref(cfg, p, x).float()
    assert got.dtype == torch.bfloat16
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 4 * 2.0 ** -8 * scale


def test_serve_fns_match_reference(ref):
    """``make_serve_fns`` on the one-process (2, 4) mesh: the prefill's
    logits and four decode steps' against the reference's."""
    params = _ref_params(ref)
    toks = torch.from_numpy(cases.tokens(cases.serve_cfg().vocab)).long()
    p, x = _unit()
    got = cases.run_ep(local_mesh(*cases.MESH, "cpu"), p, x, params, toks)
    for name in ("prefill", "decode"):
        want = ref[name]
        assert got[name].shape == want.shape, name
        np.testing.assert_allclose(got[name].numpy(), want, rtol=0,
                                   atol=_tol(want), err_msg=name)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of the ``RANKS_MESH`` gloo ranks, their saved outputs."""
    d = tmp_path_factory.mktemp("ep_ranks")
    world = cases.RANKS_MESH[0] * cases.RANKS_MESH[1]
    spawn(cases.ranks_worker, world, d, str(d))
    return [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(world)]


@pytest.fixture(scope="module")
def one_process():
    """The same computation on the one-process ``RANKS_MESH``."""
    p, x = _unit()
    params, toks = cases.served_on("cpu")
    return cases.run_ep(local_mesh(*cases.RANKS_MESH, "cpu"), p, x, params,
                        toks), params


@pytest.mark.parametrize("name", ("a2a", "repl", "prefill", "decode"))
def test_ranks_equal_one_process(ranks, one_process, name):
    """Every rank's outputs equal the one-process mesh's bit for bit: the
    MoE unit's rows of its data index, and the global prefill and decode
    logits."""
    want, _ = one_process
    data, model = cases.RANKS_MESH
    rows = cases.SHAPE[0] // data
    for r, got in enumerate(ranks):
        d = r // model
        w = want[name]
        if name in ("a2a", "repl"):
            w = w[d * rows:(d + 1) * rows]
        assert torch.equal(got[name], w), (r, name)


def test_rank_holds_only_its_experts(ranks, one_process):
    """A rank's drawn tree holds its experts' slice of the whole draw
    (``Model.init(mesh=)``), equal to ``shard_experts`` of the whole."""
    _, params = one_process
    e, model = cases.serve_cfg().moe.num_experts, cases.RANKS_MESH[1]
    for got in ranks:
        assert got["wg_shape"].tolist()[1] == e // model
    rank = dataclasses.replace(local_mesh(*cases.RANKS_MESH, "cpu"),
                               coords=(1, 1))
    cut = shard_experts(params, rank)
    whole = params["blocks"]["moe"]
    for name in ("wg", "wu", "wd"):
        assert torch.equal(cut["blocks"]["moe"][name],
                           whole[name][:, e // model:])
    assert cut["blocks"]["moe"]["router"] is whole["router"]
    assert cut["embed"] is params["embed"]


@pytest.mark.parametrize("mesh", ("none", "model 1", "indivisible"))
def test_moe_apply_takes_moe_ref_as_the_reference(mesh):
    """No mesh, a model axis of 1, or one that does not divide the experts:
    ``moe_apply`` is ``moe_ref``, as the reference chooses, for the
    full-sequence and the decode path alike."""
    p, x = _unit()
    cfg = cases.moe_cfg(1.0)
    meshes = {"none": None, "model 1": local_mesh(8, 1, "cpu"),
              "indivisible": local_mesh(1, 3, "cpu")}
    want = moe.moe_ref(cfg, p, x)
    with use_mesh(meshes[mesh]):
        for decode in (False, True):
            assert torch.equal(moe.moe_apply(cfg, p, x, decode=decode), want)


def test_init_mesh_refuses_what_cannot_run():
    """A world that is not data x model, and NCCL with more ranks than
    cards, raise before any process group is made."""
    from repro_torch.launch.mesh import init_mesh
    with pytest.raises(ValueError, match="needs 4 ranks"):
        init_mesh(2, 2, "cpu", backend="gloo", world_size=3, rank=0)
    with pytest.raises(ValueError, match="needs device cuda"):
        init_mesh(1, 2, "cpu", backend="nccl", world_size=2, rank=0)
    with pytest.raises(ValueError, match="one card a rank"):
        init_mesh(1, 2, "cuda", backend="nccl", world_size=2, rank=0)
    assert init_mesh(2, 4, "cpu").local
