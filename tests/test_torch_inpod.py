"""The in-pod sharded local step (``distributed.fsdp``, the specs of
``models/params.py``/``models/model.py``, the all-to-all path's backward in
``models/moe.py``, ``launch/steps.py:make_train_fns`` and the consensus
trainer under an in-pod mesh) against the reference.

The reference runs once per test run in a fresh process on eight fake CPU
devices (``_reference_outputs``, through
``torch_round_cases.run_reference``):

* (a) every zoo arch's ``param_specs`` under ``arch_rules`` on ``(data,
  model)`` meshes of (2, 2), (2, 4) and (1, 2);
* (b) ``make_train_fns(grad_rs=True)`` on ``(data 2, model 4)``: 3 AdamW
  steps (the default ``AdamWConfig``, lr 3e-4) of reduced qwen3-4b and of
  reduced moonshot-v1-16b-a3b in float32, the MoE at capacity factor 1.0,
  where pairs drop, and the first step's gradients (``jax.grad`` of the
  same loss under the mesh); moonshot's 3 steps again at lr 1e-2;
* (c) its ``ConsensusTrainer`` on ``(pod 2, data 2, model 2)`` with
  ``shard_consensus`` and without it (the flat rows replicated in-pod,
  the reference's default): reduced moonshot in float32 at its own
  capacity factor 1.25, nap, ring, local_steps 2, 4 steps.

The port computes each whole in one process (``local_mesh``,
``trivial_grid(2, mesh=(2, 2))``), from the reference's initial
parameters, and holds its replicated run against its sharded one as the
reference holds that pair (1e-5, metrics 5e-4). Then (d) the gradient
through ``gather_leaf`` and the all-to-all path at capacity factor 8.0
(nothing drops) against the whole tree's through ``moe_ref``, (e)
spawned gloo ranks on phase 29a's and 29b's grids against the
one-process mesh, and (f) the same ranks with the flat rows replicated
in-pod (the trainer, and the launcher's async and dynamic paths) against
one process bit for bit, every in-pod twin holding the same bits, and
the launcher's ``--mesh debug`` on 8 torchrun ranks against one process.

Tolerances:
* specs exactly;
* losses and grad norms to rtol 1e-4, parameters to ``1e-4 * (1 +
  max|p|)`` (float32 matmuls round differently in the two frameworks, and
  three AdamW steps carry it); the first step's gradients, from the
  reference's parameters, within 1e-4 of each leaf's largest. AdamW's
  first update ``lr g / (|g| + eps)`` carries the relative round-off of a
  gradient near its eps (1e-8) whole: at lr 1e-2 a few expert entries of
  moonshot leave the parameter bound, each one whose first gradient is
  below 10 eps and agrees with the reference's to its leaf's round-off
  (``test_high_lr_misses_sit_at_adamw_eps``). At the default lr that
  share is 33x smaller. The round's ``r_max`` and eta to rtol 1e-3, as
  ``tests/test_torch_trainer.py`` holds them;
* the trainer run without a mesh (``moe_ref``, nothing dropped) misses the
  reference's losses by more than 10x the loss tolerance: the fault that
  the in-pod local step repairs;
* gradients through the mesh within ``1e-5 * (1 + max|g|)`` of
  ``moe_ref``'s (float32 round-off, sums in another order);
* the ranks equal the one-process mesh bit for bit, and each holds the
  bytes its specs reckon.
"""
import json
import os

import numpy as np
import pytest
import torch

import torch_inpod_cases as cases
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_IDS
from repro_torch.distributed import MeshStats, fsdp, local_mesh, trivial_grid
from repro_torch.models import build_model
from repro_torch.models.model import arch_rules
from repro_torch.optim.adamw import AdamWConfig
from torch_round_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_round_cases import run_reference


SPEC_MESHES = ((2, 2), (2, 4), (1, 2))


def _reference_outputs():
    """The reference on eight fake CPU devices: (a) the zoo's specs, (b)
    make_train_fns on (2, 4), (c) the consensus trainer on (2, 2, 2)."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses

    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.configs import get_reduced_config
    from repro.core.penalty import PenaltyConfig
    from repro.data import DataConfig, SyntheticTokens
    from repro.distributed import sharding as shd
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import make_train_fns
    from repro.models import build_model as jbuild
    from repro.optim import ConsensusConfig, ConsensusTrainer
    from repro.optim.adamw import AdamWConfig

    out = {}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + "/" + "/".join(k.key for k in path)] = \
                np.asarray(leaf)

    def cfg(arch, cf=None):
        c = dataclasses.replace(get_reduced_config(arch), dtype="float32")
        if cf is not None and c.moe is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=cf))
        return c

    # (a) specs on meshes of the first devices
    specs = {}
    for shape in SPEC_MESHES:
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(
            shape), ("data", "model"))
        for arch in ARCH_IDS:
            c = get_reduced_config(arch)
            with shd.use_mesh(mesh, jbuild_rules(c, mesh)):
                tree = jbuild(c).param_specs()
            for path, s in jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, P))[0]:
                specs[f"{shape}/{arch}/" + "/".join(k.key for k in path)] \
                    = [list(e) if isinstance(e, tuple) else e for e in s]
    out["specs"] = np.asarray(json.dumps(specs))

    # (b) make_train_fns on (data 2, model 4)
    mesh24 = make_mesh(cases.TRAIN_MESH, ("data", "model"))
    for arch in cases.TRAIN_ARCHS:
        c = cfg(arch, cases.TRAIN_CF)
        model = jbuild(c)
        init_fn, step_fn, _, _ = make_train_fns(
            model, mesh24, AdamWConfig(), grad_rs=True)
        state = init_fn(jax.random.PRNGKey(0))
        put(f"tf/{arch}/p0", state.params)
        data = SyntheticTokens(DataConfig(vocab=c.vocab, seq_len=cases.SEQ,
                                          batch_per_node=cases.BATCH))
        batches = [jax.tree_util.tree_map(lambda x: x[0], data.batch(s))
                   for s in range(cases.TRAIN_STEPS)]
        rules = jbuild_rules(c, mesh24)

        def grad0(p, model=model, rules=rules):
            # the gradient the first step takes, as step_fn computes it
            with shd.use_mesh(mesh24, rules):
                return jax.grad(lambda q: model.loss(q, batches[0])[0])(p)
        put(f"tf/{arch}/g0", jax.jit(grad0)(state.params))
        step = jax.jit(step_fn)
        losses, norms = [], []
        for batch in batches:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"tf/{arch}/loss"] = np.asarray(losses)
        out[f"tf/{arch}/grad_norm"] = np.asarray(norms)
        put(f"tf/{arch}/p", state.params)
        if arch == cases.ARCH:
            # the same steps at lr 1e-2 (HIGH_LR)
            init_hi, step_hi, _, _ = make_train_fns(
                model, mesh24, AdamWConfig(lr=cases.HIGH_LR), grad_rs=True)
            state, step_hi = init_hi(jax.random.PRNGKey(0)), \
                jax.jit(step_hi)
            for batch in batches:
                state, _ = step_hi(state, batch)
            put(f"tf/{arch}/p_hi", state.params)

    # (c) the consensus trainer on (pod 2, data 2, model 2), the flat rows
    # sharded in-pod ("cons") and replicated in-pod ("rep", the default)
    c = cfg(cases.ARCH)
    mesh = make_mesh((2,) + cases.CONS_MESH, ("pod", "data", "model"))
    for key, shard in (("cons", True), ("rep", False)):
        tr = ConsensusTrainer(jbuild(c), mesh, adamw=AdamWConfig(lr=1e-2),
                              consensus=ConsensusConfig(
                                  penalty=PenaltyConfig(scheme="nap",
                                                        eta0=0.1),
                                  topology="ring",
                                  local_steps=cases.CONS_LOCAL,
                                  use_fused_kernel=True,
                                  shard_consensus=shard))
        state = tr.init_state(jax.random.PRNGKey(0))
        put(f"{key}/p0", jax.tree_util.tree_map(lambda x: x[0],
                                                state.params))
        data = SyntheticTokens(DataConfig(vocab=c.vocab, seq_len=32,
                                          batch_per_node=4, num_nodes=2))
        train, cons = jax.jit(tr.train_step), jax.jit(tr.consensus_step)
        losses, r_max, eta = [], [], []
        for s in range(cases.CONS_STEPS):
            state, m = train(state, data.batch(s))
            losses.append(float(m["loss"]))
            if tr.should_sync(s):
                state, cm = cons(state, data.batch(10**6 + s))
                r_max.append(float(cm["r_max"]))
                eta.append(float(cm["eta_mean"]))
        out.update({f"{key}/loss": np.asarray(losses),
                    f"{key}/r_max": np.asarray(r_max),
                    f"{key}/eta": np.asarray(eta)})
    return out


def jbuild_rules(cfg, mesh):
    from repro.models.model import arch_rules as jarch_rules
    return jarch_rules(cfg, mesh)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference("test_torch_inpod", tmp_path_factory)


def _tol(want):
    return 1e-4 * (1 + float(np.abs(want).max()))


# ----------------------------------------------------------- (a) specs ----
@pytest.mark.parametrize("shape", SPEC_MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(ref, arch, shape):
    """Every leaf's spec under ``arch_rules`` equals the reference's
    ``spec_tree``: on (2, 2), on (2, 4), where ``model`` 4 does not divide
    two kv heads and the rules drop them, and on (1, 2)."""
    pre = f"{shape}/{arch}/"
    want = {k[len(pre):]: v
            for k, v in json.loads(str(ref["specs"])).items()
            if k.startswith(pre)}
    from repro_torch.configs import get_reduced_config
    c = get_reduced_config(arch)
    mesh = local_mesh(*shape, "cpu")
    got = cases.spec_json(build_model(c).param_specs(arch_rules(c, mesh)))
    assert want and got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cut_and_join_round_trip(arch):
    """Every rank's shards of a whole tree on a (2, 4) mesh have the shapes
    ``make_train_fns``' ``state_shardings`` gives, and join back into the
    whole tree exactly."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.steps import make_train_fns
    from repro_torch.optim.adamw import AdamWConfig
    model = build_model(get_reduced_config(arch))
    mesh = local_mesh(2, 4, "cpu")
    whole = model.init(torch.Generator().manual_seed(0), "cpu")
    specs, _ = fsdp.specs_for(model, mesh)
    parts = {c: fsdp.cut(whole, specs, mesh, c) for c in mesh.all_coords()}
    shardings = make_train_fns(model, mesh, AdamWConfig())[3]()
    for part in parts.values():
        for x, sh in zip(tree_lib.leaves(part), tree_lib.leaves(
                shardings.params, is_leaf=lambda v: hasattr(v, "spec")),
                strict=True):
            assert tuple(x.shape) == sh.shard_shape
    for a, b in zip(tree_lib.leaves(fsdp.join(parts, specs, mesh)),
                    tree_lib.leaves(whole), strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------- (b) make_train_fns ----
@pytest.fixture(scope="module")
def train_runs(ref):
    """The port's make_train_fns on the one-process (2, 4) mesh, from the
    reference's initial parameters, for each arch."""
    out = {}
    for arch in cases.TRAIN_ARCHS:
        stats = MeshStats()
        out[arch] = cases.run_train(
            local_mesh(*cases.TRAIN_MESH, "cpu", stats=stats), arch,
            cases.TRAIN_CF, params=cases.params_from(ref, f"tf/{arch}/p0"),
            stats=stats)
    return out


@pytest.mark.parametrize("arch", cases.TRAIN_ARCHS)
def test_train_fns_losses_match_reference(ref, train_runs, arch):
    """Losses and grad norms of 3 steps to rtol 1e-4; on moonshot the
    all-to-all path dropped pairs in every step (``MeshStats``)."""
    got = train_runs[arch]
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(
            torch.stack(got[name]).numpy(), ref[f"tf/{arch}/{name}"],
            rtol=1e-4, err_msg=name)
    if arch == cases.ARCH:
        assert all(n > 0 for n in got["dropped"]), got["dropped"]


@pytest.mark.parametrize("arch", cases.TRAIN_ARCHS)
def test_train_fns_params_match_reference(ref, train_runs, arch):
    """The parameters after 3 steps, leaf by leaf."""
    got = train_runs[arch]["params"]
    want = cases.np_tree(ref, f"tf/{arch}/p")
    for path, x in tree_lib.leaves_with_paths(got):
        w = want["/".join(path)]
        np.testing.assert_allclose(x.numpy(), w, rtol=0, atol=_tol(w),
                                   err_msg="/".join(path))


@pytest.mark.parametrize("arch", cases.TRAIN_ARCHS)
def test_first_step_gradients_match_reference(ref, arch):
    """The gradients of the first step, at the reference's initial
    parameters, through the one-process (2, 4) mesh at capacity factor 1.0
    (moonshot drops pairs), against the reference's ``jax.grad`` of the
    same loss under its mesh: every leaf within 1e-4 of its largest
    gradient. A pair dropped on one side only would move its expert's
    gradient by that token's whole share, far past this bound: the two
    drop the same pairs."""
    g = cases.first_grads(ref, arch)
    want = cases.np_tree(ref, f"tf/{arch}/g0")
    for path, x in tree_lib.leaves_with_paths(g):
        w = want["/".join(path)]
        np.testing.assert_allclose(x.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg="/".join(path))


def test_high_lr_misses_sit_at_adamw_eps(ref):
    """Why (b) runs at the default lr: at lr 1e-2 three steps of moonshot
    leave a few expert entries outside (b)'s parameter bound, and only
    entries whose first gradient is below 10x AdamW's eps (1e-8), where the
    first update ``lr g / (|g| + eps)`` carries the gradient's relative
    round-off whole; there the port's first gradient is within its leaf's
    f32 round-off (the bound above) of the reference's."""
    eps = AdamWConfig().eps
    got = cases.run_train(local_mesh(*cases.TRAIN_MESH, "cpu"), cases.ARCH,
                          cases.TRAIN_CF, lr=cases.HIGH_LR,
                          params=cases.params_from(ref,
                                                   f"tf/{cases.ARCH}/p0"))
    g = dict(tree_lib.leaves_with_paths(cases.first_grads(ref, cases.ARCH)))
    want = cases.np_tree(ref, f"tf/{cases.ARCH}/p_hi")
    g0 = cases.np_tree(ref, f"tf/{cases.ARCH}/g0")
    misses = 0
    for path, x in tree_lib.leaves_with_paths(got["params"]):
        name = "/".join(path)
        w = want[name]
        out = np.abs(x.numpy() - w) > _tol(w)
        misses += int(out.sum())
        gw = g0[name][out]
        assert (np.abs(gw) < 10 * eps).all(), (name, gw)
        assert (np.abs(g[path].numpy()[out] - gw)
                <= 1e-4 * np.abs(g0[name]).max()).all(), name
    assert misses <= 8, misses


# ------------------------------------------------- (c) consensus trainer ----
def _cons_port(ref, grid, key="cons", shard=None):
    out = cases.run_consensus(grid, params=cases.params_from(ref, f"{key}/p0"),
                              shard=shard)
    return {k: torch.stack(v).numpy() if isinstance(v, list)
            and k != "replicated" else v for k, v in out.items()}


@pytest.fixture(scope="module")
def cons_runs(ref):
    """The port's J 2 runs on the trivial grid with a (2, 2) in-pod mesh
    from the reference's initial parameters: the flat rows sharded in-pod
    (``cons``) and replicated in-pod (``rep``)."""
    grid = trivial_grid(2, "cpu", mesh=cases.CONS_MESH)
    return {"cons": _cons_port(ref, grid, "cons", shard=True),
            "rep": _cons_port(ref, grid, "rep", shard=False)}


def _match_reference(ref, got, key):
    np.testing.assert_allclose(got["loss"], ref[f"{key}/loss"], rtol=1e-4)
    np.testing.assert_allclose(got["r_max"], ref[f"{key}/r_max"],
                               rtol=1e-3)
    np.testing.assert_allclose(got["eta"], ref[f"{key}/eta"], rtol=1e-3)


def test_consensus_trainer_matches_reference(ref, cons_runs):
    """J 2 on the trivial grid with S 4 on a (2, 2) in-pod mesh, the flat
    rows sharded in-pod: the local step and the probes take the
    all-to-all path and drop as the reference's (losses rtol 1e-4, r_max
    and eta rtol 1e-3)."""
    _match_reference(ref, cons_runs["cons"], "cons")


def test_replicated_trainer_matches_reference(ref, cons_runs):
    """The same with the flat rows replicated in-pod, against the
    reference's ``shard_consensus=False`` trainer, at the same
    tolerances."""
    _match_reference(ref, cons_runs["rep"], "rep")


def test_replicated_matches_sharded(ref, cons_runs):
    """The replicated in-pod run against the sharded one, as the
    reference's ``test_sharded_matches_unsharded_all_schemes`` holds its
    pair: parameters, duals and neighbour means within 1e-5, the residual
    metrics within 5e-4 relative (the sharded layout's padding cuts the
    row's blocks elsewhere, so its partials sum in another order)."""
    assert np.array_equal(ref["cons/p0/embed"], ref["rep/p0/embed"])
    rep, sh = cons_runs["rep"], cons_runs["cons"]
    for name in ("params", "m", "v"):
        for (path, a), b in zip(tree_lib.leaves_with_paths(rep[name]),
                                tree_lib.leaves(sh[name]), strict=True):
            assert float((a - b).abs().max()) <= 1e-5, (name, path)
    lay = _layouts()
    for name in ("lam", "bar"):
        a = lay["whole"].unpack(rep[name])
        b = lay["sharded"].unpack(sh[name])
        for (path, x), y in zip(tree_lib.leaves_with_paths(a),
                                tree_lib.leaves(b), strict=True):
            assert float((x - y).abs().max()) <= 1e-5, (name, path)
    for name in ("r_max", "s_max", "f_mean", "eta"):
        np.testing.assert_allclose(rep[name], sh[name], rtol=5e-4,
                                   err_msg=name)
    np.testing.assert_allclose(rep["loss"], sh["loss"], rtol=1e-5)


def _layouts():
    """The whole row's flat layout of the run's model and the S 4 sharded
    one (``lam`` and ``bar`` of each run unpack by theirs)."""
    from repro_torch.optim import flatten
    defs = build_model(cases.cfg()).param_defs()
    bs = flatten.auto_block_size(defs)
    return {"whole": flatten.FlatLayout.for_tree(defs, block_size=bs,
                                                 node_axis=False),
            "sharded": flatten.FlatLayout.for_tree(defs, block_size=bs,
                                                   node_axis=False,
                                                   shards=4)}


def test_consensus_trainer_without_mesh_misses_reference(ref):
    """The same run without an in-pod mesh (``moe_ref``, nothing dropped)
    misses the reference's losses by more than 10x the loss tolerance."""
    got = _cons_port(ref, trivial_grid(2, "cpu"))
    rel = np.abs(got["loss"] / ref["cons/loss"] - 1).max()
    assert rel > 10 * 1e-4, rel


# ----------------------------------------------------------- (d) grads ----
@pytest.fixture(scope="module")
def whole_grads():
    return cases.grads_on(None)


def test_gradients_one_process_mesh_match_moe_ref(whole_grads):
    """The all-to-all path's backward on the one-process (2, 2) mesh at
    capacity factor 8.0 equals ``moe_ref``'s gradient to f32 round-off."""
    loss, grads = cases.grads_on(local_mesh(2, 2, "cpu"))
    want_loss, want = whole_grads
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    for (path, g), w in zip(tree_lib.leaves_with_paths(grads),
                            tree_lib.leaves(want), strict=True):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * (1 + np.abs(w).max()),
                                   err_msg="/".join(path))


# ----------------------------------------------------------- (e) ranks ----
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of 4 gloo ranks per test run (the xdist workers share it
    under a file lock, as ``run_reference`` shares the reference): phase
    29a's grid, then 29b's, then the replicated in-pod grid and the
    resume cases (``torch_inpod_cases.ranks_worker``)."""
    return cases.spawned_ranks(tmp_path_factory)[1]


def test_gradients_through_gather_leaf_match_moe_ref(ranks, whole_grads):
    """The gradients the 4 ranks hold (``gather_leaf``'s reduce-scatter,
    the all-to-all's backward, at capacity factor 8.0) joined equal
    ``moe_ref``'s whole gradient to f32 round-off."""
    model = build_model(cases.cfg(cases.ARCH, cases.GRAD_CF))
    mesh = local_mesh(*cases.RANKS_TRAIN_MESH, "cpu")
    specs, _ = fsdp.specs_for(model, mesh)
    joined = fsdp.join({r["train_coords"]: r["grad"]["grads"]
                        for r in ranks}, specs, mesh)
    want_loss, want = whole_grads
    for r in ranks:
        assert abs(float(r["grad"]["loss"]) - float(want_loss)) \
            <= 1e-5 * float(want_loss)
    for (path, g), w in zip(tree_lib.leaves_with_paths(joined),
                            tree_lib.leaves(want), strict=True):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * (1 + np.abs(w).max()),
                                   err_msg="/".join(path))


@pytest.fixture(scope="module")
def train_one_process():
    stats = MeshStats()
    return cases.run_train(local_mesh(*cases.RANKS_TRAIN_MESH, "cpu",
                                      stats=stats),
                           cases.ARCH, cases.TRAIN_CF, stats=stats)


@pytest.fixture(scope="module")
def cons_one_process():
    return cases.run_consensus(trivial_grid(2, "cpu",
                                            mesh=cases.RANKS_CONS_MESH))


def test_train_ranks_equal_one_process(ranks, train_one_process):
    """Phase 29a's grid at reduced size: every rank's losses, grad norms,
    drops, parameter and moment shards equal the one-process (2, 2)
    mesh's bit for bit."""
    cases.assert_train_ranks_equal(ranks, train_one_process)


def test_consensus_ranks_equal_one_process(ranks, cons_one_process):
    """Phase 29b's grid at reduced size (J 2, data 1 x model 2 a node, 4
    ranks, shard_consensus): every rank's losses, round metrics, penalty,
    flat slabs and parameter and moment shards equal one process on the
    trivial grid bit for bit."""
    cases.assert_cons_ranks_equal(ranks, cons_one_process)


@pytest.mark.parametrize("run", ("train", "cons"))
def test_rank_holds_only_its_shards(ranks, run):
    """Each rank's parameter and moment bytes equal its shards' bytes as
    the specs reckon them (``fsdp.shard_bytes``): 1/S of the node's, apart
    from the replicated leaves."""
    shape = cases.RANKS_TRAIN_MESH if run == "train" \
        else cases.RANKS_CONS_MESH
    model = build_model(cases.cfg(cases.ARCH))
    mesh = local_mesh(*shape, "cpu")
    want = fsdp.shard_bytes(model, mesh)
    whole = sum(x.numel() * x.element_size() for x in tree_lib.leaves(
        model.init(torch.Generator().manual_seed(0), "cpu")))
    for r in ranks:
        got = r[run]
        assert cases.tensor_bytes(got["params"]) == want["params"]
        assert cases.tensor_bytes(got["m"]) + cases.tensor_bytes(got["v"]) \
            == want["moments"]
        assert want["params"] < whole / mesh.size * 1.2


def test_node_ring_sharded_equals_replicated():
    """The node ring of the sharded path (J 2 on the trivial grid with a
    data 1 x model 2 in-pod mesh, reduced qwen3-4b: dense, so the local
    step differs from the replicated run's by round-off only) holds the
    replicated run's per-node residuals, probes and penalties (rtol 1e-4),
    as the reference's
    ``tests/test_obs.py::test_node_residuals_sharded_equals_replicated``."""
    arch = "qwen3-4b"
    sharded = cases.run_consensus(trivial_grid(2, "cpu",
                                               mesh=cases.RANKS_CONS_MESH),
                                  obs=True, arch=arch)
    replicated = cases.run_consensus(trivial_grid(2, "cpu"), obs=True,
                                     arch=arch)
    from repro_torch.obs.schema import NODE_COLUMN_INDEX
    a, b = sharded["node_ring"], replicated["node_ring"]
    assert a.shape == b.shape
    # the residuals, probes and penalties; the wire bytes differ by the
    # sharded layout's padding
    cols = [NODE_COLUMN_INDEX[k] for k in ("r", "s", "f_local",
                                           "eta_row_mean", "alive")]
    assert bool((b[..., cols[0]] > 0).any())
    np.testing.assert_allclose(a[..., cols].numpy(), b[..., cols].numpy(),
                               rtol=1e-4, atol=1e-6)


def test_mesh_refusals():
    """A world that is not J x data x model, S > 1 ranks a node with
    neither an in-pod mesh nor the sharded consensus state (the reference
    has no such grid), a trainer whose ``shard_consensus`` disagrees with
    its grid's rows, and the launcher's ``--mesh prod`` are refused; an
    in-pod mesh without ``--shard-consensus`` is the replicated grid, and
    ``--mesh debug`` gives data 2 x model 2 with or without it."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.optim import ConsensusConfig, ConsensusTrainer
    grid = init_ranks(2, "cpu", mesh=(1, 2))
    assert grid.mesh is not None and grid.shards == 2 and not grid.holds_slab
    with pytest.raises(ValueError, match="needs 8 ranks"):
        init_ranks(2, "cpu", backend="gloo", world_size=4, rank=0,
                   shard_consensus=True, mesh=(2, 2))
    with pytest.raises(ValueError, match="needs 8 ranks"):
        init_ranks(2, "cpu", backend="gloo", world_size=4, rank=0,
                   mesh=(2, 2))
    with pytest.raises(ValueError, match="not a multiple of the world"):
        init_ranks(2, "cpu", world_size=4, rank=0)
    model = build_model(cases.cfg("qwen3-4b"))
    with pytest.raises(ValueError, match="no in-pod mesh"):
        ConsensusTrainer(model, num_nodes=2, device="cpu",
                         adamw=AdamWConfig(), consensus=ConsensusConfig(),
                         ranks=trivial_grid(2, "cpu", shards=2))
    from repro_torch.distributed import RankGrid
    rep = RankGrid(world=4, rank=0, local_rank=0, nodes_per_rank=1,
                   node_lo=0, node_hi=1, device=torch.device("cpu"),
                   backend="gloo", group=object(), shards=2, shard=0,
                   inpod_group=object(), shard_group=object(),
                   mesh=local_mesh(1, 2, "cpu"), replicated=True)
    assert not rep.holds_slab
    with pytest.raises(ValueError, match="shard_consensus is True"):
        ConsensusTrainer(model, num_nodes=2, device="cpu",
                         adamw=AdamWConfig(), ranks=rep,
                         consensus=ConsensusConfig(shard_consensus=True))
    with pytest.raises(SystemExit):
        train.parse_args(["--mesh", "prod"])
    for extra in ([], ["--shard-consensus"]):
        assert train.inpod_mesh(train.parse_args(
            ["--mesh", "debug"] + extra)) == (2, 2)
    assert train.inpod_mesh(train.parse_args([])) is None


# ----------------------------------------- (f) replicated in-pod state ----
@pytest.fixture(scope="module")
def rep_one_process():
    return cases.run_consensus(trivial_grid(2, "cpu",
                                            mesh=cases.RANKS_CONS_MESH),
                               obs=True, shard=False)


def test_replicated_ranks_equal_one_process(ranks, rep_one_process):
    """The flat rows replicated in-pod on 4 ranks (J 2, data 1 x model 2 a
    node): every rank's losses, round metrics, its pod's whole flat rows,
    the replicated leaves (the penalties, the step, the topology state and
    the rings) and its parameter and moment shards equal one process on
    ``trivial_grid(2, mesh=(1, 2))`` bit for bit."""
    cases.assert_rep_ranks_equal(ranks, rep_one_process)


def test_inpod_twins_hold_identical_bits(ranks):
    """The two in-pod ranks of each pod hold the same bits of lam,
    theta_bar_prev, the ledger rows and every replicated leaf, in the
    consensus trainer's run and in each of the launcher's paths."""
    for pod in range(2):
        a, b = ranks[2 * pod], ranks[2 * pod + 1]
        runs = [(a["rep"], b["rep"])] + [(a["paths"][n], b["paths"][n])
                                         for n in cases.PATH_RUNS]
        for x, y in runs:
            for name in ("lam", "bar"):
                assert torch.equal(x[name], y[name]), (pod, name)
            if x.get("ledger") is not None:
                assert torch.equal(x["ledger"], y["ledger"]), pod
            assert len(x["replicated"]) == len(y["replicated"]) > 0
            for u, v in zip(x["replicated"], y["replicated"]):
                assert torch.equal(u, v), pod


@pytest.mark.parametrize("name", list(cases.PATH_RUNS))
def test_replicated_paths_ranks_equal_one_process(ranks, name, tmp_path):
    """The launcher on the replicated in-pod grid with the async executor
    (pipelined, int8 wire, a slow node) and with the dynamic gated round
    (fp8 wire), obs rings on: every rank's losses and round metrics, its
    pod's flat and ledger rows and the replicated leaves equal one process
    on ``trivial_grid(2, mesh=(1, 2))`` bit for bit."""
    record, state = cases.traced_run(
        cases.cfg(cases.PATH_ARCH),
        cases.path_args(name, "cpu", str(tmp_path / "obs")),
        trivial_grid(2, "cpu", mesh=cases.RANKS_CONS_MESH))
    want = dict(cases.record_numbers(record), **cases.state_rows(state))
    assert want["rounds"] and want["replicated"]
    for rank, r in enumerate(ranks):
        got, pod = r["paths"][name], rank // 2
        assert got["losses"] == want["losses"], rank
        assert got["rounds"] == want["rounds"], rank
        for key in ("lam", "bar"):
            assert torch.equal(got[key], want[key][pod:pod + 1]), key
        if want["ledger"] is not None:
            assert torch.equal(got["ledger"], want["ledger"][:, pod:pod + 1])
        for u, v in zip(got["replicated"], want["replicated"], strict=True):
            assert torch.equal(u, v), rank


def test_launcher_mesh_debug_without_shard_consensus_under_torchrun(capsys):
    """The launcher's ``--mesh debug`` with the flat rows replicated
    in-pod (no ``--shard-consensus``) on J 2 x data 2 x model 2 = 8 gloo
    ranks under torchrun prints the same losses and round metrics as one
    process computing the run whole; rank 0 alone prints."""
    import re
    import subprocess
    import sys

    from repro_torch.launch.train import main
    from torch_round_cases import SRC
    argv = ["--arch", "moonshot-v1-16b-a3b", "--reduced", "--nodes", "2",
            "--mesh", "debug", "--steps", "4", "--local-steps", "2",
            "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", "-m", "repro_torch.launch.train"] + argv,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert main(argv) == 0
    one = capsys.readouterr().out
    line = re.compile(r"^step +\d+ loss \S+(?: \| consensus r=\S+ "
                      r"eta=\S+)?", re.M)
    ranked = line.findall(proc.stdout)
    assert ranked == line.findall(one) and len(ranked) == 4
    assert sum("consensus r=" in x for x in ranked) == 2
    assert proc.stdout.count("done: 4 steps") == 1
