"""Cases of ``tests/test_torch_inpod.py`` and of the card's
``test_cuda_inpod_gloo_ranks_equal_one_process``: the in-pod sharded local
step (``distributed.fsdp``) through ``launch.steps.make_train_fns`` and the
consensus trainer, at reduced size, and the worker of the spawned gloo
ranks (each on one torch thread, joined through a ``file://`` store). This
module imports no JAX."""
import dataclasses
import os

import numpy as np
import torch

from repro_torch import tree as tree_lib

ARCH = "moonshot-v1-16b-a3b"
TRAIN_ARCHS = ("qwen3-4b", ARCH)
TRAIN_MESH = (2, 4)             # make_train_fns against the reference
TRAIN_STEPS = 3
TRAIN_CF = 1.0                  # the MoE's capacity factor there: drops
HIGH_LR = 1e-2                  # why make_train_fns runs at the default lr
BATCH, SEQ = 4, 16              # make_train_fns' global batch
# the consensus trainer against the reference: J 2 on (pod 2, data 2,
# model 2), reduced moonshot in f32 at its own capacity factor (1.25)
CONS_MESH = (2, 2)
CONS_STEPS = 4
CONS_LOCAL = 2
# the ranks' grids: phase 29a's (make_train_fns, data 2 x model 2) and
# 29b's (the consensus trainer, J 2 ring, data 1 x model 2 a node)
RANKS_TRAIN_MESH = (2, 2)
RANKS_CONS_MESH = (1, 2)
GRAD_CF = 8.0                   # nothing drops: the EP gradient is moe_ref's


def cfg(arch: str = ARCH, cf: float | None = None):
    """The reduced config in float32 (with capacity factor ``cf``)."""
    from repro_torch.configs import get_reduced_config
    c = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    if cf is not None and c.moe is not None:
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf))
    return c


def train_batch(vocab: int, step: int, device="cpu") -> dict:
    """make_train_fns' global batch of ``step``: one node's
    ``SyntheticTokens`` rows [BATCH, SEQ], as the reference draws them."""
    from repro_torch.data import DataConfig, SyntheticTokens
    data = SyntheticTokens(DataConfig(vocab=vocab, seq_len=SEQ,
                                      batch_per_node=BATCH), device=device)
    return {k: v[0] for k, v in data.batch(step).items()}


def params_from(flat: dict, prefix: str, device="cpu") -> dict:
    """The tree stored under ``prefix/`` in a flat npz dict."""
    from repro_torch.models.params import from_jax
    return from_jax(tree_lib.from_flat(flat, prefix, lambda a: a), device)


def run_train(mesh, arch: str, cf: float, params=None, device="cpu",
              steps: int = TRAIN_STEPS, stats=None,
              lr: float | None = None) -> dict:
    """``make_train_fns`` on ``mesh``: ``steps`` AdamW steps (the default
    ``AdamWConfig``, lr 3e-4, or ``lr``) from ``params`` (a whole tree; on
    a rank cut to its shards) or the draw of seed 0. Returns the losses
    and grad norms, this process's final parameters and moments (a rank's
    shards) and, with a mesh, the drops per step."""
    from repro_torch.distributed import fsdp
    from repro_torch.launch.steps import make_train_fns
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    c = cfg(arch, cf)
    model = build_model(c)
    acfg = AdamWConfig() if lr is None else AdamWConfig(lr=lr)
    init, step, _, shardings = make_train_fns(model, mesh, acfg)
    state = init(torch.Generator(device).manual_seed(0), device)
    if params is not None:
        if not mesh.local:
            specs, _ = fsdp.specs_for(model, mesh)
            params = fsdp.cut(params, specs, mesh, mesh.coords)
        for dst, src in zip(tree_lib.leaves(state.params),
                            tree_lib.leaves(params), strict=True):
            dst.copy_(src)
    out = {"loss": [], "grad_norm": [], "dropped": []}
    for s in range(steps):
        if stats is not None:
            stats.clear()
        state, m = step(state, train_batch(c.vocab, s, device))
        out["loss"].append(m["loss"])
        out["grad_norm"].append(m["grad_norm"])
        if stats is not None:
            out["dropped"].append(int(sum(int(d.sum())
                                          for d in stats.dropped)))
    out["params"] = state.params
    out["m"], out["v"] = state.opt.m, state.opt.v
    out["shardings"] = shardings()
    return out


def first_grads(ref: dict, arch: str) -> dict:
    """The whole tree's gradients of ``make_train_fns``' first step on the
    one-process ``TRAIN_MESH`` at ``TRAIN_CF``, at the reference's initial
    parameters (``tf/<arch>/p0`` of its record)."""
    from repro_torch.distributed import fsdp, local_mesh
    from repro_torch.models import build_model
    c = cfg(arch, TRAIN_CF)
    model = build_model(c)
    mesh = local_mesh(*TRAIN_MESH, "cpu")
    _, gspecs = fsdp.specs_for(model, mesh)
    return fsdp.loss_and_grads(model, mesh, params_from(ref, f"tf/{arch}/p0"),
                               train_batch(c.vocab, 0), gspecs)[1]


def grads_on(mesh, device="cpu"):
    """The node's loss and gradients at ``GRAD_CF`` (nothing drops) under
    ``mesh`` (a rank: its shards' gradients) or, with None, the whole
    tree's through ``moe_ref``; from the draw of seed 0, the batch of step
    0."""
    from repro_torch.distributed import fsdp
    from repro_torch.models import build_model
    c = cfg(ARCH, GRAD_CF)
    model = build_model(c)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    batch = train_batch(c.vocab, 0, device)
    if mesh is None:
        pl = tree_lib.leaves_with_paths(params)
        xs = [x.requires_grad_() for _, x in pl]
        loss, _ = model.loss(tree_lib.unflatten([p for p, _ in pl], xs),
                             batch)
        g = torch.autograd.grad(loss, xs)
        return loss.detach(), tree_lib.unflatten([p for p, _ in pl], list(g))
    specs, gspecs = fsdp.specs_for(model, mesh)
    if not mesh.local:
        params = fsdp.cut(params, specs, mesh, mesh.coords)
    return fsdp.loss_and_grads(model, mesh, params, batch, gspecs)


def run_consensus(grid, params=None, device="cpu", steps: int = CONS_STEPS,
                  obs: bool = False, arch: str = ARCH) -> dict:
    """The consensus trainer (J 2 ring, nap, native wire, local_steps 2,
    reduced ``arch`` in f32 at its own capacity factor) on the rank
    ``grid`` (a ``trivial_grid`` for one process); from ``params`` (whole)
    or the draw of seed 0. Returns the per-step losses, the rounds'
    ``r_max`` and ``eta_mean``, this rank's final parameter and moment
    rows, its flat consensus rows, the replicated penalty, and with
    ``obs`` the node ring."""
    from repro_torch.core.penalty import PenaltyConfig
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.obs import ObsConfig
    from repro_torch.optim import ConsensusConfig, ConsensusTrainer
    from repro_torch.optim.adamw import AdamWConfig
    c = cfg(arch)
    model = build_model(c)
    j = 2
    tr = ConsensusTrainer(
        model, num_nodes=j, device=device, adamw=AdamWConfig(lr=1e-2),
        ranks=grid, consensus=ConsensusConfig(
            penalty=PenaltyConfig(scheme="nap", eta0=0.1), topology="ring",
            local_steps=CONS_LOCAL, shard_consensus=grid.shards > 1,
            obs=ObsConfig(ring_capacity=8) if obs else None))
    data = SyntheticTokens(DataConfig(vocab=c.vocab, seq_len=32,
                                      batch_per_node=4, num_nodes=j),
                           device=device,
                           nodes=(grid.node_lo, grid.node_hi))
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(0), device)
    state = tr.init_state(params)
    out = {"loss": [], "r_max": [], "eta": []}
    for s in range(steps):
        state, m = tr.train_step(state, data.batch(s))
        out["loss"].append(m["loss"])
        if tr.should_sync(s):
            state, cm = tr.consensus_step(state, data.batch(10**6 + s))
            out["r_max"].append(cm["r_max"])
            out["eta"].append(cm["eta_mean"])
    out["params"], out["m"] = state.params, state.opt.m
    out["v"] = state.opt.v
    out["lam"], out["bar"] = state.lam, state.theta_bar_prev
    out["penalty"] = state.penalty.eta
    out["node_ring"] = None if state.node_ring is None \
        else state.node_ring.buf
    return out


def tensor_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_lib.leaves(tree))


def ranks_worker(rank, world, store, out_dir, device="cpu"):
    """One rank of two runs, each on its own process group: (1)
    ``make_train_fns`` on a ``RANKS_TRAIN_MESH`` mesh of ``world`` ranks,
    then its gradients at ``GRAD_CF``; (2) the consensus trainer, J 2 with
    a ``RANKS_CONS_MESH`` in-pod mesh (``world`` = 2 x S ranks). Saves
    this rank's outputs (on the CPU) as ``rank<r>.pt``."""
    from repro_torch.distributed import MeshStats
    from repro_torch.launch.mesh import init_mesh, init_ranks
    torch.set_num_threads(1)
    mesh = init_mesh(*RANKS_TRAIN_MESH, device, backend="gloo",
                     init_method=f"file://{store}.train", world_size=world,
                     rank=rank, stats=MeshStats())
    train = run_train(mesh, ARCH, TRAIN_CF, device=mesh.device,
                      stats=mesh.stats)
    loss, grads = grads_on(mesh, mesh.device)
    coords = mesh.coords
    mesh.close()
    grid = init_ranks(2, device, backend="gloo",
                      init_method=f"file://{store}.cons", world_size=world,
                      rank=rank, shard_consensus=True, mesh=RANKS_CONS_MESH)
    cons = run_consensus(grid, device=grid.device)
    cons_coords = grid.mesh.coords
    grid.close()
    cpu = lambda t: tree_lib.tree_map(lambda x: x.detach().cpu(), t) \
        if isinstance(t, dict) else t
    train = {k: cpu(v) if k != "shardings" else v
             for k, v in train.items()}
    train["loss"] = torch.stack(train["loss"]).cpu()
    train["grad_norm"] = torch.stack(train["grad_norm"]).cpu()
    out = {"train": train, "train_coords": coords,
           "grad": {"loss": loss.cpu(), "grads": cpu(grads)},
           "cons": {k: (torch.stack(v).cpu() if isinstance(v, list)
                        else cpu(v) if isinstance(v, dict)
                        else v.cpu() if v is not None else None)
                    for k, v in cons.items()},
           "cons_coords": cons_coords}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def spec_json(specs) -> dict:
    """``{"path/to/leaf": [entry, ...]}`` of a spec tree (a tuple entry as
    a list)."""
    return {"/".join(p): [list(e) if isinstance(e, tuple) else e for e in s]
            for p, s in tree_lib.leaves_with_paths(
                specs, is_leaf=lambda x: isinstance(x, tuple))}


def np_tree(flat: dict, prefix: str) -> dict:
    """``{key: array}`` entries of a tree stored under ``prefix/``."""
    return {k[len(prefix) + 1:]: v for k, v in flat.items()
            if k.startswith(prefix + "/")}


def leaves_np(tree) -> list[np.ndarray]:
    return [x.detach().cpu().numpy() for x in tree_lib.leaves(tree)]


def _host(tree):
    return tree_lib.tree_map(lambda x: x.detach().cpu(), tree)


def assert_train_ranks_equal(ranks, want) -> None:
    """The ranks' 29a outputs (``ranks_worker``) against the one-process
    ``run_train`` on the ``RANKS_TRAIN_MESH`` mesh, bit for bit; every
    step dropped pairs, each rank its own shard's."""
    from repro_torch.distributed import fsdp, local_mesh
    from repro_torch.models import build_model
    model = build_model(cfg(ARCH, TRAIN_CF))
    mesh = local_mesh(*RANKS_TRAIN_MESH, "cpu")
    specs, _ = fsdp.specs_for(model, mesh)
    for r in ranks:
        got, c = r["train"], r["train_coords"]
        assert torch.equal(got["loss"], torch.stack(want["loss"]).cpu())
        assert torch.equal(got["grad_norm"],
                           torch.stack(want["grad_norm"]).cpu())
        for name in ("params", "m", "v"):
            cut = fsdp.cut(_host(want[name]), specs, mesh, c)
            for a, b in zip(tree_lib.leaves(got[name]),
                            tree_lib.leaves(cut), strict=True):
                assert torch.equal(a, b), (c, name)
    per_rank = [r["train"]["dropped"] for r in ranks]
    assert [sum(x) for x in zip(*per_rank)] == want["dropped"]
    assert all(n > 0 for n in want["dropped"]), want["dropped"]


def assert_cons_ranks_equal(ranks, want) -> None:
    """The ranks' 29b outputs against the one-process ``run_consensus`` on
    ``trivial_grid(2, mesh=RANKS_CONS_MESH)``, bit for bit."""
    from repro_torch.distributed import fsdp, local_mesh
    from repro_torch.models import build_model
    model = build_model(cfg(ARCH))
    mesh = local_mesh(*RANKS_CONS_MESH, "cpu")
    specs, _ = fsdp.specs_for(model, mesh)
    s = mesh.size
    lam, bar = want["lam"].cpu(), want["bar"].cpu()
    for rank, r in enumerate(ranks):
        got = r["cons"]
        pod, shard = divmod(rank, s)
        for name in ("loss", "r_max", "eta"):
            assert torch.equal(got[name], torch.stack(want[name]).cpu()), \
                name
        assert torch.equal(got["penalty"], want["penalty"].cpu())
        n = lam.shape[1] // s
        assert torch.equal(got["lam"][0], lam[pod, shard * n:(shard + 1) * n])
        assert torch.equal(got["bar"][0], bar[pod, shard * n:(shard + 1) * n])
        for name in ("params", "m", "v"):
            node = tree_lib.tree_map(lambda x: x[pod].cpu(), want[name])
            cut = fsdp.cut(node, specs, mesh, r["cons_coords"])
            for a, b in zip(tree_lib.leaves(got[name]),
                            tree_lib.leaves(cut), strict=True):
                assert torch.equal(a[0], b), (rank, name)
