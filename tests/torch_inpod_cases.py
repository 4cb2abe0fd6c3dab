"""Cases of ``tests/test_torch_inpod.py``, ``tests/test_torch_checkpoint.py``
and of the card's ``test_cuda_inpod_*``, ``test_cuda_replicated_*`` and
``test_cuda_resume_*``: the in-pod sharded local step
(``distributed.fsdp``) through ``launch.steps.make_train_fns`` and the
consensus trainer, with the flat rows in slabs or replicated in-pod, the
launcher's round paths on the replicated grid and its checkpoint/resume
on three grids, at reduced size, and the worker of the spawned gloo ranks
(each on one torch thread, joined through a ``file://`` store). This
module imports no JAX."""
import dataclasses
import os
from typing import Any

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
                  obs: bool = False, arch: str = ARCH,
                  shard: bool | None = None) -> dict:
    """The consensus trainer (J 2 ring, nap, native wire, local_steps 2,
    reduced ``arch`` in f32 at its own capacity factor) on the rank
    ``grid`` (a ``trivial_grid`` for one process); from ``params`` (whole)
    or the draw of seed 0; the flat rows in slabs with ``shard`` (by
    default when the grid has S > 1 ranks a node and does not replicate
    them). Returns the per-step losses, the rounds' ``r_max``,
    ``eta_mean``, ``s_max`` and ``f_mean``, this rank's final parameter
    and moment rows, its flat consensus rows, the replicated penalty and
    topology state, and with ``obs`` the rings."""
    if shard is None:
        shard = grid.shards > 1 and not grid.replicated
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
            local_steps=CONS_LOCAL, shard_consensus=shard,
            obs=ObsConfig(ring_capacity=8) if obs else None))
    data = SyntheticTokens(DataConfig(vocab=c.vocab, seq_len=32,
                                      batch_per_node=4, num_nodes=j),
                           device=device,
                           nodes=(grid.node_lo, grid.node_hi))
    if params is None:
        params = model.init(torch.Generator(device).manual_seed(0), device)
    state = tr.init_state(params)
    out = {"loss": [], "r_max": [], "eta": [], "s_max": [], "f_mean": []}
    for s in range(steps):
        state, m = tr.train_step(state, data.batch(s))
        out["loss"].append(m["loss"])
        if tr.should_sync(s):
            state, cm = tr.consensus_step(state, data.batch(10**6 + s))
            out["r_max"].append(cm["r_max"])
            out["eta"].append(cm["eta_mean"])
            out["s_max"].append(cm["s_max"])
            out["f_mean"].append(cm["f_mean"])
    out["params"], out["m"] = state.params, state.opt.m
    out["v"] = state.opt.v
    out["lam"], out["bar"] = state.lam, state.theta_bar_prev
    out["penalty"] = state.penalty.eta
    out["replicated"] = replicated_leaves(state)
    out["node_ring"] = None if state.node_ring is None \
        else state.node_ring.buf
    return out


def replicated_leaves(state) -> list:
    """The leaves of a TrainState that every rank holds whole (the
    penalties, the step, the topology state, the ledger's clock and the
    rings), in checkpoint order."""
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.optim.consensus import replicated_leaf
    paths, leaves, _ = flatten(state)
    return [x for p, x in zip(paths, leaves) if replicated_leaf(p)]


def tensor_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_lib.leaves(tree))


# the launcher's runs on the replicated in-pod grid (J 2, data 1 x model 2
# a node, the flat rows whole on every rank), reduced qwen3-4b, 4 steps:
# every round path the reference's flags combine with that grid
PATH_ARCH = "qwen3-4b"
PATH_RUNS = {
    "async": ["--async", "--max-staleness", "1", "--slow-node", "0:3.0",
              "--pipeline-offsets", "2", "--wire-codec", "int8",
              "--local-steps", "1"],
    "dynamic": ["--topo-scheduler", "budget", "--wire-codec", "fp8_e4m3",
                "--local-steps", "2"],
}
PATH_STEPS = 4
# resume on the same 4 ranks through the launcher: (J, init_ranks keywords,
# launcher arguments) for each grid, a checkpoint every RESUME_AT steps
RESUME_CASES = {
    "rows": (8, {}, []),
    "slabs": (2, {"shard_consensus": True}, ["--shard-consensus"]),
    "inpod": (2, {"mesh": RANKS_CONS_MESH}, []),
}
RESUME_STEPS, RESUME_AT = 4, 2


def path_args(name: str, device: str = "cpu", obs_dir: str = ""):
    from repro_torch.launch import train
    return train.parse_args(
        ["--nodes", "2", "--steps", str(PATH_STEPS), "--device", device,
         "--scheme", "nap", "--topology", "ring"] + PATH_RUNS[name]
        + (["--obs-dir", obs_dir, "--obs-drain-every", "1"] if obs_dir
           else []))


def traced_run(cfg, args, grid) -> tuple[dict, Any]:
    """``launch.train.run`` on ``grid``, with the state its last round
    returned (every run here ends on a round)."""
    from repro_torch.launch import train
    from repro_torch.optim.consensus import ConsensusTrainer
    last = []
    saved = {n: getattr(ConsensusTrainer, n)
             for n in ("consensus_step", "consensus_step_async")}

    def hooked(orig):
        def step(self, *a, **kw):
            out = orig(self, *a, **kw)
            last[:] = [out[0]]
            return out
        return step
    for n, fn in saved.items():
        setattr(ConsensusTrainer, n, hooked(fn))
    try:
        record = train.run(cfg, args, grid)
    finally:
        for n, fn in saved.items():
            setattr(ConsensusTrainer, n, fn)
    return record, last[0]


def state_rows(state) -> dict:
    """A state's flat rows and ledger rows, and its replicated leaves, on
    the CPU."""
    return {"lam": state.lam.cpu(), "bar": state.theta_bar_prev.cpu(),
            "ledger": None if state.ledger is None
            else state.ledger.wires.cpu(),
            "replicated": [x.cpu() for x in replicated_leaves(state)]}


def record_numbers(record) -> dict:
    """A launcher record's losses and round metrics (no seconds, no
    launch counts)."""
    keep = ("r_max", "s_max", "f_mean", "eta_mean", "active_edges",
            "stale_edges", "age_max")
    return {"losses": record["losses"],
            "rounds": [{k: r[k] for k in keep if k in r}
                       for r in record["rounds"]]}


def resume_args(name: str, ckpt_dir: str, device: str = "cpu"):
    from repro_torch.launch import train
    j, _, extra = RESUME_CASES[name]
    return train.parse_args(
        ["--nodes", str(j), "--steps", str(RESUME_STEPS), "--local-steps",
         "2", "--device", device, "--ckpt-dir", ckpt_dir, "--ckpt-every",
         str(RESUME_AT)] + extra)


def resume_case(grid, name: str, base: str, device: str = "cpu") -> dict:
    """On ``grid``: the launcher's run to ``RESUME_STEPS`` with a
    checkpoint every ``RESUME_AT`` steps into ``<base>/full``; rank 0
    copies its step ``RESUME_AT`` into ``<base>/resumed``, and the run
    starts again there. Returns both records' losses and round metrics
    and the step the second started from."""
    import shutil

    import torch.distributed as dist
    from repro_torch.launch import train
    c = cfg(PATH_ARCH)
    full = train.run(c, resume_args(name, os.path.join(base, "full"),
                                    device), grid)
    step = f"step_{RESUME_AT:010d}"
    if grid.rank == 0:
        shutil.copytree(os.path.join(base, "full", step),
                        os.path.join(base, "resumed", step))
    dist.barrier(group=grid.group)
    resumed = train.run(c, resume_args(name, os.path.join(base, "resumed"),
                                       device), grid)
    return {"full": record_numbers(full), "resumed": record_numbers(resumed),
            "start_step": resumed["start_step"]}


def _host_out(out: dict) -> dict:
    """``run_consensus``' outputs on the CPU: each list of per-step or
    per-round scalars stacked."""
    def one(k, v):
        if k == "replicated":
            return [x.cpu() for x in v]
        if isinstance(v, list):
            return torch.stack(v).cpu()
        if isinstance(v, dict):
            return tree_lib.tree_map(lambda x: x.detach().cpu(), v)
        return None if v is None else v.cpu()
    return {k: one(k, v) for k, v in out.items()}


def ranks_worker(rank, world, store, out_dir, device="cpu"):
    """One rank of several runs, each on its own process group: (1)
    ``make_train_fns`` on a ``RANKS_TRAIN_MESH`` mesh of ``world`` ranks,
    then its gradients at ``GRAD_CF``; (2) the consensus trainer, J 2 with
    a ``RANKS_CONS_MESH`` in-pod mesh (``world`` = 2 x S ranks), the flat
    rows in slabs; (3) the same with the flat rows replicated in-pod
    (obs on), then the launcher's ``PATH_RUNS`` on that grid; (4) the
    ``RESUME_CASES`` through the launcher, each checkpointing into
    ``<out_dir>/resume_<name>``. Saves this rank's outputs (on the CPU) as
    ``rank<r>.pt``."""
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
    grid = init_ranks(2, device, backend="gloo",
                      init_method=f"file://{store}.rep", world_size=world,
                      rank=rank, mesh=RANKS_CONS_MESH)
    rep = run_consensus(grid, device=grid.device, obs=True)
    paths = {}
    for name in PATH_RUNS:
        record, state = traced_run(cfg(PATH_ARCH), path_args(
            name, device, os.path.join(out_dir, f"obs_{name}_{rank}")),
            grid)
        paths[name] = dict(record_numbers(record), **state_rows(state))
    grid.close()
    resumed = {}
    for name, (j, kw, _) in RESUME_CASES.items():
        grid = init_ranks(j, device, backend="gloo",
                          init_method=f"file://{store}.{name}",
                          world_size=world, rank=rank, **kw)
        resumed[name] = resume_case(grid, name, os.path.join(
            out_dir, f"resume_{name}"), device)
        grid.close()
    cpu = lambda t: tree_lib.tree_map(lambda x: x.detach().cpu(), t) \
        if isinstance(t, dict) else t
    train = {k: cpu(v) if k != "shardings" else v
             for k, v in train.items()}
    train["loss"] = torch.stack(train["loss"]).cpu()
    train["grad_norm"] = torch.stack(train["grad_norm"]).cpu()
    out = {"train": train, "train_coords": coords,
           "grad": {"loss": loss.cpu(), "grads": cpu(grads)},
           "cons": _host_out(cons), "cons_coords": cons_coords,
           "rep": _host_out(rep), "paths": paths, "resume": resumed}
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


def assert_rep_ranks_equal(ranks, want) -> None:
    """The ranks' replicated in-pod run (``ranks_worker``'s (3)) against
    the one-process ``run_consensus`` on ``trivial_grid(2,
    mesh=RANKS_CONS_MESH)`` with the rows replicated, bit for bit: every
    rank holds its pod's whole flat rows, the replicated leaves and its
    shards of its pod's parameters and moments."""
    from repro_torch.distributed import fsdp, local_mesh
    from repro_torch.models import build_model
    model = build_model(cfg(ARCH))
    mesh = local_mesh(*RANKS_CONS_MESH, "cpu")
    specs, _ = fsdp.specs_for(model, mesh)
    s = mesh.size
    for rank, r in enumerate(ranks):
        got, pod = r["rep"], rank // s
        for name in ("loss", "r_max", "eta", "s_max", "f_mean"):
            assert torch.equal(got[name], torch.stack(want[name]).cpu()), \
                name
        assert got["lam"].shape == (1, want["lam"].shape[1])
        for name in ("lam", "bar"):
            assert torch.equal(got[name][0], want[name][pod].cpu()), name
        for a, b in zip(got["replicated"], want["replicated"], strict=True):
            assert torch.equal(a, b.cpu()), rank
        for name in ("params", "m", "v"):
            node = tree_lib.tree_map(lambda x: x[pod].cpu(), want[name])
            cut = fsdp.cut(node, specs, mesh, divmod(rank % s, mesh.model))
            for a, b in zip(tree_lib.leaves(got[name]),
                            tree_lib.leaves(cut), strict=True):
                assert torch.equal(a[0], b), (rank, name)


def spawned_ranks(tmp_path_factory) -> tuple[str, list]:
    """The 4 gloo ranks of ``ranks_worker``, spawned once per test run
    (the xdist workers and the test modules share them under a file lock):
    their directory and outputs."""
    import fcntl

    from torch_ranks_cases import spawn
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = os.path.join(str(base), "inpod_ranks")
    with open(d + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(os.path.join(d, "done")):
            os.makedirs(d, exist_ok=True)
            spawn(ranks_worker, 4, d, d)
            open(os.path.join(d, "done"), "w").close()
    return d, [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
               for r in range(4)]


def same_checkpoint(a: str, b: str) -> None:
    """Two checkpoint directories hold the same files, each npz leaf and
    the manifest bit for bit."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.msgpack" in names
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            with np.load(pa) as x, np.load(pb) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    assert x[k].dtype == y[k].dtype
                    assert np.array_equal(x[k], y[k]), (name, k)
        else:
            with open(pa, "rb") as f, open(pb, "rb") as g:
                assert f.read() == g.read(), name
