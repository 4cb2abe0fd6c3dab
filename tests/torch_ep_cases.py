"""Cases of ``tests/test_torch_moe_ep.py``: the inputs both packages draw
from numpy generators, and the worker of the spawned gloo ranks (each on
one torch thread, joined through a ``file://`` store, at mesh position
``(rank // model, rank % model)``). This module imports no JAX."""
import dataclasses
import os

import numpy as np
import torch

ARCH = "moonshot-v1-16b-a3b"
MESH = (2, 4)                   # data x model, as tests/test_moe_ep.py
RANKS_MESH = (2, 2)             # the spawned ranks
SHAPE = (4, 16)                 # batch, sequence
# 8.0 drops nothing (tests/test_moe_ep.py); at 1.0 each shard's capacity
# is 4 slots a destination for its 16 pairs, and pairs drop
CAPACITY_FACTORS = (8.0, 1.0)
DECODE_STEPS = 4


def moe_inputs():
    """The MoE unit's weights and x (float32): reduced moonshot's d_model
    64, 8 experts, top 2, expert d_ff 32 (``tests/test_moe_ep.py``)."""
    d, e, f = 64, 8, 32
    rng = np.random.default_rng(26)
    out = {"router": 0.02 * rng.normal(size=(d, e)),
           "wg": rng.normal(size=(e, d, f)) / np.sqrt(d),
           "wu": rng.normal(size=(e, d, f)) / np.sqrt(d),
           "wd": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    x = rng.normal(size=SHAPE + (d,))
    return ({k: v.astype(np.float32) for k, v in out.items()},
            x.astype(np.float32))


def tokens(vocab: int) -> np.ndarray:
    """The served prompts ``[4, 16]`` (int32)."""
    return np.random.default_rng(27).integers(0, vocab, size=SHAPE,
                                              dtype=np.int32)


def moe_cfg(cf: float):
    """The port's unit config at capacity factor ``cf``."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.configs.base import MoEConfig
    return dataclasses.replace(
        get_reduced_config(ARCH), dtype="float32",
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=32,
                      capacity_factor=cf))


def serve_cfg():
    """The served model: reduced moonshot-v1-16b-a3b in float32 (2 layers,
    8 experts, top 2, the config's capacity factor 1.25)."""
    from repro_torch.configs import get_reduced_config
    return dataclasses.replace(get_reduced_config(ARCH), dtype="float32")


def moe_rows(cfg, p, x, mesh, decode=False):
    """``moe_apply`` under ``mesh`` on each data index's rows of ``x`` in
    turn, joined (as ``make_serve_fns`` runs them; a rank holds one
    index's rows)."""
    from repro_torch.distributed import use_mesh
    from repro_torch.models import moe
    n = len(mesh.shards("data"))
    with use_mesh(mesh):
        return torch.cat([moe.moe_apply(cfg, p, xd, decode=decode)
                          for xd in x.chunk(n)])


def run_ep(mesh, p, x, params, toks, cf=CAPACITY_FACTORS[-1]):
    """On ``mesh``: the MoE unit's all-to-all and replicated outputs at
    ``cf`` (of the rows this process holds), then the served model's
    prefill logits and ``DECODE_STEPS`` decode steps' logits (global)."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.steps import make_serve_fns
    from repro_torch.models import build_model
    cfg = moe_cfg(cf)
    out = {"a2a": moe_rows(cfg, p, x, mesh),
           "repl": moe_rows(cfg, p, x, mesh, decode=True)}
    model = build_model(serve_cfg())
    b, s = toks.shape
    prefill_fn, decode_fn = make_serve_fns(
        model, mesh, ShapeCell("ep", s, b, "decode"))
    with torch.inference_mode():
        out["prefill"] = prefill_fn(params, {"tokens": toks})
        state = model.init_decode_state(b, s, mesh.device, mesh=mesh)
        steps = []
        for i in range(DECODE_STEPS):
            logits, state = decode_fn(params, state, {"token": toks[:, i]})
            steps.append(logits)
    out["decode"] = torch.stack(steps)
    return out


def unit_on(device):
    """The MoE unit's weights and x as tensors on ``device``."""
    p_np, x_np = moe_inputs()
    return ({k: torch.from_numpy(v).to(device) for k, v in p_np.items()},
            torch.from_numpy(x_np).to(device))


def served_on(device, mesh=None):
    """The served model's parameters, drawn from seed 0 on ``device`` (on a
    rank of ``mesh``, its shards only: its experts, heads, d_ff columns and
    vocab rows), and its prompts."""
    from repro_torch.distributed import fsdp
    from repro_torch.models import build_model
    cfg = serve_cfg()
    model = build_model(cfg)
    specs = None if mesh is None else fsdp.specs_for(model, mesh)[0]
    params = model.init(torch.Generator(device).manual_seed(0), device,
                        mesh=mesh, specs=specs)
    return params, torch.from_numpy(tokens(cfg.vocab)).long().to(device)


def ranks_worker(rank, world, store, out_dir, device="cpu",
                 shape=RANKS_MESH):
    """One rank of a ``shape`` mesh on ``device`` (gloo; on a card the
    exchanges are staged through pinned host buffers): ``run_ep`` on its
    rows and experts, saved (on the CPU) as ``rank<r>.pt``."""
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.params import shard_experts
    torch.set_num_threads(1)
    mesh = init_mesh(*shape, device, backend="gloo",
                     init_method=f"file://{store}", world_size=world,
                     rank=rank)
    p, x = unit_on(mesh.device)
    rows = SHAPE[0] // mesh.data
    d = mesh.coords[0]
    p = shard_experts({"moe": p}, mesh)["moe"]
    params, toks = served_on(mesh.device, mesh)
    out = run_ep(mesh, p, x[d * rows:(d + 1) * rows], params, toks)
    out = {k: v.cpu() for k, v in out.items()}
    out["wg_shape"] = torch.tensor(params["blocks"]["moe"]["wg"].shape)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close()
