"""Cases of ``tests/test_torch_tp_serve.py``: the configurations, the
inputs both packages draw from numpy generators, the port's serve run on
a mesh, and the worker of the spawned gloo ranks (each on one torch
thread, joined through a ``file://`` store, at mesh position ``(rank //
model, rank % model)``). This module imports no JAX."""
import dataclasses
import os

import numpy as np
import torch

# (a) decode_state_specs of every zoo arch at full size on these meshes
SPEC_MESHES = ((1, 2), (2, 2), (1, 4))
SPEC_BATCH, SPEC_LEN = 2, 4096

# (b) the served cases: (arch, (data, model), sliding window or 0)
SERVE_CASES = {
    "qwen3-4b": ("qwen3-4b", (2, 2), 0),
    "glm4-9b": ("glm4-9b", (2, 2), 0),              # qkv bias, 2 kv heads
    "moonshot": ("moonshot-v1-16b-a3b", (2, 2), 0),  # TP with EP
    "musicgen": ("musicgen-large", (2, 2), 0),       # frontend embeddings
    "rwkv6-7b": ("rwkv6-7b", (2, 2), 0),
    "qwen3-4b-seq": ("qwen3-4b", (1, 4), 0),         # 2 kv heads: cache on S
    "qwen3-4b-window": ("qwen3-4b", (2, 2), 8),      # a ring on S shards
}
SHAPE = (4, 16)                 # batch, sequence (the decode cache's length)
DECODE_STEPS = 6
WINDOW_STEPS = 12               # past the window of 8: the ring wraps

# (c) the spawned ranks
RANKS_MESH = (2, 2)
RANKS_CASES = ("qwen3-4b", "rwkv6-7b")


def cfg_of(get_reduced_config, name: str):
    """Case ``name``'s reduced config in float32 (either package's
    ``get_reduced_config``)."""
    arch, _, window = SERVE_CASES[name]
    cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    return cfg


def port_cfg(name: str):
    from repro_torch.configs import get_reduced_config
    return cfg_of(get_reduced_config, name)


def steps_of(name: str) -> int:
    return WINDOW_STEPS if SERVE_CASES[name][2] else DECODE_STEPS


def inputs(cfg) -> dict:
    """The served batch: prompts ``tokens`` [4, 16] (int32) or, for a
    frontend stub, ``embeds`` [4, 16, D] (float32); the decode step i
    feeds position ``i % 16`` of them."""
    rng = np.random.default_rng(29)
    if cfg.frontend != "none":
        return {"embeds": rng.normal(size=SHAPE + (cfg.d_model,))
                .astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, size=SHAPE,
                                   dtype=np.int32)}


def step_input(batch: dict, i: int) -> dict:
    """Decode step i's input from the served batch (either package's
    arrays)."""
    if "embeds" in batch:
        return {"embed_in": batch["embeds"][:, i % SHAPE[1]]}
    return {"token": batch["tokens"][:, i % SHAPE[1]]}


def torch_inputs(cfg, device="cpu") -> dict:
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)).to(device)
            for k, v in inputs(cfg).items()}


def run_serve(model, mesh, params, batch, n_steps,
              use_kernel: bool = False) -> dict:
    """``make_serve_fns`` on ``mesh`` (a rank's shards, or the whole tree
    on the one-process mesh): the prefill's logits (with ``use_kernel``,
    the kernel on each model shard's heads) and ``n_steps`` decode steps'
    from an empty state, global."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.steps import make_serve_fns
    b, s = SHAPE
    prefill_fn, decode_fn = make_serve_fns(
        model, mesh, ShapeCell("tp", s, b, "decode"))
    with torch.inference_mode():
        out = {"prefill": prefill_fn(params, batch, use_kernel=use_kernel)}
        state = model.init_decode_state(b, s, mesh.device, mesh=mesh)
        steps = []
        for i in range(n_steps):
            logits, state = decode_fn(params, state, step_input(batch, i))
            steps.append(logits)
    out["decode"] = torch.stack(steps)
    out["state"] = state
    return out


def drawn(name: str, device="cpu", mesh=None):
    """Case ``name``'s model and parameters drawn from seed 0: the whole
    tree, or on a rank of ``mesh`` its shards only (``Model.init(mesh=,
    specs=)``)."""
    from repro_torch.distributed import fsdp
    from repro_torch.models import build_model
    model = build_model(port_cfg(name))
    specs = None if mesh is None else fsdp.specs_for(model, mesh)[0]
    params = model.init(torch.Generator(device).manual_seed(0), device,
                        mesh=mesh, specs=specs)
    return model, params


def tree_nbytes(tree) -> int:
    from repro_torch import tree as tree_lib
    return sum(x.numel() * x.element_size() for x in tree_lib.leaves(tree))


def state_nbytes(state) -> int:
    return sum(t.numel() * t.element_size()
               for entry in state.cache.values() for t in entry)


def ranks_worker(rank, world, store, out_dir, device="cpu",
                 shape=RANKS_MESH):
    """One rank of a ``shape`` mesh on ``device`` (gloo; on a card the
    gathers are staged through pinned host buffers): for each case of
    ``RANKS_CASES``, its shards drawn from the seed and ``run_serve``;
    the logits and the bytes of its parameters and decode state saved
    (on the CPU) as ``rank<r>.pt``."""
    from repro_torch.launch.mesh import init_mesh
    torch.set_num_threads(1)
    mesh = init_mesh(*shape, device, backend="gloo",
                     init_method=f"file://{store}", world_size=world,
                     rank=rank)
    out = {"coords": torch.tensor(mesh.coords)}
    for name in RANKS_CASES:
        cfg = port_cfg(name)
        model, params = drawn(name, mesh.device, mesh)
        got = run_serve(model, mesh, params, torch_inputs(cfg, mesh.device),
                        steps_of(name))
        out[f"{name}/prefill"] = got["prefill"].cpu()
        out[f"{name}/decode"] = got["decode"].cpu()
        out[f"{name}/param_bytes"] = torch.tensor(tree_nbytes(params))
        out[f"{name}/state_bytes"] = torch.tensor(state_nbytes(got["state"]))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.close()
