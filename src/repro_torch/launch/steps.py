"""Serve step builders over a ``(data, model)`` mesh (port of the serve half
of ``repro/launch/steps.py``).

``make_serve_fns`` returns the reference's pair ``(prefill_fn,
decode_fn)``, each run under ``use_mesh``, so that the model's MoE layers
take the expert-parallel paths: the prefill's full-sequence blocks the
all-to-all path, the decode step the replicated one.

Both take the global batch, as the reference's do, and return the global
logits. Rank ``(d, m)`` computes the batch rows of data index ``d`` (the
reference's ``batch -> data`` rule), the layers other than the MoE whole
on those rows, and all-gathers the logits over the data axis. The decode
state a rank passes holds its own rows only (``Model.init_decode_state``
at ``global_batch / data``); the one-process mesh passes the state of
every row, and computes each data index's rows in turn, on views of its
rows, with the ranks' shapes. ``make_train_fns`` and
``decode_state_specs`` (parameter and state sharding in-pod) are not
ported.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.distributed.sharding import Mesh, use_mesh
from repro_torch.models.model import Model
from repro_torch.models.transformer import DecodeState


def _data_shards(mesh: Mesh | None) -> list[tuple[int, int]]:
    """``(d, data)`` for each data index this process computes: on the
    one-process mesh every index, in turn; on a rank its own."""
    if mesh is None:
        return [(0, 1)]
    return [(d, mesh.data) for d in mesh.shards("data")]


def _rows(t: torch.Tensor | None, d: int, n: int, dim: int = 0):
    """Data index ``d``'s rows of ``t`` (``n`` indices along ``dim``)."""
    if t is None or n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"serve: batch {t.shape[dim]} does not split over "
                         f"{n} data ranks")
    size = t.shape[dim] // n
    return t.narrow(dim, d * size, size)


def _join(mesh: Mesh | None, outs: list[torch.Tensor]) -> torch.Tensor:
    """The global batch's logits from each data index's: concatenated on
    the one-process mesh, all-gathered over the data axis on a rank."""
    if mesh is None or mesh.local:
        return outs[0] if len(outs) == 1 else torch.cat(outs)
    if mesh.data == 1:
        return outs[0]
    out = mesh.all_gather(outs, "data")
    return out.reshape((-1,) + tuple(out.shape[2:]))


def make_serve_fns(model: Model, mesh: Mesh | None, cell: ShapeCell):
    """Returns ``(prefill_fn, decode_fn)`` closed over ``mesh``.

    ``prefill_fn(params, batch, use_kernel=False)``: the logits ``[B, S,
    V]`` of the global ``batch`` (``tokens`` [B, S] or ``embeds``);
    ``use_kernel`` goes through to ``Model.prefill``.
    ``decode_fn(params, state, inputs)``: one step of ``inputs["token"]``
    [B] (or ``inputs["embed_in"]`` [B, D]) at ``max_len = cell.seq_len``;
    returns (logits [B, V], the next state). ``params`` on a rank hold its
    experts only (``params.shard_experts``, ``Model.init(mesh=)``).
    """

    def prefill_fn(params, batch, use_kernel: bool = False):
        outs = []
        for d, n in _data_shards(mesh):
            sub = {k: _rows(v, d, n) for k, v in batch.items()}
            with use_mesh(mesh):
                outs.append(model.prefill(params, sub,
                                          use_kernel=use_kernel))
        return _join(mesh, outs)

    def decode_fn(params, state: DecodeState, inputs):
        local = mesh is not None and mesh.local and mesh.data > 1
        outs = []
        for d, n in _data_shards(mesh):
            sub = state
            if local:           # this index's rows: leaves [L, B, ...]
                sub = state._replace(cache={
                    name: type(entry)(*(_rows(t, d, n, 1) if t.dim() > 1
                                        else t for t in entry))
                    for name, entry in state.cache.items()})
            with use_mesh(mesh):
                logits, _ = model.decode_step(
                    params, sub, _rows(inputs.get("token"), d, n),
                    max_len=cell.seq_len,
                    embed_in=_rows(inputs.get("embed_in"), d, n))
            outs.append(logits)
        return _join(mesh, outs), state._replace(pos=state.pos + 1)

    return prefill_fn, decode_fn

