"""The consensus round's neighbour exchange across ranks (the port's
counterpart of the ``jnp.roll`` over the ``pod`` axis that GSPMD lowers to
one collective-permute per graph offset in ``repro/optim/consensus.py``).

Each rank holds a contiguous block of nodes (``distributed.grid.RankGrid``).
For graph offset ``off``, local row i of ``dst`` receives the wire of node
``(node_lo + i + off) % J``. Rows whose source lies on this rank are copied
locally; at one rank that is exactly ``torch.roll(wire, -off, 0)`` written
into ``dst``. The others arrive by one ``batch_isend_irecv`` per offset:
the sources of a rank's rows are J / R consecutive nodes, so they lie on
at most two ranks, one contiguous segment each.

Every rank makes the same sequence of calls: an offset that moves nothing
(a dead offset) must be skipped by every rank, from replicated state.

With the consensus state sharded in-pod (``RankGrid.shards`` S > 1) the
exchange and the node gathers run over the rank's shard group, the J ranks
that hold the same slab s: at offset ``off`` slab s of node i receives
slab s of node ``(i + off) % J``. ``gather_pod`` all-gathers a tensor over
the S ranks of the pod, in slab order (the reference's in-pod all-gather
of a slab-sharded buffer, and its ``psum`` of the residual partials).

Under gloo on a card (``RankGrid.staged``) the rows go through one pinned
host buffer pair per rank (``HostStaging``), one offset at a time: the
rows to send are copied to the host before any send starts, so the round
kernel may overwrite the wire (a native wire is the packed parameters)
right after the exchange returns. Under NCCL the returned handles are
waited on, which orders the card's stream after the transfers.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def segments(node_lo: int, per: int, off: int, j: int
             ) -> list[tuple[int, int, int, int]]:
    """The sources of the rows of the rank whose first node is ``node_lo``
    (``per`` nodes a rank) at offset ``off``: ``(src_rank, dst_row,
    src_row, rows)`` in the order of the destination rows, each a
    contiguous run of rows of one rank."""
    out = []
    i = 0
    while i < per:
        g = (node_lo + i + off) % j
        src_rank, src_row = divmod(g, per)
        rows = min(per - i, per - src_row)
        out.append((src_rank, i, src_row, rows))
        i += rows
    return out


class HostStaging:
    """One reused pair of pinned host byte buffers, each grown on demand,
    for what a rank sends and receives in one exchange or gather."""

    def __init__(self):
        self.send = torch.empty(0, dtype=torch.uint8)
        self.recv = torch.empty(0, dtype=torch.uint8)

    def reserve(self, nbytes: int, recv_nbytes: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """At least ``nbytes`` to send and ``recv_nbytes`` (default
        ``nbytes``) to receive."""
        recv_nbytes = nbytes if recv_nbytes is None else recv_nbytes
        if self.send.numel() < nbytes:
            self.send = None                        # free before regrowing
            self.send = torch.empty(nbytes, dtype=torch.uint8,
                                    pin_memory=True)
        if self.recv.numel() < recv_nbytes:
            self.recv = None
            self.recv = torch.empty(recv_nbytes, dtype=torch.uint8,
                                    pin_memory=True)
        return self.send, self.recv


def _bytes(rows: torch.Tensor) -> torch.Tensor:
    """A contiguous row block as flat bytes (no copy)."""
    return rows.reshape(-1).view(torch.uint8)


def circulant_into(dst: torch.Tensor, wire: torch.Tensor, off: int, grid,
                   staging: HostStaging | None = None) -> None:
    """dst[i] = the wire of node ``(grid.node_lo + i + off) % J``.

    dst and wire are this rank's ``[J / R, W]`` rows (with shards, its
    node's slab message), contiguous, on the rank's device. Under gloo on
    a card ``staging`` holds the host buffers (required there). Returns
    after every row has landed in ``dst`` and every row of ``wire`` that
    this rank sends has left it.
    """
    per, j = grid.nodes_per_rank, grid.num_nodes
    off %= j
    me, ranks, group = grid.node_rank, grid.node_ranks, grid.node_group
    if ranks > 1 and not (dst.is_contiguous() and wire.is_contiguous()):
        raise ValueError("circulant_into: dst and wire must be contiguous")
    mine = segments(grid.node_lo, per, off, j)
    for src_rank, d0, s0, rows in mine:
        if src_rank == me:
            dst[d0:d0 + rows].copy_(wire[s0:s0 + rows])
    if ranks == 1:
        return
    # what each other rank takes from this one: at most one segment
    sends = [(q, s0, rows) for q in range(ranks) if q != me
             for src_rank, _, s0, rows in segments(q * per, per, off, j)
             if src_rank == me]
    recvs = [(src_rank, d0, rows) for src_rank, d0, _, rows in mine
             if src_rank != me]
    row_bytes = wire[0].numel() * wire.element_size()

    def peer(r):                     # a group rank's global rank
        return dist.get_global_rank(group, r)

    if grid.staged:
        if staging is None:
            raise ValueError("circulant_into: gloo on a card needs a "
                             "HostStaging")
        send_buf, recv_buf = staging.reserve(per * row_bytes)
        ops, at = [], 0
        for q, s0, rows in sends:
            host = send_buf[at:at + rows * row_bytes]
            host.copy_(_bytes(wire[s0:s0 + rows]))      # synchronous
            ops.append(dist.P2POp(dist.isend, host, peer(q), group))
            at += rows * row_bytes
        landed, at = [], 0
        for src_rank, d0, rows in recvs:
            host = recv_buf[at:at + rows * row_bytes]
            ops.append(dist.P2POp(dist.irecv, host, peer(src_rank),
                                  group))
            landed.append((d0, rows, host))
            at += rows * row_bytes
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        for d0, rows, host in landed:                   # synchronous
            _bytes(dst[d0:d0 + rows]).copy_(host)
        return
    ops = [dist.P2POp(dist.isend, _bytes(wire[s0:s0 + rows]), peer(q),
                      group) for q, s0, rows in sends]
    ops += [dist.P2POp(dist.irecv, _bytes(dst[d0:d0 + rows]),
                       peer(src_rank), group)
            for src_rank, d0, rows in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def _all_gather(t: torch.Tensor, n: int, group, grid,
                staging: HostStaging | None = None) -> torch.Tensor:
    """``[n, *t.shape]``: ``t`` of each of the ``n`` ranks of ``group``,
    in group-rank order, on ``t``'s device. NCCL gathers on the card; gloo
    on a card goes through host memory (``staging``'s pinned buffers when
    given)."""
    t = t.contiguous()
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    if grid.backend == "nccl":
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    # gloo moves bytes, whatever the dtype
    nbytes = t.numel() * t.element_size()
    if t.device.type == "cpu":
        dist.all_gather(list(_bytes(out).view(n, nbytes).unbind(0)),
                        _bytes(t), group=group)
        return out
    if staging is None:                 # small tensors: pageable memory
        send = _bytes(t.cpu())
        recv = torch.empty(n * nbytes, dtype=torch.uint8)
    else:
        send, recv = staging.reserve(nbytes, n * nbytes)
        send, recv = send[:nbytes], recv[:n * nbytes]
        send.copy_(_bytes(t))                           # synchronous
    dist.all_gather(list(recv.view(n, nbytes).unbind(0)), send, group=group)
    _bytes(out).copy_(recv)                             # synchronous
    return out


def gather_nodes(t: torch.Tensor, grid) -> torch.Tensor:
    """All-gather a ``[J / R, ...]`` tensor of this rank's nodes into the
    ``[J, ...]`` tensor of every node, in node order, on ``t``'s device
    (over the shard group with shards). Without a process group, ``t``
    itself."""
    if grid.group is None:
        return t
    out = _all_gather(t, grid.node_ranks, grid.node_group, grid)
    return out.reshape((-1,) + tuple(t.shape[1:]))


def gather_pod(t: torch.Tensor, grid,
               staging: HostStaging | None = None) -> torch.Tensor:
    """All-gather ``t`` over the S ranks of this rank's pod: ``[S,
    *t.shape]`` in slab order, on ``t``'s device. Under gloo on a card
    ``staging`` holds the host buffers."""
    if not grid.holds_slab:
        raise ValueError("gather_pod: this rank holds no slab")
    return _all_gather(t, grid.shards, grid.inpod_group, grid, staging)
