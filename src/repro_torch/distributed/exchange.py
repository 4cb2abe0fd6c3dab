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

The expert-parallel paths (``models/moe.py``, over a
``distributed.sharding.Mesh``) use ``all_to_all``, the reference's tiled
``lax.all_to_all``, and ``all_gather``, each over one axis's group.

An exchange can be in flight (the reference's ``pipeline_offsets``, which
issues up to ``depth`` offsets' permutes ahead of their consumers):
``circulant_start`` copies the local rows, posts the offset's sends and
receives and returns a ``Pending``; ``Pending.wait()`` completes them.
``circulant_into`` is the two back to back. Each offset's ops carry a tag
(the caller's ``tag``, the offset's index in the round), so that two
batches in flight between the same pair of ranks are never matched across
offsets. Under NCCL the works run on c10d's own stream and overlap with
what the card's current stream does until ``wait()``, which orders the
current stream after them; under gloo on the CPU they run on gloo's
thread. Under gloo on a card (``RankGrid.staged``) the rows go through a
pinned host buffer pair (``HostStaging``), one pair per offset in flight:
``circulant_start`` copies the rows to send to the host before it posts
anything, and ``wait()`` copies the received rows to the card. Whatever
the backend, a sent row has left the wire only once its ``Pending`` has
been waited on: the round kernel, which overwrites a native wire (the
packed parameters) in place, runs after every wait.
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


def empty_host_cache() -> None:
    """Give the free pinned blocks that PyTorch's caching host allocator
    keeps back to CUDA (a freed pinned buffer stays cached for
    reuse, so a buffer grown step by step would hold every size it had)."""
    if not torch.cuda.is_available():
        return
    fn = getattr(getattr(torch, "accelerator", None), "empty_host_cache",
                 None) or getattr(torch._C, "_host_emptyCache", None)
    if fn is not None:
        fn()


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
        grow_send = self.send.numel() < nbytes
        grow_recv = self.recv.numel() < recv_nbytes
        if grow_send:
            self.send = None                        # free before regrowing
        if grow_recv:
            self.recv = None
        if grow_send or grow_recv:
            empty_host_cache()
        if grow_send:
            self.send = torch.empty(nbytes, dtype=torch.uint8,
                                    pin_memory=True)
        if grow_recv:
            self.recv = torch.empty(recv_nbytes, dtype=torch.uint8,
                                    pin_memory=True)
        return self.send, self.recv


def _bytes(rows: torch.Tensor) -> torch.Tensor:
    """A contiguous row block as flat bytes (no copy)."""
    return rows.reshape(-1).view(torch.uint8)


class Pending:
    """One offset's exchange in flight (``circulant_start``)."""

    def __init__(self, works, landed, dst):
        self._works = works
        self._landed = landed       # (dst_row, rows, received bytes)
        self._dst = dst
        self.done = False

    def wait(self) -> None:
        """Block until this offset's rows have landed in ``dst`` and this
        rank's sent rows have left (under NCCL: order the current stream
        after the transfers)."""
        if self.done:
            return
        for work in self._works:
            work.wait()
        for d0, rows, buf in self._landed:              # synchronous
            _bytes(self._dst[d0:d0 + rows]).copy_(buf)
        self._works = self._landed = self._dst = None   # the rows' memory
        self.done = True


def circulant_start(dst: torch.Tensor, wire: torch.Tensor, off: int, grid,
                    staging: HostStaging | None = None, tag: int = 0,
                    keep=None) -> Pending:
    """Start ``dst[i] = the wire of node (grid.node_lo + i + off) % J``.

    dst and wire are this rank's ``[J / R, W]`` rows (with shards, its
    node's slab message), contiguous, on the rank's device. The rows whose
    source is this rank are copied before it returns; the others land at
    ``wait()``. ``keep`` (a bool per row of dst) marks rows to leave as
    they are: what reaches them is dropped (every rank still sends and
    receives the same rows). Under gloo on a card ``staging`` holds the
    host buffers (required there), and stays in use until ``wait()``.
    ``tag`` marks this offset's point-to-point ops.
    """
    per, j = grid.nodes_per_rank, grid.num_nodes
    off %= j
    me, ranks, group = grid.node_rank, grid.node_ranks, grid.node_group
    if ranks > 1 and not (dst.is_contiguous() and wire.is_contiguous()):
        raise ValueError("circulant_start: dst and wire must be contiguous")
    kept = [False] * per if keep is None else [bool(k) for k in keep]
    mine = segments(grid.node_lo, per, off, j)
    for src_rank, d0, s0, rows in mine:
        if src_rank != me:
            continue
        if any(kept[d0:d0 + rows]):
            for i in range(rows):
                if not kept[d0 + i]:
                    dst[d0 + i].copy_(wire[s0 + i])
        else:
            dst[d0:d0 + rows].copy_(wire[s0:s0 + rows])
    if ranks == 1:
        return Pending([], [], dst)
    # what each other rank takes from this one: at most one segment
    sends = [(q, s0, rows) for q in range(ranks) if q != me
             for src_rank, _, s0, rows in segments(q * per, per, off, j)
             if src_rank == me]
    recvs = [(src_rank, d0, rows) for src_rank, d0, _, rows in mine
             if src_rank != me]
    row_bytes = wire[0].numel() * wire.element_size()

    def p2p(op, buf, r):             # r: a group rank
        return dist.P2POp(op, buf, dist.get_global_rank(group, r), group,
                          tag)

    def landing(d0, rows, buf):
        """What ``wait()`` copies from ``buf`` (rows received for dst rows
        d0...) into dst: the rows not kept."""
        if not any(kept[d0:d0 + rows]):
            return [(d0, rows, buf)]
        return [(d0 + i, 1, buf[i * row_bytes:(i + 1) * row_bytes])
                for i in range(rows) if not kept[d0 + i]]

    landed, ops = [], []
    if grid.staged:
        if staging is None:
            raise ValueError("circulant_start: gloo on a card needs a "
                             "HostStaging")
        send_buf, recv_buf = staging.reserve(per * row_bytes)
        at = 0
        for q, s0, rows in sends:
            host = send_buf[at:at + rows * row_bytes]
            host.copy_(_bytes(wire[s0:s0 + rows]))      # synchronous
            ops.append(p2p(dist.isend, host, q))
            at += rows * row_bytes
        at = 0
        for src_rank, d0, rows in recvs:
            host = recv_buf[at:at + rows * row_bytes]
            ops.append(p2p(dist.irecv, host, src_rank))
            landed += landing(d0, rows, host)
            at += rows * row_bytes
    else:
        ops = [p2p(dist.isend, _bytes(wire[s0:s0 + rows]), q)
               for q, s0, rows in sends]
        for src_rank, d0, rows in recvs:
            if any(kept[d0:d0 + rows]):             # land in a scratch row
                buf = torch.empty(rows * row_bytes, dtype=torch.uint8,
                                  device=dst.device)
                landed += landing(d0, rows, buf)
            else:
                buf = _bytes(dst[d0:d0 + rows])
            ops.append(p2p(dist.irecv, buf, src_rank))
    return Pending(dist.batch_isend_irecv(ops), landed, dst)


def circulant_into(dst: torch.Tensor, wire: torch.Tensor, off: int, grid,
                   staging: HostStaging | None = None) -> None:
    """``circulant_start`` then ``wait()``: returns after every row has
    landed in ``dst`` and every row of ``wire`` that this rank sends has
    left it."""
    circulant_start(dst, wire, off, grid, staging).wait()


def all_gather(t: torch.Tensor, n: int, group, backend: str,
               staging: HostStaging | None = None) -> torch.Tensor:
    """``[n, *t.shape]``: ``t`` of each of the ``n`` ranks of ``group``,
    in group-rank order, on ``t``'s device. NCCL gathers on the card; gloo
    on a card goes through host memory (``staging``'s pinned buffers when
    given)."""
    t = t.contiguous()
    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    if backend == "nccl":
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


def all_to_all(t: torch.Tensor, group, backend: str,
               staging: HostStaging | None = None) -> torch.Tensor:
    """The tiled all-to-all over the ``n`` ranks of ``group``: ``t`` is
    ``[n, ...]``, its row j goes to group rank j; returns ``[n, ...]``
    whose row j came from group rank j, on ``t``'s device. NCCL exchanges
    on the card (``all_to_all_single``); gloo moves the rows as bytes, on a
    card through host memory (``staging``'s pinned buffers, required
    there)."""
    t = t.contiguous()
    out = torch.empty_like(t)
    if backend == "nccl":
        dist.all_to_all_single(out, t, group=group)
        return out
    if t.device.type == "cpu":
        dist.all_to_all_single(_bytes(out), _bytes(t), group=group)
        return out
    if staging is None:
        raise ValueError("all_to_all: gloo on a card needs a HostStaging")
    nbytes = t.numel() * t.element_size()
    send, recv = staging.reserve(nbytes)
    send, recv = send[:nbytes], recv[:nbytes]
    send.copy_(_bytes(t))                               # synchronous
    dist.all_to_all_single(recv, send, group=group)
    _bytes(out).copy_(recv)                             # synchronous
    return out


def gather_nodes(t: torch.Tensor, grid) -> torch.Tensor:
    """All-gather a ``[J / R, ...]`` tensor of this rank's nodes into the
    ``[J, ...]`` tensor of every node, in node order, on ``t``'s device
    (over the shard group with shards). Without a process group, ``t``
    itself."""
    if grid.group is None:
        return t
    out = all_gather(t, grid.node_ranks, grid.node_group,
                     grid.backend)
    return out.reshape((-1,) + tuple(t.shape[1:]))


def gather_pod(t: torch.Tensor, grid,
               staging: HostStaging | None = None) -> torch.Tensor:
    """All-gather ``t`` over the S ranks of this rank's pod: ``[S,
    *t.shape]`` in slab order, on ``t``'s device. Under gloo on a card
    ``staging`` holds the host buffers."""
    if not grid.holds_slab:
        raise ValueError("gather_pod: this rank holds no slab")
    return all_gather(t, grid.shards, grid.inpod_group, grid.backend,
                      staging)
