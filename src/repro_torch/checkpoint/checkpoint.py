"""Fault-tolerant checkpointing (port of ``repro/checkpoint/checkpoint.py``:
the same API and the same on-disk format).

  * atomic: write to ``<dir>/tmp.<step>``, fsync, rename to
    ``step_<step:010d>``: a crash mid-write never corrupts the newest
    checkpoint;
  * self-describing: ``manifest.msgpack`` holds ``step``, ``treedef``,
    ``num_leaves``, ``shapes``, ``dtypes`` and the caller's ``metadata``;
    ``leaves.npz`` holds ``leaf_<i>``, bfloat16 as a ``uint16`` view and
    float8 e4m3fn/e5m2 as ``uint8`` views under the reference's dtype names;
  * keep-k retention; ``latest_steps`` ignores a directory with no
    manifest;
  * async: ``save_async`` copies to host memory now and writes on a thread.

Leaves go in the reference's order: NamedTuple fields in order, dict keys
sorted, list and tuple items in order, ``None`` dropped. A field that is
not a tensor (an int, float, bool or str, such as ``TopologyState.seed``,
whose reference counterpart is a PRNG key leaf) is not a leaf: it goes
into the manifest's metadata under ``"host"``, keyed by its path, and
``restore`` puts it back. The manifest is written by ``pack.packb``, whose
bytes are ``msgpack.packb``'s; the port imports neither ``msgpack`` nor
``ml_dtypes``.

Ranks (``ranks``, a ``distributed.RankGrid`` with a process group): each
rank holds its own part of a state (its node rows, its slab or its in-pod
shards) beside parts replicated on every rank. The caller's ``shared``
tells them apart by a leaf's path. Every rank writes its own leaves into
``tmp.<step>/leaves.rank<r>.npz``, rank 0 the shared ones into
``leaves.npz``; once every rank's writes are done (an all-reduce of
their failures, so that all raise if one failed) rank 0 writes the
manifest (the shapes and dtypes are rank 0's: every rank's parts have
the same shapes) and renames, and a barrier lets every rank go on with
the checkpoint in place. ``save_async`` runs only the writes on its
thread: no collective runs there. The all-reduce, the barrier and the
rename run on the calling thread, in ``wait_pending`` or at the next
``save_async``. Without ``ranks`` (or on the trivial grid) the layout is
the reference's: one ``leaves.npz``.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.pack import packb, unpackb

_MANIFEST = "manifest.msgpack"
_LEAVES = "leaves.npz"

# numpy cannot hold these: stored as raw unsigned views, restored through
# the manifest's dtype name
_EXT_DTYPES = {
    torch.bfloat16: ("bfloat16", torch.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8),
}
_EXT_BY_NAME = {name: (dt, view) for dt, (name, view) in _EXT_DTYPES.items()}

Path = tuple[str, ...]


def _rank_file(rank: int) -> str:
    return f"leaves.rank{rank:05d}.npz"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree: Any, leaf: Callable, host: Callable, path: Path = ()):
    """``tree`` rebuilt with each tensor or array leaf through ``leaf(path,
    x)`` and each host scalar through ``host(path, x)``, visited in the
    reference's order."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return leaf(path, tree)
    if isinstance(tree, (bool, int, float, str)):
        return host(path, tree)
    if _is_namedtuple(tree):
        return type(tree)(*[_walk(v, leaf, host, path + (f,))
                            for f, v in zip(tree._fields, tree)])
    if isinstance(tree, dict):
        out = {k: _walk(tree[k], leaf, host, path + (str(k),))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, leaf, host, path + (str(i),))
                          for i, v in enumerate(tree))
    raise TypeError(f"checkpoint: {'/'.join(path) or 'the tree'} is a "
                    f"{type(tree).__name__}, not a tensor, a scalar or a "
                    "container")


def _treedef(tree: Any) -> str:
    """The tree's structure as text (``*`` a leaf)."""
    if tree is None:
        return "None"
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return "*"
    if isinstance(tree, (bool, int, float, str)):
        return repr(tree)
    if _is_namedtuple(tree):
        return (f"{type(tree).__name__}("
                + ", ".join(f"{f}={_treedef(v)}"
                            for f, v in zip(tree._fields, tree)) + ")")
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    inner = ", ".join(_treedef(v) for v in tree)
    return f"[{inner}]" if isinstance(tree, list) else f"({inner})"


def flatten(tree: Any) -> tuple[list[Path], list[Any], dict[str, Any]]:
    """``(paths, leaves, host)``: the tensor and array leaves in the
    reference's order with their paths, and the host scalars by path."""
    paths, leaves, host = [], [], {}

    def leaf(path, x):
        paths.append(path)
        leaves.append(x)

    def scalar(path, x):
        host["/".join(path)] = x
    _walk(tree, leaf, scalar)
    return paths, leaves, host


def dtype_name(x) -> str:
    """The reference's name of a leaf's dtype (``numpy``'s, ``ml_dtypes``'
    for the extended ones)."""
    if isinstance(x, np.ndarray):
        return str(x.dtype)
    if x.dtype in _EXT_DTYPES:
        return _EXT_DTYPES[x.dtype][0]
    return str(x.dtype).removeprefix("torch.")


def _storable(x) -> np.ndarray:
    """A host leaf as the array ``leaves.npz`` stores (no copy)."""
    if isinstance(x, np.ndarray):
        return x
    if x.dtype in _EXT_DTYPES:
        x = x.view(_EXT_DTYPES[x.dtype][1])
    return x.numpy()


def _to_host(x):
    """A copy of a leaf in host memory, which later writes to the leaf do
    not reach (a CPU tensor is copied too)."""
    if isinstance(x, np.ndarray):
        return x.copy()
    return x.detach().to("cpu", copy=True)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_npz(path: str, arrays: dict) -> None:
    """``np.savez`` into ``path`` (zip64 for large members), fsynced."""
    with open(path, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())


def _manifest(step: int, tree: Any, leaves: list, host: dict,
              metadata: dict | None) -> dict:
    meta = dict(metadata or {})
    if host:
        meta["host"] = host
    return {
        "step": int(step),
        "treedef": _treedef(tree),
        "num_leaves": len(leaves),
        "shapes": [[int(n) for n in x.shape] for x in leaves],
        "dtypes": [dtype_name(x) for x in leaves],
        "metadata": meta,
    }


def _ranked(ranks) -> bool:
    return ranks is not None and ranks.group is not None


class _Part:
    """What one process writes of one checkpoint, already in host memory."""

    def __init__(self, ckpt_dir, step, tree, metadata, keep, ranks, shared,
                 to_host):
        paths, leaves, host = flatten(tree)
        self.ckpt_dir, self.step, self.keep = ckpt_dir, int(step), keep
        self.ranks = ranks if _ranked(ranks) else None
        rank = 0 if self.ranks is None else self.ranks.rank
        is_shared = [self.ranks is None or (shared is not None
                                            and shared(p)) for p in paths]
        # every rank's own leaves, and rank 0's shared ones
        self.files = {}
        own = {f"leaf_{i}": x for i, x in enumerate(leaves)
               if not is_shared[i]}
        common = {f"leaf_{i}": x for i, x in enumerate(leaves)
                  if is_shared[i]} if rank == 0 else {}
        for name, part in ((_rank_file(rank), own), (_LEAVES, common)):
            if part or (name == _LEAVES and self.ranks is None):
                self.files[name] = {k: to_host(x) for k, x in part.items()}
        self.manifest = _manifest(step, tree, leaves, host, metadata) \
            if rank == 0 else None
        self.tmp = os.path.join(ckpt_dir, f"tmp.{self.step}")
        self.final = os.path.join(ckpt_dir, f"step_{self.step:010d}")
        self.error = None

    def write(self) -> None:
        """This process's leaves into ``tmp.<step>`` (no collective)."""
        try:
            os.makedirs(self.tmp, exist_ok=True)
            for name, arrays in self.files.items():
                _write_npz(os.path.join(self.tmp, name),
                           {k: _storable(x) for k, x in arrays.items()})
            self.files = None                       # the host copies
        except BaseException as e:                  # re-raised in finish()
            self.error = e

    def finish(self) -> str:
        """Every rank's part written: the manifest, the rename and the
        retention (rank 0). Under ranks the first barrier is a sum of the
        ranks' failures, so that every rank raises when one failed."""
        failed = self.error is not None
        if self.ranks is not None:
            flag = torch.tensor([float(failed)], device=(
                "cpu" if self.ranks.backend == "gloo" else self.ranks.device))
            dist.all_reduce(flag, group=self.ranks.group)
            failed = bool(flag.item() > 0)
        if failed:
            raise RuntimeError(f"checkpoint step {self.step}: writing "
                               f"{self.tmp} failed") from self.error
        if self.manifest is not None:
            with open(os.path.join(self.tmp, _MANIFEST), "wb") as f:
                f.write(packb(self.manifest))
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(self.final):
                shutil.rmtree(self.final)
            os.rename(self.tmp, self.final)
            _fsync_dir(self.ckpt_dir)
            _gc(self.ckpt_dir, self.keep)
        if self.ranks is not None:
            dist.barrier(group=self.ranks.group)
        return self.final


def save(ckpt_dir: str, step: int, tree: Any, *, metadata: dict | None = None,
         keep: int = 3, ranks=None,
         shared: Callable[[Path], bool] | None = None) -> str:
    """Synchronous atomic save. Returns the final checkpoint path. Under
    ``ranks`` every rank calls it (``shared`` marks the leaves replicated
    on every rank, which rank 0 alone writes)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    part = _Part(ckpt_dir, step, tree, metadata, keep, ranks, shared,
                 to_host=lambda x: x.detach().cpu()
                 if isinstance(x, torch.Tensor) else x)
    if part.ranks is None and os.path.exists(part.tmp):
        shutil.rmtree(part.tmp)
    part.write()
    return part.finish()


# (the writer thread, its part) of each save_async not finished yet
_PENDING: list[tuple[threading.Thread, _Part]] = []


def save_async(ckpt_dir: str, step: int, tree: Any, *,
               metadata: dict | None = None, keep: int = 3, ranks=None,
               shared: Callable[[Path], bool] | None = None
               ) -> threading.Thread:
    """Copy to host memory now; write on a background thread. Earlier
    saves are finished first (under ranks, their barriers and rename run
    here, on the calling thread)."""
    wait_pending()
    os.makedirs(ckpt_dir, exist_ok=True)
    part = _Part(ckpt_dir, step, tree, metadata, keep, ranks, shared,
                 to_host=_to_host)
    if part.ranks is None and os.path.exists(part.tmp):
        shutil.rmtree(part.tmp)
    t = threading.Thread(target=part.write, daemon=True)
    t.start()
    _PENDING.append((t, part))
    return t


def wait_pending() -> None:
    """Join every pending write and finish its checkpoint (under ranks,
    every rank calls this)."""
    while _PENDING:
        t, part = _PENDING.pop(0)
        t.join()
        part.finish()


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def latest_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            # a directory never renamed has no manifest
            if os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def read_manifest(ckpt_dir: str, step: int | None = None) -> dict:
    """The manifest of the newest (or given) step."""
    steps = latest_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    with open(os.path.join(ckpt_dir, f"step_{step:010d}", _MANIFEST),
              "rb") as f:
        return unpackb(f.read())


def _from_storable(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    t = torch.from_numpy(a if a.flags.c_contiguous else a.copy())
    if dtype_name in _EXT_BY_NAME:
        t = t.view(_EXT_BY_NAME[dtype_name][0])
    return t.to(device)


def restore(ckpt_dir: str, tree_like: Any, *, step: int | None = None,
            ranks=None, grid: dict | None = None) -> tuple[Any, dict]:
    """Restore the newest (or given) step into the structure of
    ``tree_like``: each leaf a tensor on the device of ``tree_like``'s leaf
    (the CPU for an array), in the checkpoint's dtype. Checks the leaf
    count and every shape; with ``grid``, that the checkpoint's
    ``metadata["grid"]`` is the same. Under ``ranks`` each rank reads its
    own leaves and rank 0's shared ones. Returns ``(tree, metadata)``."""
    manifest = read_manifest(ckpt_dir, step)
    path = os.path.join(ckpt_dir, f"step_{manifest['step']:010d}")
    meta = manifest["metadata"]
    if grid is not None and meta.get("grid") != unpackb(packb(grid)):
        raise ValueError(f"checkpoint {path} was written on the grid "
                         f"{meta.get('grid')}; this run's grid is {grid}")
    paths, leaves_ref, _ = flatten(tree_like)
    if manifest["num_leaves"] != len(leaves_ref):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, expected "
            f"{len(leaves_ref)} — incompatible state structure")
    rank = ranks.rank if _ranked(ranks) else None
    names = [_LEAVES] + ([] if rank is None else [_rank_file(rank)])
    files = [np.load(os.path.join(path, n)) for n in names
             if os.path.exists(os.path.join(path, n))]
    try:
        out = []
        for i, ref in enumerate(leaves_ref):
            key = f"leaf_{i}"
            src = next((z for z in files if key in z.files), None)
            if src is None:
                raise ValueError(f"checkpoint {path} holds no leaf {i} "
                                 f"({'/'.join(paths[i])}) for rank {rank}")
            a = src[key]
            dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
            t = _from_storable(a, manifest["dtypes"][i], dev)
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: checkpoint shape "
                                 f"{tuple(t.shape)} != expected "
                                 f"{tuple(ref.shape)}")
            out.append(t)
    finally:
        for z in files:
            z.close()
    host = meta.get("host", {})
    it = iter(out)
    tree = _walk(tree_like, lambda p, x: next(it),
                 lambda p, x: type(x)(host.get("/".join(p), x)))
    return tree, meta
