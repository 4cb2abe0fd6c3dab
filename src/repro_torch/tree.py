"""Nested-dict parameter trees.

The port keeps the reference's parameter tree as nested dicts of tensors.
Leaves are always visited in sorted key order, recursively — the order
``jax.tree_util.tree_flatten`` gives for dicts — so that flat layouts,
optimizer sums and parameter draws line up with the reference leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

Path = tuple[str, ...]


def leaves_with_paths(tree: Any, *, is_leaf: Callable[[Any], bool] | None
                      = None, _prefix: Path = ()) -> list[tuple[Path, Any]]:
    """[(path, leaf)] in sorted key order, recursively."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], is_leaf=is_leaf,
                                     _prefix=_prefix + (k,))
        return out
    return [(_prefix, tree)]


def leaves(tree: Any, **kw) -> list[Any]:
    return [x for _, x in leaves_with_paths(tree, **kw)]


def unflatten(paths: list[Path], values: list[Any]) -> Any:
    """Inverse of ``leaves_with_paths`` (a bare leaf has the empty path)."""
    if len(paths) == 1 and paths[0] == ():
        return values[0]
    out: dict = {}
    for path, v in zip(paths, values, strict=True):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any, **kw) -> Any:
    """Apply ``fn`` leaf-wise over trees of one structure."""
    pl = leaves_with_paths(tree, **kw)
    others = [leaves(t, **kw) for t in rest]
    vals = [fn(x, *(o[n] for o in others)) for n, (_, x) in enumerate(pl)]
    return unflatten([p for p, _ in pl], vals)


def from_flat(flat: Mapping[str, Any], prefix: str,
              convert: Callable[[Any], Any]) -> Any:
    """The tree stored under ``prefix`` in a flat mapping whose keys join
    ``prefix`` and a leaf's path with ``/`` (``prefix`` alone holds a bare
    leaf); ``convert`` turns each stored value into a leaf."""
    if prefix in flat:
        return convert(flat[prefix])
    head = prefix + "/"
    items = sorted(((tuple(k[len(head):].split("/")), v)
                    for k, v in flat.items() if k.startswith(head)),
                   key=lambda item: item[0])
    if not items:
        raise KeyError(f"no leaf under {prefix!r}")
    return unflatten([p for p, _ in items], [convert(v) for _, v in items])
