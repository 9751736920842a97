"""Trees of tensors: flatten, unflatten and map.

The port imports nothing of JAX, so it walks its own trees, with the rules
``jax.tree`` follows: dicts in sorted-key order, lists, tuples and
NamedTuples (the optimizers' states) are nodes, ``None`` is an empty
subtree, anything else is a leaf. Parameters, gradients, optimizer states,
batches and checkpoints all go through these functions.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping


class TreeDef:
    """The structure of a flattened tree: ``kind`` is ``"leaf"``, ``"none"``,
    ``"dict"`` (``meta``: the sorted keys), ``"list"``, ``"tuple"`` or
    ``"namedtuple"`` (``meta``: the class); ``children`` one per entry."""

    def __init__(self, kind: str, meta: Any = None, children: tuple = ()):
        self.kind, self.meta, self.children = kind, meta, children

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeDef) and (self.kind, self.meta, self.children)
                == (other.kind, other.meta, other.children))

    def __str__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        kids = [str(c) for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in zip(self.meta, kids)) + "}"
        if self.kind == "namedtuple":
            return (f"{self.meta.__name__}("
                    + ", ".join(f"{f}={c}" for f, c in zip(self.meta._fields, kids)) + ")")
        if self.kind == "list":
            return "[" + ", ".join(kids) + "]"
        return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"

    __repr__ = __str__


def _flatten(tree: Any, path: str, leaves: list, paths: list) -> TreeDef:
    if tree is None:
        return TreeDef("none")
    if isinstance(tree, Mapping):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(_flatten(tree[k], f"{path}[{k!r}]", leaves, paths)
                                           for k in keys))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return TreeDef("namedtuple", type(tree),
                       tuple(_flatten(v, f"{path}.{f}", leaves, paths)
                             for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return TreeDef(type(tree).__name__, None,
                       tuple(_flatten(v, f"{path}[{i}]", leaves, paths)
                             for i, v in enumerate(tree)))
    leaves.append(tree)
    paths.append(path or "<root>")
    return TreeDef("leaf")


def tree_flatten_with_paths(tree: Any) -> tuple[list, list[str], TreeDef]:
    """``(leaves, paths, treedef)``: each leaf's path reads like
    ``['mu']['embed']``."""
    leaves: list = []
    paths: list = []
    return leaves, paths, _flatten(tree, "", leaves, paths)


def tree_flatten(tree: Any) -> tuple[list, TreeDef]:
    """``(leaves, treedef)``, leaves in ``jax.tree.flatten``'s order."""
    leaves, _, treedef = tree_flatten_with_paths(tree)
    return leaves, treedef


def tree_leaves(tree: Any) -> list:
    return tree_flatten(tree)[0]


def _build(d: TreeDef, it) -> Any:
    if d.kind == "leaf":
        return next(it)
    if d.kind == "none":
        return None
    kids = [_build(c, it) for c in d.children]
    if d.kind == "dict":
        return dict(zip(d.meta, kids))
    if d.kind == "namedtuple":
        return d.meta(*kids)
    return kids if d.kind == "list" else tuple(kids)


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef``'s structure holding ``leaves`` in order.
    (A module-level builder: a recursive closure would form a reference
    cycle holding ``leaves`` until the garbage collector's next pass,
    which for an optimizer's per-leaf temporaries is gigabytes.)"""
    return _build(treedef, iter(leaves))


def _map_leaves(fn: Callable, tree: Any, rest: tuple) -> tuple[TreeDef, list]:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(t) for t in rest]
    for _, d in others:
        if d != treedef:
            raise ValueError(f"tree structures differ: {treedef} vs {d}")
    return treedef, [fn(*xs) for xs in zip(leaves, *(o for o, _ in others))]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of ``rest``, trees of the same
    structure, leaf by leaf), the structure kept."""
    treedef, out = _map_leaves(fn, tree, rest)
    return tree_unflatten(treedef, out)


def tree_map_split(fn: Callable, n: int, tree: Any, *rest: Any) -> tuple:
    """As :func:`tree_map`, for an ``fn`` that returns ``n`` values a leaf:
    ``n`` trees of ``tree``'s structure, the i-th holding the i-th values."""
    treedef, out = _map_leaves(fn, tree, rest)
    return tuple(tree_unflatten(treedef, [o[i] for o in out]) for i in range(n))
