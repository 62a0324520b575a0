"""Nested containers of tensors: the part of ``jax.tree`` the port uses.

A tree is a dict, list or tuple of subtrees, ``None`` (an empty node) or
a leaf (anything else: a tensor, an array, a number). ``flatten`` lists
the leaves in ``jax.tree``'s order (a dict's keys sorted, a sequence in
order) with a :class:`TreeDef` that rebuilds the tree and prints as
``jax.tree.structure(...)`` prints the same nesting, so a checkpoint's
``tree.json`` reads the same from either package.
"""

from __future__ import annotations

from typing import Any, Callable


class TreeDef:
    """The shape of a tree with its leaves taken out."""

    def __init__(self, kind: str, children: tuple = (), keys: tuple = ()) -> None:
        self.kind = kind  # "leaf" | "none" | "dict" | "list" | "tuple"
        self.children = children
        self.keys = keys

    def _body(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = [c._body() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {v}" for k, v in zip(self.keys, inner)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(inner) + "]"
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"

    def __str__(self) -> str:
        return f"PyTreeDef({self._body()})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, TreeDef) and str(self) == str(other)

    def unflatten(self, leaves: list) -> Any:
        it = iter(leaves)
        tree = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError(f"too many leaves for {self}")
        return tree

    def _build(self, it) -> Any:
        if self.kind == "leaf":
            leaf = next(it, _END)
            if leaf is _END:
                raise ValueError(f"too few leaves for {self}")
            return leaf
        if self.kind == "none":
            return None
        built = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.keys, built))
        return built if self.kind == "list" else tuple(built)


_END = object()


def flatten(tree: Any) -> tuple[list, TreeDef]:
    leaves: list = []

    def walk(node: Any) -> TreeDef:
        if node is None:
            return TreeDef("none")
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return TreeDef("dict", tuple(walk(node[k]) for k in keys), keys)
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return TreeDef(kind, tuple(walk(c) for c in node))
        leaves.append(node)
        return TreeDef("leaf")

    treedef = walk(tree)
    return leaves, treedef


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which must have the same structure)."""
    flat, treedef = flatten(tree)
    others = []
    for other in rest:
        other_flat, other_def = flatten(other)
        if other_def != treedef:
            raise ValueError(f"tree structures differ: {treedef} and {other_def}")
        others.append(other_flat)
    return treedef.unflatten([fn(*xs) for xs in zip(flat, *others)])
