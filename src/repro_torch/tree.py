"""Parameter trees: nested dicts / lists / tuples with tensor leaves.

The JAX package walks its pytrees with ``jax.tree.map(...,
is_leaf=lambda x: x is None)``: ``None`` marks a leaf that lives in the
other half of a partition (``core/lora.py``).  ``tree_map`` is that
walk -- ``None`` is a leaf and reaches ``fn`` like any other -- and the
structure is read from the first tree.
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` at every leaf of ``tree``,
    ``None`` leaves included."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` that are not ``None``, in walk order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def copy_into(dst, src) -> None:
    """``d.copy_(s)`` at every tensor leaf ``d`` of ``dst`` (in place; the
    matching leaves of ``src`` are read by key, not by walk order)."""
    tree_map(lambda d, s: None if d is None else d.copy_(s), dst, src)


__all__ = ["tree_map", "tree_leaves", "copy_into"]
