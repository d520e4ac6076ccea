"""Nested parameter trees of the port, walked as ``jax.tree_util`` walks
the JAX package's: dict keys in sorted order, lists and tuples by index,
a ``NamedTuple`` by field, ``None`` as an empty subtree, anything else a
leaf.  The optimizer visits leaves in this order, and the checkpointer
names them by their paths as the reference does, so a checkpoint written
by either package restores in the other."""

from __future__ import annotations

import re

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(path key as jax prints it, child) of an inner node, or None for a
    leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(node)]
    return None


def leaves_with_path(tree, path: tuple = ()) -> list:
    """[(path, leaf)] in the reference's flattening order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for key, child in kids:
        out += leaves_with_path(child, path + (key,))
    return out


def leaves(tree) -> list:
    return [x for _, x in leaves_with_path(tree)]


def leaf_names(tree) -> list:
    """The reference checkpointer's leaf names
    (``repro/ckpt/checkpointer.py::_leaf_names``): each path key with its
    non-word characters stripped, joined by ``_``."""
    return ["_".join(re.sub(r"[^A-Za-z0-9_]", "", k) for k in path)
            or f"leaf{i}"
            for i, (path, _) in enumerate(leaves_with_path(tree))]


def tree_map(fn, tree):
    """``fn`` over the leaves -> a tree of the same structure (dicts,
    lists, tuples and NamedTuples rebuilt)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


def to_numpy(t) -> np.ndarray:
    """A tensor (or array) as numpy on the host; bf16 as ``ml_dtypes``'
    bfloat16 (numpy has none of its own), the JAX package's host type."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_numpy(x: np.ndarray) -> torch.Tensor:
    """The inverse of :func:`to_numpy`, sharing ``x``'s memory."""
    if x.dtype.name == "bfloat16":          # ml_dtypes' bf16: same bits
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)
