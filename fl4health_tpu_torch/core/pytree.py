"""Tree helpers over nested dicts/lists/tuples of tensors (counterpart of
``fl4health_tpu/core/pytree.py``, the parts the port's path uses).

A "tree" is a tensor, or a dict, list or tuple of trees; ``None`` is an
empty tree. Dicts keep their key order, so two trees built the same way
line up leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from fl4health_tpu_torch.core.types import PyTree


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over one or more trees of the same structure.
    Dataclass instances are mapped field by field."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)
        })
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list[Any]:
    out: list[Any] = []
    tree_map(lambda x: out.append(x), tree)
    return out


def stack_clients(trees: Sequence[PyTree]) -> PyTree:
    """Stack per-client trees along a new leading clients axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def unstack_clients(stacked: PyTree, n: int) -> list[PyTree]:
    return [client_slice(stacked, i) for i in range(n)]


def client_slice(stacked: PyTree, i: int) -> PyTree:
    return tree_map(lambda x: x[i], stacked)


def broadcast_clients(tree: PyTree, n: int) -> PyTree:
    """Replicate a tree n times along a new leading clients axis (a view)."""
    return tree_map(lambda x: x.unsqueeze(0).expand(n, *x.shape), tree)


def tree_nbytes(tree: PyTree) -> int:
    """Total bytes of a tree's tensors, from shape and dtype only."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))
