"""Tree helpers over nested dicts/lists/tuples of tensors (counterpart of
``fl4health_tpu/core/pytree.py``, the parts the port's path uses; the path
helpers take a ``Params`` dict, whose keys are the flax paths).

A "tree" is a tensor, or a dict, list or tuple of trees, or an instance of
a dataclass registered with ``tree_dataclass`` (walked field by field);
``None`` is an empty tree. ``tree_dataclass`` also registers the class with
``torch.utils._pytree``, which ``torch.func`` transforms flatten with, so
the client vmap sees the same tree as ``tree_map``. Dicts keep their key
order, so two trees built the same way line up leaf by leaf. That is not JAX's order: ``jax.tree_util`` flattens a
dict in sorted key order at each level, while a ``Params`` dict keeps the
module's init order. Whatever draws one random key per leaf walks
``flax_leaf_order``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch
import torch.utils._pytree as torch_pytree

from fl4health_tpu_torch.core.types import PyTree

_TREE_CLASSES: set[type] = set()


def tree_dataclass(cls: type) -> type:
    """Class decorator: make a dataclass a tree node, field by field, for
    ``tree_map`` and for ``torch.utils._pytree`` (``torch.func.vmap``'s
    flattening) alike."""
    torch_pytree.register_dataclass(cls)
    _TREE_CLASSES.add(cls)
    return cls


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over one or more trees of the same structure.
    Instances of ``tree_dataclass`` classes are mapped field by field; any
    other dataclass instance is refused, so ``tree_map`` and ``torch.func``
    never disagree on what is a tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        if type(tree) not in _TREE_CLASSES:
            raise TypeError(f"{type(tree).__name__} is not a tree: decorate it "
                            "with core.pytree.tree_dataclass")
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


def flax_leaf_order(params: dict) -> list[str]:
    """The keys of a ``Params`` dict (flax paths ``"a/b/c"``) in the order
    ``jax.tree_util.tree_flatten`` visits the nested flax dict: keys sorted
    at each level."""
    return sorted(params, key=lambda path: tuple(path.split("/")))


def ravel(params: dict) -> tuple[torch.Tensor, Callable[[torch.Tensor], dict]]:
    """A ``Params`` dict as one 1-D vector, its leaves in JAX's flatten
    order (``flax_leaf_order``), and the function back (JAX's
    ``ravel_pytree``); the vector is float32 unless every leaf shares
    another dtype."""
    order = flax_leaf_order(params)
    dtypes = {params[k].dtype for k in order}
    dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
    flat = torch.cat([params[k].reshape(-1).to(dtype) for k in order])
    sizes = [params[k].numel() for k in order]
    shapes = {k: params[k].shape for k in order}
    leaf_dtypes = {k: params[k].dtype for k in order}

    def unravel(vector: torch.Tensor) -> dict:
        pieces = dict(zip(order, torch.split(vector, sizes)))
        return {k: pieces[k].reshape(shapes[k]).to(leaf_dtypes[k]) for k in params}

    return flat, unravel


def global_norm(params: dict) -> torch.Tensor:
    """l2 norm over a ``Params`` dict's leaves, the squares summed in JAX's
    leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(params[k]))
                          for k in flax_leaf_order(params)))


def dotted(path: str) -> str:
    """A ``Params`` key as JAX's ``leaf_paths`` spells it: ``"a/b/c"`` ->
    ``"a.b.c"``."""
    return path.replace("/", ".")


def leaf_paths(params: dict) -> list[str]:
    """The dotted path of every leaf of a ``Params`` dict, in JAX's order
    (``jax.tree_util.tree_flatten_with_path`` of the flax tree)."""
    return [dotted(k) for k in flax_leaf_order(params)]


def select_by_path(params: dict, predicate: Callable[[str], bool]) -> dict[str, bool]:
    """A mask: True where the leaf's dotted path satisfies ``predicate``.
    The mask is static (Python bools), so selecting by it never branches on
    a tensor."""
    return {k: bool(predicate(dotted(k))) for k in params}


def merge_by_mask(mask: dict[str, bool], if_true: dict, if_false: dict) -> dict:
    """Leafwise pick between two ``Params`` dicts by a static mask, in
    ``if_false``'s key order."""
    return {k: if_true[k] if mask[k] else v for k, v in if_false.items()}


def tree_astype(tree: PyTree, dtype: torch.dtype) -> PyTree:
    """Cast every floating leaf to ``dtype``; integer leaves pass through."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_zeros_like(tree: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_scale(tree: PyTree, c) -> PyTree:
    return tree_map(lambda x: x * c, tree)


def tree_axpy(a, x: PyTree, y: PyTree) -> PyTree:
    """``a * x + y``, leafwise."""
    return tree_map(lambda xi, yi: a * xi + yi, x, y)
