"""Megatron tensor parallelism for the transformer (counterpart of
``fl4health_tpu/parallel/tp.py``).

The rules are JAX's, path -> ``PartitionSpec`` over a ``"model"`` axis:
column-parallel ``q_proj``, ``k_proj``, ``v_proj`` and ``ff_in`` split
their kernel's output features (``[in, out] -> P(None, "model")``, the
bias and ``lora_b`` with them); row-parallel ``o_proj`` and ``ff_out``
split their input features (``P("model", None)``, ``lora_a`` with them,
the bias replicated); everything else replicates. A path is the flax path
with its separators read as dots (``layer_0.attn.q_proj.kernel``).

In JAX GSPMD inserts the collectives from those placements. The port's
forward inserts them itself: :func:`enable_tensor_parallel` marks the
module's column and row layers, and each marked ``LoraDense``
(``models/transformer.py``) then runs Megatron's pairing on its rank's
shard: a column-parallel layer takes ``f`` (``copy_to_axis``) on its
input, a row-parallel one ends in ``g`` (``reduce_from_axis``) before its
replicated bias, so each attention or MLP block costs one all-reduce
forward and one backward. The attention in between runs on the rank's
``n_heads / model`` heads, through the same kernels (K3-K5 per head
shard). A LoRA adapter keeps its gradients exact: a column layer's
``x @ lora_a`` is all-reduced on the backward (``f``) and a row layer's
``x @ lora_a`` on the forward (``g``), since ``lora_a`` (column) and
``lora_b`` (row) are replicated over ranks whose shards all feed them.
"""

from __future__ import annotations

from typing import Any

from fl4health_tpu_torch.core.types import PyTree
from fl4health_tpu_torch.parallel.compat import Axis
from fl4health_tpu_torch.parallel.mesh import Mesh, P, PartitionSpec, _blocked

# Column-parallel: output features sharded (kernel [in, out] -> P(None, ax)).
COLUMN_PARALLEL = ("q_proj", "k_proj", "v_proj", "ff_in")
# Row-parallel: input features sharded (kernel [in, out] -> P(ax, None)).
ROW_PARALLEL = ("o_proj", "ff_out")


def dotted(path: str) -> str:
    return path.replace("/", ".")


def tp_spec(path: str, ndim: int, axis: str = "model") -> PartitionSpec:
    """PartitionSpec for one transformer param leaf (unstacked shape)."""
    segs = dotted(path).split(".")
    module = segs[-2] if len(segs) >= 2 else ""
    leaf = segs[-1]
    if module in COLUMN_PARALLEL:
        if leaf in ("kernel", "lora_b") and ndim == 2:
            return P(None, axis)
        if leaf == "bias" and ndim == 1:
            return P(axis)
        # lora_a of a column-parallel layer stays replicated (it's rank-r).
        return P(*([None] * ndim))
    if module in ROW_PARALLEL:
        if leaf in ("kernel", "lora_a") and ndim == 2:
            return P(axis, None)
        # row-parallel bias adds after the psum -> replicated.
        return P(*([None] * ndim))
    # Embeddings, layer norms, classifier head: replicated over "model".
    return P(*([None] * ndim))


def leaves_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(dotted path, leaf) pairs of a tree of dicts, lists, tuples and tree
    dataclasses, in ``tree_map``'s order."""
    import dataclasses

    join = (lambda k: f"{prefix}.{k}" if prefix else str(k))  # noqa: E731
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in tree for kv in leaves_with_paths(tree[k], join(dotted(str(k))))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return [kv for i, t in enumerate(tree) for kv in leaves_with_paths(t, join(i))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree)
                for kv in leaves_with_paths(getattr(tree, f.name), join(f.name))]
    return [(prefix, tree)]


def _rebuild(tree: Any, values: iter) -> Any:
    import dataclasses

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values) for k in tree}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(_rebuild(t, values) for t in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), values)
                                            for f in dataclasses.fields(tree)})
    return next(values)


def spec_like_params(tree: PyTree, params_template: PyTree, axis: str = "model",
                     client_axis: str | None = None,
                     default: PartitionSpec = P()) -> PyTree:
    """``PartitionSpec`` tree for a tree holding params-shaped sub-trees
    (optimizer momenta, drift anchors) under the TP rules: a leaf inherits
    the rule of the template param whose dotted path its own ends with and
    whose shape it has (an adam ``mu`` leaf at
    ``0.mu.layer_0.attn.o_proj.kernel`` takes ``o_proj``'s); unmatched
    leaves get ``default``. With ``client_axis`` the leaves are
    client-stacked and their leading dimension splits over it."""
    param_specs = []
    for path, leaf in leaves_with_paths(params_template):
        if client_axis is not None:
            spec = P(client_axis, *tp_spec(path, leaf.ndim - 1, axis))
        else:
            spec = tp_spec(path, leaf.ndim, axis)
        param_specs.append((path, tuple(leaf.shape), spec))
    specs = []
    for path, leaf in leaves_with_paths(tree):
        spec = default
        for ppath, pshape, pspec in param_specs:
            if ((path == ppath or path.endswith("." + ppath))
                    and tuple(getattr(leaf, "shape", ())) == pshape):
                spec = pspec
                break
        specs.append(spec)
    return _rebuild(tree, iter(specs))


def shard_transformer_params(params: PyTree, mesh: Mesh, axis: str = "model",
                             client_axis: str | None = None) -> PyTree:
    """This rank's shard of a transformer param tree by the TP rules (with
    ``client_axis``: client-stacked leaves, the leading dimension split over
    it too)."""
    return shard_like_params(params, params, mesh, axis=axis, client_axis=client_axis)


def shard_like_params(tree: PyTree, params_template: PyTree, mesh: Mesh,
                      axis: str = "model", client_axis: str | None = None) -> PyTree:
    """This rank's shard of a params-shaped tree by
    :func:`spec_like_params`'s inheritance rule."""
    specs = spec_like_params(tree, params_template, axis=axis, client_axis=client_axis)
    pairs = zip((leaf for _, leaf in leaves_with_paths(tree)),
                (s for _, s in leaves_with_paths(specs)))
    return _rebuild(tree, iter([_blocked(leaf, spec, mesh) for leaf, spec in pairs]))


def enable_tensor_parallel(module, axis: Axis | None) -> None:
    """Mark ``module``'s column- and row-parallel ``LoraDense`` layers to run
    Megatron's pairing over ``axis`` (None: unmark). The module then expects
    its params as this rank's shards (``shard_transformer_params``)."""
    for name, sub in module.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        role = ("column" if leaf in COLUMN_PARALLEL
                else "row" if leaf in ROW_PARALLEL else None)
        if role is not None and hasattr(sub, "kernel"):
            sub.tp_axis = axis
            sub.tp_role = role if axis is not None else None
        if hasattr(sub, "dropout_rate") and axis is not None and sub.dropout_rate > 0:
            raise ValueError(
                "tensor parallelism with dropout is not supported: each rank "
                "would draw its head shard's masks from the whole model's key")
