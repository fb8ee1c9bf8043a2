"""ZeRO-style sharded optimizer state over a mesh axis (counterpart of
``fl4health_tpu/parallel/zero.py``).

ZeRO-1 (:class:`ZeroShardedOptimizer`) wraps any ``optim`` transform: the
flat parameter vector (its dicts in sorted key order, as JAX's
``ravel_pytree``, zero-padded to a multiple of the axis size) is
partitioned over the axis, each rank keeps and updates only its 1/N slice
of the optimizer state, and the updates come back through one all-gather. ``init`` returns this rank's
slice of every vector state leaf (scalars such as counts are whole on
every rank), so the state a rank holds is the ZeRO split itself; a
checkpoint frame holds the gathered vectors (``FedOpt.state_sharding_spec``
names them).

ZeRO-2 (:class:`Zero2ShardedOptimizer`) also shards the gradient
reduction: ``update`` takes an ``[n_shards]``-leading stack of UNREDUCED
gradient trees, rank ``i`` reduces row ``i`` with a ``psum_scatter``, so
each rank only ever holds its 1/N slice of the summed gradient, updates it
and all-gathers the update. The engine feeds it per-microbatch gradients
(``clients/engine.py`` ``_microbatched_value_and_grads``); its collectives
run under the client ``vmap`` through their rules (``parallel/compat.py``).

SCOPE, as in JAX: the wrapped transform must be ELEMENTWISE over the flat
vector (sgd, momentum, adam, ...). Transforms that reduce across all
parameters (global-norm clipping) would compute shard-local statistics and
diverge; the factories run a one-step sharded-vs-unsharded parity probe at
two gradient magnitudes and raise on divergence (``validate=False``
skips). The probe runs collectives, so every rank constructs alike.

The port's transforms take a params dict; the flat vector goes through
them as ``{"flat": vector}``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fl4health_tpu_torch import optim
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.parallel.compat import gather_from_blocks, psum_scatter
from fl4health_tpu_torch.parallel.mesh import Mesh


def _sorted_leaves(tree: Any) -> list:
    """A tree's leaves with every dict walked in sorted key order (JAX's
    flattening order), so two dicts of the same keys ravel alike whatever
    their insertion order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _sorted_leaves(t)]
    return ptu.tree_leaves(tree)


def _sorted_rebuild(tree: Any, values) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        rebuilt = {k: _sorted_rebuild(tree[k], values) for k in sorted(tree)}
        return {k: rebuilt[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted_rebuild(t, values) for t in tree)
    return ptu.tree_map(lambda x: next(values)(x), tree)


def ravel(tree: Params) -> tuple[torch.Tensor, Any]:
    """(flat vector, unravel) of a params tree, its dicts in sorted key
    order as JAX's ``ravel_pytree``; ``unravel`` restores the tree's
    structure, shapes and dtypes."""
    leaves = _sorted_leaves(tree)
    flat = torch.cat([x.reshape(-1) for x in leaves]) if leaves else torch.zeros(0)
    sizes = [x.numel() for x in leaves]

    def unravel(vec: torch.Tensor) -> Params:
        pieces = iter(torch.split(vec, sizes))
        return _sorted_rebuild(tree, iter(
            [lambda x, p=p: p.reshape(x.shape).to(x.dtype) for p in pieces]))

    return flat, unravel


def _pad(flat: torch.Tensor, padded: int) -> torch.Tensor:
    return torch.nn.functional.pad(flat, (0, padded - flat.shape[-1]))


def _local_slice(x: torch.Tensor, index: int, n: int) -> torch.Tensor:
    b = x.shape[-1] // n
    return x[..., index * b:(index + 1) * b]


@dataclasses.dataclass(frozen=True, eq=False)
class ZeroShardedOptimizer:
    """An ``optim.GradientTransformation`` (``init``/``update``) whose state
    is sharded over ``axis_name``."""

    tx: optim.GradientTransformation
    mesh: Mesh
    axis_name: str = "model"
    params_template: Params | None = None

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis_name]

    def _axis(self):
        return self.mesh.axis(self.axis_name)

    def _flat_size(self) -> tuple[int, int]:
        size = sum(x.numel() for x in ptu.tree_leaves(self.params_template))
        n = self.n_shards
        return size, -(-size // n) * n

    def _local(self, tree: Params) -> torch.Tensor:
        size, padded = self._flat_size()
        axis = self._axis()
        return _local_slice(_pad(ravel(tree)[0], padded), axis.index, axis.size)

    def init(self, params: Params) -> Any:
        size, padded = self._flat_size()
        state = self.tx.init({"flat": _pad(ravel(params)[0], padded)})
        axis = self._axis()
        return ptu.tree_map(
            lambda leaf: (_local_slice(leaf, axis.index, axis.size).clone()
                          if getattr(leaf, "ndim", 0) >= 1 else leaf), state)

    def update(self, grads: Params, opt_state: Any, params: Params | None = None):
        size, padded = self._flat_size()
        axis = self._axis()
        flat_g, unravel = ravel(grads)  # the updates take the grads' tree
        g = _local_slice(_pad(flat_g, padded), axis.index, axis.size)
        p = {"flat": self._local(params)} if params is not None else None
        upd, new_state = self.tx.update({"flat": g}, opt_state, p)
        full = gather_from_blocks(upd["flat"], axis, -1)
        return unravel(full[..., :size]), new_state

    def state_bytes_per_device(self, opt_state: Any) -> int:
        """Bytes of optimizer state resident on this rank (the ZeRO win)."""
        return sum(leaf.numel() * leaf.element_size()
                   for leaf in ptu.tree_leaves(opt_state) if leaf.ndim >= 1)


@dataclasses.dataclass(frozen=True, eq=False)
class Zero2ShardedOptimizer:
    """ZeRO-2: sharded gradient reduction + sharded optimizer state.
    ``reduce="mean"`` divides the sum by ``n_shards``; ``"sum"`` keeps it."""

    tx: optim.GradientTransformation
    mesh: Mesh
    axis_name: str = "model"
    params_template: Params | None = None
    reduce: str = "mean"

    # the engine handshake: the train step hands this optimizer an
    # [n_shards]-leading stack of unreduced per-microbatch gradients
    expects_unreduced_grads = True

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis_name]

    def _zero1(self) -> ZeroShardedOptimizer:
        return ZeroShardedOptimizer(self.tx, self.mesh, self.axis_name, self.params_template)

    def init(self, params: Params) -> Any:
        # ZeRO-2 differs from ZeRO-1 in how gradients arrive, not in what
        # each rank keeps
        return self._zero1().init(params)

    def update(self, local_grads: Params, opt_state: Any, params: Params | None = None):
        z1 = self._zero1()
        size, padded = z1._flat_size()
        axis = self.mesh.axis(self.axis_name)
        # this rank's row of the [n_shards, ...] stack, flattened
        mine = ptu.tree_map(lambda x: x[axis.index], local_grads)
        flat_row, unravel = ravel(mine)
        row = _pad(flat_row, padded)
        scale = 1.0 / self.n_shards if self.reduce == "mean" else 1.0
        g_shard = psum_scatter(row, axis, -1) * scale
        p = {"flat": z1._local(params)} if params is not None else None
        upd, new_state = self.tx.update({"flat": g_shard}, opt_state, p)
        full = gather_from_blocks(upd["flat"], axis, -1)
        return unravel(full[..., :size]), new_state

    def grad_bytes_per_device(self) -> int:
        """Bytes of summed gradient a rank holds during the update: 1/N."""
        _, padded = self._zero1()._flat_size()
        itemsize = ptu.tree_leaves(self.params_template)[0].element_size()
        return (padded // self.n_shards) * itemsize

    def state_bytes_per_device(self, opt_state: Any) -> int:
        return self._zero1().state_bytes_per_device(opt_state)


def _probe_grads(params_template: Params, scale: float):
    """Deterministic, value-varied probe gradients: they catch transforms
    whose update reads cross-parameter statistics."""
    flat, unravel = ravel(params_template)
    g = torch.sin(torch.arange(flat.shape[0], dtype=flat.dtype, device=flat.device)
                  * 0.37) * scale
    return unravel(g), flat, g


def _validate_elementwise(wrapper, tx, params_template, n_local=None):
    """One-step sharded-vs-unsharded parity probe at a small and a large
    gradient magnitude; raises ValueError when the wrapped transform is not
    elementwise over the flat vector."""
    for scale in (1e-2, 1e3):
        gtree, flat_p, flat_g = _probe_grads(params_template, scale)
        ref_upd, _ = tx.update({"flat": flat_g}, tx.init({"flat": flat_p}),
                               {"flat": flat_p})
        ref_upd = ref_upd["flat"]
        sharded_state = wrapper.init(params_template)
        if n_local is None:
            upd_tree, _ = wrapper.update(gtree, sharded_state, params_template)
        else:
            # n copies of g reduce to g under "mean"; n copies of g/n under
            # "sum": the effective gradient is the unsharded one either way
            div = 1.0 if wrapper.reduce == "mean" else float(n_local)
            stacked = ptu.tree_map(lambda x: torch.stack([x / div] * n_local), gtree)
            upd_tree, _ = wrapper.update(stacked, sharded_state, params_template)
        got = ravel(upd_tree)[0]
        atol = 1e-5 * float(torch.max(torch.abs(ref_upd))) + 1e-30
        if not bool(torch.allclose(got, ref_upd, rtol=1e-4, atol=atol)):
            err = float(torch.max(torch.abs(got - ref_upd)))
            raise ValueError(
                "ZeRO parity probe failed at gradient scale "
                f"{scale:g} (max |Δupdate| = "
                f"{err:.3e}): the wrapped transform is not elementwise over "
                "the flat parameter vector (global-norm clipping, trust "
                "ratios and adafactor-style factored stats reduce ACROSS "
                "parameters and diverge silently when sharded). Apply such "
                "transforms outside the wrapper and wrap only the "
                "elementwise tail, or pass validate=False if you know "
                "better."
            )


def zero_sharded_optimizer(tx: optim.GradientTransformation, mesh: Mesh,
                           params_template: Params, axis_name: str = "model",
                           validate: bool = True) -> ZeroShardedOptimizer:
    opt = ZeroShardedOptimizer(tx=tx, mesh=mesh, axis_name=axis_name,
                               params_template=params_template)
    if validate:
        _validate_elementwise(opt, tx, params_template)
    return opt


def zero2_sharded_optimizer(tx: optim.GradientTransformation, mesh: Mesh,
                            params_template: Params, axis_name: str = "model",
                            reduce: str = "mean",
                            validate: bool = True) -> Zero2ShardedOptimizer:
    if reduce not in ("mean", "sum"):
        raise ValueError(f"reduce must be 'mean' or 'sum', got {reduce!r}")
    opt = Zero2ShardedOptimizer(tx=tx, mesh=mesh, axis_name=axis_name,
                                params_template=params_template, reduce=reduce)
    if validate:
        _validate_elementwise(opt, tx, params_template, n_local=mesh.shape[axis_name])
    return opt
