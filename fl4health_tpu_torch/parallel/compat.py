"""Collectives over a mesh axis (counterpart of
``fl4health_tpu/parallel/compat.py``: ``axis_size`` and the ``shard_map``
shim, whose bodies call ``lax.ppermute``, ``psum``, ``all_gather`` and
``psum_scatter``).

The port runs one process per device (``torch.distributed``: NCCL on the
card, gloo on the CPU). An :class:`Axis` is one named axis of a mesh as
this rank sees it: its size, this rank's coordinate on it and the process
group of the ranks that share every other coordinate. Each collective is a
``torch.autograd.Function`` with a ``vmap`` rule, as the kernel wrappers
are, so it runs under the simulation's client ``torch.func.vmap``, under
``vmap(grad)`` and ``vmap(vmap(grad))``: the rule moves the vmapped axis
to the front and calls the collective on the whole stack, which every rank
holds at the same shape. The backward of each is JAX's transpose:

- ``ring_shift``: ``lax.ppermute`` over ``j -> j + 1``; backward the
  inverse shift;
- ``copy_to_axis``: Megatron's ``f``, identity forward, all-reduce
  backward; ``reduce_from_axis``: Megatron's ``g`` (``psum``), all-reduce
  forward, identity backward;
- ``scatter_to_block``: this rank's block of a dimension; backward the
  all-gather. ``gather_from_blocks``: the all-gather of every rank's block
  (tiled); backward the slice;
- ``psum_scatter``: the sum over the axis, each rank keeping its block
  (tiled); backward the all-gather.

An axis without a process group is a world of one, whose collectives are
identities, as JAX's over a one-device mesh are; an axis with a group
always calls the library, even at size 1, and a failed collective raises.
Fake tensors (round-program introspection) take shape-only branches.

The client axis: while the simulation dispatches a round program under a
mesh it enters :func:`client_axis`, and the reductions over the clients
axis (``core/aggregate.py``, the strategies' sums) read the active axis
through :func:`client_total`, :func:`client_max`, :func:`client_all`,
:func:`client_block` and :func:`client_offset`: a rank holds the block of
the ``[C, ...]`` client stacks that JAX's ``P("clients")`` gives its
device, so a sum over clients is the rank's partial sum all-reduced over
the axis, as XLA's sharded sum is. Without an active axis they are the
plain single-process reductions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One named mesh axis from this rank: ``size`` ranks, this rank at
    ``index``, ``ranks`` their global ranks in axis order, ``group`` their
    process group (None: a world of one)."""

    name: str
    size: int = 1
    index: int = 0
    ranks: tuple[int, ...] = (0,)
    group: Any = None

    @property
    def communicates(self) -> bool:
        return self.group is not None


def axis_size(axis: Axis) -> int:
    """JAX's ``axis_size``: the number of ranks on the axis."""
    return axis.size


def _fake(x: torch.Tensor) -> bool:
    """Shape-only tensors (introspection's fake and meta tensors)."""
    from fl4health_tpu_torch.kernels import fake

    return x.device.type == "meta" or fake.is_fake(x)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy the library may write into (bool travels as uint8)."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous().clone()


def _unwire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(torch.bool) if like.dtype == torch.bool else y


def _all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if not axis.communicates or _fake(x):
        return x.clone() if axis.size == 1 else x * axis.size
    y = _wire(x)
    dist.all_reduce(y, group=axis.group)
    return _unwire(y, x)


def _all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    if not axis.communicates or _fake(x):
        return torch.cat([x] * axis.size, dim=dim)
    # the gathered dimension first, so every rank's block lands whole in one
    # output buffer (no per-rank parts to concatenate)
    y = (x.to(torch.uint8) if x.dtype == torch.bool else x).movedim(dim, 0).contiguous()
    out = torch.empty((axis.size * y.shape[0], *y.shape[1:]), dtype=y.dtype,
                      device=y.device)
    dist.all_gather_into_tensor(out, y, group=axis.group)
    # contiguous, as a concatenation's result: a permuted layout would reach
    # reductions downstream (the flash backward's rowsum) in another order
    return _unwire(out.movedim(0, dim).contiguous(), x)


def _block(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % axis.size:
        raise ValueError(f"dimension {dim} of size {n} does not divide over the "
                         f"{axis.size} ranks of mesh axis {axis.name!r}")
    b = n // axis.size
    return x.narrow(dim, axis.index * b, b)


def _reduce_scatter(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    if not axis.communicates or _fake(x):
        return _block(x if axis.size == 1 else x * axis.size, axis, dim).clone()
    y = _wire(x.movedim(dim, 0))
    out = torch.empty((y.shape[0] // axis.size, *y.shape[1:]), dtype=y.dtype,
                      device=y.device)
    if y.shape[0] % axis.size:
        raise ValueError(f"psum_scatter: dimension {dim} of size {y.shape[0]} does "
                         f"not divide over the {axis.size} ranks of {axis.name!r}")
    dist.reduce_scatter_tensor(out, y, group=axis.group)
    return _unwire(out.movedim(0, dim), x)


def _shift(x: torch.Tensor, axis: Axis, step: int) -> torch.Tensor:
    """Rank ``j``'s tensor arrives at rank ``j + step`` (mod the size)."""
    if axis.size == 1 or _fake(x):
        return x.clone()
    if not axis.communicates:
        raise ValueError(f"mesh axis {axis.name!r} has {axis.size} ranks but no "
                         "process group")
    send = x.contiguous()
    recv = torch.empty_like(send)
    to = axis.ranks[(axis.index + step) % axis.size]
    frm = axis.ranks[(axis.index - step) % axis.size]
    # bytes on the wire: any dtype crosses every backend alike
    sb = send.view(torch.uint8) if send.numel() else send
    rb = recv.view(torch.uint8) if recv.numel() else recv
    ops = [dist.P2POp(dist.isend, sb, to, axis.group),
           dist.P2POp(dist.irecv, rb, frm, axis.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def _front(x: torch.Tensor, bdim: int | None, size: int) -> torch.Tensor:
    return x.movedim(bdim, 0) if bdim is not None else x.expand(size, *x.shape)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, step):
        return _shift(x, axis, step)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.step = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, dy):
        return _RingShift.apply(dy, ctx.axis, -ctx.step), None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, step):
        return _RingShift.apply(_front(x, in_dims[0], info.batch_size), axis, step), 0


class _CopyToAxis(torch.autograd.Function):
    """Megatron's ``f``."""

    @staticmethod
    def forward(x, axis):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, dy):
        return _ReduceFromAxis.apply(dy, ctx.axis), None

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return _CopyToAxis.apply(_front(x, in_dims[0], info.batch_size), axis), 0


class _ReduceFromAxis(torch.autograd.Function):
    """Megatron's ``g``: ``psum``."""

    @staticmethod
    def forward(x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, dy):
        return _CopyToAxis.apply(dy, ctx.axis), None

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return _ReduceFromAxis.apply(_front(x, in_dims[0], info.batch_size), axis), 0


class _ScatterToBlock(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, dim):
        return _block(x, axis, dim).clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, dy):
        return _GatherFromBlocks.apply(dy, ctx.axis, ctx.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, dim):
        x = _front(x, in_dims[0], info.batch_size)
        return _ScatterToBlock.apply(x, axis, dim % (x.ndim - 1) + 1), 0


class _GatherFromBlocks(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, dim):
        return _all_gather(x, axis, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, dy):
        return _ScatterToBlock.apply(dy, ctx.axis, ctx.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, dim):
        x = _front(x, in_dims[0], info.batch_size)
        return _GatherFromBlocks.apply(x, axis, dim % (x.ndim - 1) + 1), 0


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, dim):
        return _reduce_scatter(x, axis, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, dy):
        return _GatherFromBlocks.apply(dy, ctx.axis, ctx.dim), None, None

    @staticmethod
    def vmap(info, in_dims, x, axis, dim):
        x = _front(x, in_dims[0], info.batch_size)
        return _PsumScatter.apply(x, axis, dim % (x.ndim - 1) + 1), 0


def ring_shift(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(j, (j + 1) % n)])``."""
    return _RingShift.apply(x, axis, 1)


def copy_to_axis(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's ``f``: identity forward, all-reduce backward."""
    return _CopyToAxis.apply(x, axis)


def reduce_from_axis(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Megatron's ``g`` (``lax.psum``): all-reduce forward, identity backward."""
    return _ReduceFromAxis.apply(x, axis)


def scatter_to_block(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``dim``; backward all-gathers."""
    return _ScatterToBlock.apply(x, axis, dim)


def gather_from_blocks(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Every rank's block of ``dim``, in axis order (``all_gather(tiled=True)``);
    backward slices."""
    return _GatherFromBlocks.apply(x, axis, dim)


def psum_scatter(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``."""
    return _PsumScatter.apply(x, axis, dim)


# ---------------------------------------------------------------------------
# The client axis of a running round program
# ---------------------------------------------------------------------------

_ACTIVE = threading.local()


@contextlib.contextmanager
def client_axis(axis: Axis | None, offset: int = 0):
    """Make ``axis`` the clients axis of the reductions below, on this
    thread, with this rank's block starting at global client ``offset``;
    None (or a one-rank axis without a group) leaves them plain."""
    prev = getattr(_ACTIVE, "state", None)
    _ACTIVE.state = ((axis, offset) if axis is not None and (axis.communicates
                                                            or axis.size > 1)
                     else None)
    try:
        yield
    finally:
        _ACTIVE.state = prev


def active_client_axis() -> Axis | None:
    state = getattr(_ACTIVE, "state", None)
    return state[0] if state is not None else None


def client_offset() -> int:
    """The global index of this rank's first client (0 without an axis)."""
    state = getattr(_ACTIVE, "state", None)
    return state[1] if state is not None else 0


def client_psum(x: torch.Tensor) -> torch.Tensor:
    """A partial over this rank's clients summed over the clients axis."""
    axis = active_client_axis()
    return x if axis is None else reduce_from_axis(x, axis)


def client_total(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(0)`` over all clients of a ``[C, ...]`` stack."""
    s = x.sum() if x.ndim == 1 else x.sum(dim=0)
    return client_psum(s)


def client_max(x: torch.Tensor) -> torch.Tensor:
    """``x.max()`` over all clients of a ``[C]`` vector."""
    return client_all(x).max()


def client_all(x: torch.Tensor) -> torch.Tensor:
    """The whole ``[C, ...]`` stack from this rank's block: an all-gather
    over the clients axis (for small per-client vectors, and for the
    order-statistic aggregators, which read every client's row)."""
    axis = active_client_axis()
    return x if axis is None else gather_from_blocks(x, axis, 0)


def client_block(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a global ``[C, ...]`` stack (no collective)."""
    axis = active_client_axis()
    return x if axis is None else _block(x, axis, 0)


def client_count(n_local: int) -> int:
    """The number of clients of all ranks, from this rank's block's."""
    axis = active_client_axis()
    return n_local if axis is None else n_local * axis.size
