"""DP-SGD clip and reduce over per-example gradients, with hand-written Hopper
kernels for both passes.

Counterpart of ``fl4health_tpu/kernels/dp_clip.py``. Its two Pallas kernels
become CUDA kernels in ``csrc/dp_clip.cu``, built for ``sm_90a`` at first
use (never at import) into ``kernels/_build/dp_clip/``:

- K1 ``per_example_tree_sq_norms`` (``_sq_norm_kernel``, summed over the
  leaves as the JAX ``fused_clipped_masked_sum`` sums it): ``[B, W_l]``
  leaves ``-> [B]`` f32 squared L2 norms of the whole tree, in one
  deterministic launch (one per ``K1_MAX_LEAVES`` leaves) over a flat list
  of work items that ``tree_plan`` lays out from the shapes;
  ``per_example_sq_norms`` is the same kernel on one leaf;
- K2 ``scaled_masked_sum`` (``_scaled_sum_kernel``): ``[B, W], [B] -> [W]``
  f32 ``sum_i scale[i] * g[i]``, so the clipped tensor never exists. On a
  leaf too narrow to give every SM a CTA, its rows are split over threads
  (``scaled_sum_split``, a shape rule), still in a fixed order.

Both take f32 or bf16 gradients, accumulate in f32 and read a leaf in place
(no padding copy; the JAX function's ``tile`` and ``interpret`` have no
counterpart). Each launch sits in a ``torch.autograd.Function`` whose
inputs carry a leading client axis, ``[N, B, W]`` (N = 1 outside the
client vmap), with a ``vmap`` rule: under the simulation's
``torch.func.vmap`` over clients (JAX's ``vmap(client_fit)``, under which
Pallas batches its kernels), the rule folds the vmapped axis into N as a
view and calls the Function again, so one launch serves every client. K1
reads the ``N * B`` rows through a client stride and a row stride, K2 takes
the client as a grid dimension: no layout the vmap leaves behind needs the
per-example tensor copied, and ``COPIES`` counts any copy of it that a
rule or wrapper does make. The Functions' backwards are plain tensor code,
so they compose with ``torch.func.grad``.

Dispatch is on the tensors' device: CUDA tensors launch the kernel (or
raise), CPU tensors run the plain version beside it, through the same
Functions and rules. Nothing swaps one for the other on failure. Fake
tensors (round-program introspection, ``kernels/fake.py``) take each
wrapper's fake branch on either device: outputs of the right shape, the
call reported to the op counter, no launch and no count in ``LAUNCHES``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from fl4health_tpu_torch.core.pytree import tree_leaves, tree_map
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.kernels import fake
from fl4health_tpu_torch.kernels.build import load_extension
from fl4health_tpu_torch.kernels.fold import fold_vmapped
from fl4health_tpu_torch.observability import stages as stage_attr

# Kernel launches since the last reset: one per launch, counted by the wrapper
# right after the launch succeeded (the plain versions never count).
LAUNCHES = {"dp_sq_norms": 0, "dp_scaled_sum": 0}
# Copies of per-example gradients that a wrapper or a vmap rule made on the
# card (a leaf without unit column stride, or vmapped axes that do not fold
# as a view): the main path makes none.
COPIES = {"dp_per_example": 0}


# Launch geometry (csrc/dp_clip.cu): threads per CTA; K1: leaves in one
# launch's table, and the most loads (16-byte packs, or elements on the scalar
# route) that one work item (one CTA) makes, 32 a thread; K2: the most threads
# that may share one 16-byte column group
THREADS = 256
K1_MAX_LEAVES, K1_ITEM_LOADS = 32, 8192
K2_MAX_SPLIT = 32


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, COPIES):
        for name in counts:
            counts[name] = 0


@functools.cache
def build_extension():
    """Compile (or load from ``_build/``) the kernels for sm_90a. Needs
    ``nvcc``; called on the first CUDA launch."""
    return load_extension("dp_clip", ["dp_clip_binding.cpp", "dp_clip.cu"])


def scaled_sum_split(b: int, w: int, elem_bytes: int, n_sms: int, n: int = 1) -> int:
    """The shape rule for K2's row split: how many threads share each
    16-byte column group of ``n`` clients' ``[b, w]`` leaves (one launch, a
    grid row of CTAs a client). 1 (each thread walks all b rows) when the
    column groups give every one of ``n_sms`` SMs a CTA; else the smallest
    power of two that does, at most 32 and at most b. Read from the shape
    alone, never from a failure."""
    groups = -(-w // (16 // elem_bytes))
    split = 1
    while (n * -(-groups * split // THREADS) < n_sms
           and 2 * split <= min(b, K2_MAX_SPLIT)):
        split *= 2
    return split


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One leaf of a K1 launch: its items (one CTA each) read ``rows`` rows
    (a power of two) by ``chunk`` columns; the leaf's items are ``item0``
    on, row group major, ``ceil(B / rows) * n_chunks`` of them; row r's
    partial over column chunk c goes to workspace slot
    ``ws0 + r * n_chunks + c``."""
    width: int
    chunk: int
    n_chunks: int
    rows: int
    item0: int
    ws0: int
    flags: int  # 1: bf16; 2: 16-byte loads (base and row stride aligned)


@dataclasses.dataclass(frozen=True)
class TreePlan:
    """The work items of one K1 launch over at most ``K1_MAX_LEAVES`` leaves."""
    b: int
    leaves: tuple[LeafPlan, ...]
    n_items: int
    n_slots: int


def _leaf_geometry(b: int, width: int, elem_bytes: int, vec: bool) -> tuple[int, int, int]:
    """(chunk, n_chunks, rows) of a [b, width] leaf. A row that takes more
    than ``K1_ITEM_LOADS`` loads is cut into that many column chunks of equal
    size (a multiple of the pack); a narrower row shares its item with as
    many rows as fit (a power of two, at most the CTA's threads and b
    rounded up), so that every thread of the CTA loads."""
    unit = 16 // elem_bytes if vec else 1  # elements a load reads
    loads = -(-width // unit)
    if loads > K1_ITEM_LOADS:
        n_chunks = -(-loads // K1_ITEM_LOADS)
        chunk = -(-loads // n_chunks) * unit
        return chunk, -(-width // chunk), 1
    rows, cap = 1, min(THREADS, 1 << (b - 1).bit_length())
    while 2 * rows * loads <= K1_ITEM_LOADS and 2 * rows <= cap:
        rows *= 2
    return width, 1, rows


@functools.lru_cache(maxsize=256)
def tree_plan(b: int, leaves: tuple[tuple[int, int, bool], ...]) -> tuple[TreePlan, ...]:
    """K1's launches over leaves of ``(width, elem_bytes, vec)``: one plan for
    each group of ``K1_MAX_LEAVES`` leaves, in leaf order. A rule on the
    shapes alone; each launch's results add onto the group before it."""
    plans = []
    for g0 in range(0, len(leaves), K1_MAX_LEAVES):
        out, item, slot = [], 0, 0
        for width, elem_bytes, vec in leaves[g0:g0 + K1_MAX_LEAVES]:
            chunk, n_chunks, rows = _leaf_geometry(b, width, elem_bytes, vec)
            out.append(LeafPlan(width, chunk, n_chunks, rows, item, slot,
                                (elem_bytes == 2) | (2 if vec else 0)))
            item += -(-b // rows) * n_chunks
            slot += b * n_chunks
        plans.append(TreePlan(b, tuple(out), item, slot))
    return tuple(plans)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def per_example_sq_norms_reference(flat_grads: torch.Tensor) -> torch.Tensor:
    """[..., B, W] -> [..., B] f32 squared norms, in plain PyTorch."""
    return (flat_grads.float() ** 2).sum(-1)


def per_example_tree_sq_norms_reference(mats: list[torch.Tensor]) -> torch.Tensor:
    """[..., B, W_l] leaves -> [..., B] f32: each leaf's squared norms,
    summed over the leaves in leaf order (the JAX function's fold), in plain
    PyTorch."""
    return sum(per_example_sq_norms_reference(m) for m in mats)


def scaled_masked_sum_reference(flat_grads: torch.Tensor,
                                scale: torch.Tensor) -> torch.Tensor:
    """[..., B, W], [..., B] -> [..., W] f32 ``sum_i scale[i] * g[i]`` (for
    each client of a leading client axis), in plain PyTorch."""
    return (flat_grads.float() * scale.float()[..., None]).sum(-2)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _as_stack(g: torch.Tensor) -> torch.Tensor:
    """A [B, W] matrix as a stack of one client, [1, B, W] (a view)."""
    return g[None] if g.ndim == 2 else g


def _strides(g: torch.Tensor) -> tuple[int, int]:
    """(client stride, row stride) of an [N, B, W] stack, in elements; a
    size-1 axis is never stepped, so it reads 0 (client) or W (row)."""
    n, b, w = g.shape
    return (g.stride(0) if n > 1 else 0), (g.stride(1) if b > 1 else w)


def _check_stack(g: torch.Tensor) -> None:
    if g.device.type != "cuda":
        raise ValueError(f"dp_clip kernels need CUDA tensors, got {g.device}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dp_clip kernels take float32 or bfloat16, got {g.dtype}")
    if g.ndim != 3 or g.stride(2) != 1 or _strides(g)[1] < g.shape[2] or g.stride(0) < 0:
        raise ValueError("dp_clip kernels take [B, W] matrices, or [N, B, W] stacks of "
                         "them, with unit column stride and rows that do not overlap; "
                         f"got shape {tuple(g.shape)} strides {g.stride()}")
    if g.shape[0] * g.shape[1] > 65535 or g.shape[0] > 65535:
        raise ValueError(f"N*B={g.shape[0] * g.shape[1]} exceeds the kernels' limit "
                         "of 65535 rows")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: {build_extension().error_string(err)}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _tree_batch(mats: list[torch.Tensor]) -> tuple[tuple[int, ...], torch.device]:
    """The leading (client and row) shape and the device that all leaves
    share; raises where they differ."""
    if not mats:
        raise ValueError("dp_clip needs at least one leaf")
    lead, device = tuple(mats[0].shape[:-1]), mats[0].device
    for m in mats:
        if m.device != device:
            raise ValueError(f"dp_clip leaves on {device} and {m.device}")
        if tuple(m.shape[:-1]) != lead or m.ndim not in (2, 3):
            want = ", ".join(f"{n}={v}" for n, v in zip("NB"[-len(lead):], lead))
            raise ValueError(f"dp_clip leaves must be [{want}, W] matrices (or "
                             f"stacks of them), got shape {tuple(m.shape)}")
    return lead, device


# K1's counter (zeroed once) and workspace for each (device, stream). Launches
# on one stream run one after another, so they can share both; launches on
# two streams never share a counter.
_K1_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _k1_scratch(device: torch.device, stream: int, n_slots: int):
    key = (device.index, stream)
    got = _K1_SCRATCH.get(key)
    if got is None or got[1].numel() < n_slots:
        counter = torch.zeros(1, dtype=torch.int32, device=device) if got is None else got[0]
        got = _K1_SCRATCH[key] = (counter, torch.empty(
            (n_slots,), dtype=torch.float32, device=device))
    return got


def _vec(g: torch.Tensor) -> bool:
    """16-byte loads: the base and both strides 16-byte aligned."""
    cs, ld = _strides(g)
    e = g.element_size()
    return g.data_ptr() % 16 == 0 and ld * e % 16 == 0 and cs * e % 16 == 0


def plan_of(mats: list[torch.Tensor]) -> tuple[TreePlan, ...]:
    """K1's launches over these [B, W_l] leaves (or [N, B, W_l] stacks, as
    N * B rows): 16-byte loads where a leaf's base and strides are 16-byte
    aligned, elements elsewhere."""
    stacks = [_as_stack(m) for m in mats]
    n, b = stacks[0].shape[:2]
    return tree_plan(n * b, tuple((g.shape[2], g.element_size(), _vec(g)) for g in stacks))


def sq_norms_tree_kernel(mats: list[torch.Tensor]) -> torch.Tensor:
    """K1 on the card: ``[B, W_l]`` leaves -> [B] f32 squared norms of the
    whole tree, or ``[N, B, W_l]`` stacks -> [N, B] (the ``N * B`` rows in
    the same launch, read through the client and row strides); f32 or bf16,
    each leaf may differ; one launch per ``K1_MAX_LEAVES`` leaves."""
    lead, device = _tree_batch(mats)
    if fake.is_fake(mats[0]):
        out = torch.empty(lead, dtype=torch.float32, device=device)
        for first in range(0, len(mats), K1_MAX_LEAVES):  # one report a launch
            fake.report("dp_sq_norms", mats[first:first + K1_MAX_LEAVES], out)
        return out
    stacks = [_as_stack(m) for m in mats]
    for g in stacks:
        _check_stack(g)
    n, b = stacks[0].shape[:2]
    ext, stream = build_extension(), _stream(stacks[0])
    plans = plan_of(stacks)
    counter, ws = _k1_scratch(device, stream, max(p.n_slots for p in plans))
    out = torch.empty((n * b,), dtype=torch.float32, device=device)
    first = 0
    for plan in plans:
        table = []
        for g, lf in zip(stacks[first:], plan.leaves):
            cs, ld = _strides(g)
            table += [g.data_ptr(), ld, cs, lf.width, lf.chunk, lf.ws0, lf.item0,
                      lf.n_chunks, lf.rows, lf.flags]
        err = ext.sq_norms_tree(table, plan.n_items, n * b, b, ws.data_ptr(),
                                counter.data_ptr(), out.data_ptr(), first > 0, stream)
        _raise_on(err, "dp_sq_norms")
        LAUNCHES["dp_sq_norms"] += 1
        first += len(plan.leaves)
    return out.reshape(lead)


def scaled_sum_kernel(flat_grads: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K2 on the card: [B, W], [B] f32 -> [W] f32, or the client-batched
    entry [N, B, W], [N, B] -> [N, W] (one launch, a grid row of CTAs a
    client, the stack read through its client and row strides)."""
    if fake.is_fake(flat_grads):
        out = torch.empty((*flat_grads.shape[:-2], flat_grads.shape[-1]),
                          dtype=torch.float32, device=flat_grads.device)
        return fake.report("dp_scaled_sum", (flat_grads, scale), out)
    g = _as_stack(flat_grads)
    _check_stack(g)
    n, b, w = g.shape
    if (scale.shape != flat_grads.shape[:-1] or scale.dtype != torch.float32
            or scale.device != g.device or not scale.is_contiguous()):
        raise ValueError(f"scale must be a contiguous f32 {list(flat_grads.shape[:-1])} on "
                         f"{g.device}, got {scale.dtype} {tuple(scale.shape)} {scale.device}")
    out = torch.empty((n, w), dtype=torch.float32, device=g.device)
    split = scaled_sum_split(b, w, g.element_size(), _sm_count(g.device.index), n)
    cs, ld = _strides(g)
    err = build_extension().scaled_sum(
        g.data_ptr(), ld, cs, w, b, n, scale.data_ptr(), out.data_ptr(), split,
        g.dtype == torch.bfloat16, _stream(g))
    _raise_on(err, "dp_scaled_sum")
    LAUNCHES["dp_scaled_sum"] += 1
    return out.reshape(*flat_grads.shape[:-2], w)


# ---------------------------------------------------------------------------
# autograd.Functions with client-vmap rules
# ---------------------------------------------------------------------------

def _unit_column_stride(g: torch.Tensor) -> torch.Tensor:
    # a leaf reshaped to [B, W] is a view when the leaf is contiguous, as
    # per-example gradients are; a strided one is copied once, and counted
    if g.stride(-1) == 1 or g.shape[-1] == 1:
        return g
    if g.device.type == "cuda" and not fake.is_fake(g):
        COPIES["dp_per_example"] += 1
    return g.contiguous()


def _fold_clients(x: torch.Tensor, bdim: int | None, size: int) -> torch.Tensor:
    """The rule's batched input as one more set of clients, ``[size * N,
    ...]``: a view whenever the two axes step evenly, as every layout of the
    simulation's does; else a copy, counted on the card."""
    folded, copied = fold_vmapped(x, bdim, size)
    if copied and x.device.type == "cuda" and not fake.is_fake(x):
        COPIES["dp_per_example"] += 1
    return folded


class _TreeSqNorms(torch.autograd.Function):
    """K1: ``[N, B, W_l]`` leaves -> ``[N, B]`` f32 squared norms of the tree."""

    @staticmethod
    def forward(*stacks):
        if stacks[0].device.type == "cuda" or fake.is_fake(stacks[0]):
            return sq_norms_tree_kernel([_unit_column_stride(g) for g in stacks])
        if stacks[0].device.type == "cpu":
            return per_example_tree_sq_norms_reference(list(stacks))
        raise ValueError(f"dp_clip runs on cuda or cpu, not {stacks[0].device}")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dout):
        return tuple((2.0 * g.float() * dout[..., None]).to(g.dtype)
                     for g in ctx.saved_tensors)

    @staticmethod
    def vmap(info, in_dims, *stacks):
        # the vmapped axis joins the client axis; the Function runs again
        # on the folded stacks (and again under another vmap level)
        folded = [_fold_clients(g, d, info.batch_size) for g, d in zip(stacks, in_dims)]
        out = _TreeSqNorms.apply(*folded)
        return out.view(info.batch_size, -1, out.shape[-1]), 0


class _ScaledSum(torch.autograd.Function):
    """K2: ``[N, B, W], [N, B] -> [N, W]`` f32 ``sum_i scale[n, i] g[n, i]``."""

    @staticmethod
    def forward(stack, scale):
        if stack.device.type == "cuda" or fake.is_fake(stack):
            return scaled_sum_kernel(_unit_column_stride(stack),
                                     scale.float().contiguous())
        if stack.device.type == "cpu":
            return scaled_masked_sum_reference(stack, scale)
        raise ValueError(f"dp_clip runs on cuda or cpu, not {stack.device}")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dout):
        g, scale = ctx.saved_tensors
        dg = (scale.float()[..., None] * dout[..., None, :]).to(g.dtype)
        dscale = (g.float() * dout[..., None, :]).sum(-1).to(scale.dtype)
        return dg, dscale

    @staticmethod
    def vmap(info, in_dims, stack, scale):
        n = info.batch_size
        out = _ScaledSum.apply(_fold_clients(stack, in_dims[0], n),
                               _fold_clients(scale, in_dims[1], n))
        return out.view(n, -1, out.shape[-1]), 0


# ---------------------------------------------------------------------------
# Public functions
# ---------------------------------------------------------------------------

def per_example_tree_sq_norms(mats: list[torch.Tensor]) -> torch.Tensor:
    """[B, W_l] leaves -> [B] f32 squared L2 norms of the whole tree (summed
    over the leaves in order), one pass over the gradients."""
    _tree_batch(mats)
    return _TreeSqNorms.apply(*(m[None] for m in mats))[0]


def per_example_sq_norms(flat_grads: torch.Tensor) -> torch.Tensor:
    """[B, W] -> [B] f32 squared L2 norms, one pass over the gradients."""
    return per_example_tree_sq_norms([flat_grads])


def scaled_masked_sum(flat_grads: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """sum_i scale[i] * g[i]  ([B, W], [B] -> [W] f32), one pass."""
    return _ScaledSum.apply(flat_grads[None], scale[None])[0]


def fused_clipped_masked_sum(
    per_example_grads: Params,
    example_mask: torch.Tensor,
    clipping_bound: float,
    return_norms: bool = False,
):
    """sum_i mask[i] * min(1, C/||g_i||) * g_i over a tree of [B, ...] leaves,
    without materializing the clipped per-example tensor.

    K1 runs once over the leaves' [B, W] views and sums the squared norms
    across leaves; then K2 runs per leaf with the clip factor times the mask
    as the scale. Leaf sums come back f32 whatever the input dtype.
    ``return_norms=True`` also returns the pre-clip per-example norms [B].
    Runs as spine stage ``dp_clip`` (``observability/stages.py``).
    """
    with stage_attr.stage("dp_clip"):
        mats = tree_map(lambda g: g.reshape(g.shape[0], -1), per_example_grads)
        sq = per_example_tree_sq_norms(tree_leaves(mats))
        norms = torch.sqrt(torch.clamp(sq, min=0.0))
        factor = torch.clamp(clipping_bound / torch.clamp(norms, min=1e-12), max=1.0)
        scale = factor * example_mask.to(torch.float32)
        out = tree_map(lambda g, m: scaled_masked_sum(m, scale).reshape(g.shape[1:]),
                       per_example_grads, mats)
    if return_norms:
        return out, norms
    return out
