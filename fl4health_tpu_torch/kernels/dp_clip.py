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
as a ``[B, W]`` view: no padding copy (the JAX function's ``tile`` and
``interpret`` have no counterpart). Dispatch is on the tensors' device: CUDA
tensors launch the kernel (or raise), CPU tensors run the plain version
beside it. Nothing swaps one for the other on failure. The kernels take
materialized per-example gradients and nothing differentiates through them,
so they need no ``autograd.Function``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from fl4health_tpu_torch.core.pytree import tree_leaves, tree_map
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.kernels.build import load_extension

# Kernel launches since the last reset: one per launch, counted by the wrapper
# right after the launch succeeded (the plain versions never count).
LAUNCHES = {"dp_sq_norms": 0, "dp_scaled_sum": 0}


# Launch geometry (csrc/dp_clip.cu): threads per CTA; K1: leaves in one
# launch's table, and the most loads (16-byte packs, or elements on the scalar
# route) that one work item (one CTA) makes, 32 a thread; K2: the most threads
# that may share one 16-byte column group
THREADS = 256
K1_MAX_LEAVES, K1_ITEM_LOADS = 32, 8192
K2_MAX_SPLIT = 32


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def build_extension():
    """Compile (or load from ``_build/``) the kernels for sm_90a. Needs
    ``nvcc``; called on the first CUDA launch."""
    return load_extension("dp_clip", ["dp_clip_binding.cpp", "dp_clip.cu"])


def scaled_sum_split(b: int, w: int, elem_bytes: int, n_sms: int) -> int:
    """The shape rule for K2's row split: how many threads share each
    16-byte column group of a ``[b, w]`` leaf. 1 (each thread walks all b
    rows) when the leaf's column groups give every one of ``n_sms`` SMs a
    CTA; else the smallest power of two that does, at most 32 and at most
    b. Read from the shape alone, never from a failure."""
    groups = -(-w // (16 // elem_bytes))
    split = 1
    while (-(-groups * split // THREADS) < n_sms
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
    """[B, W] -> [B] f32 squared norms, in plain PyTorch."""
    return (flat_grads.float() ** 2).sum(1)


def per_example_tree_sq_norms_reference(mats: list[torch.Tensor]) -> torch.Tensor:
    """[B, W_l] leaves -> [B] f32: each leaf's squared norms, summed over
    the leaves in leaf order (the JAX function's fold), in plain PyTorch."""
    return sum(per_example_sq_norms_reference(m) for m in mats)


def scaled_masked_sum_reference(flat_grads: torch.Tensor,
                                scale: torch.Tensor) -> torch.Tensor:
    """[B, W], [B] -> [W] f32 ``sum_i scale[i] * g[i]``, in plain PyTorch."""
    return (flat_grads.float() * scale.float()[:, None]).sum(0)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _check_matrix(g: torch.Tensor) -> None:
    if g.device.type != "cuda":
        raise ValueError(f"dp_clip kernels need CUDA tensors, got {g.device}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dp_clip kernels take float32 or bfloat16, got {g.dtype}")
    if g.ndim != 2 or g.stride(1) != 1 or g.stride(0) < g.shape[1]:
        raise ValueError("dp_clip kernels take a [B, W] matrix with unit column "
                         f"stride, got shape {tuple(g.shape)} strides {g.stride()}")
    if g.shape[0] > 65535:
        raise ValueError(f"B={g.shape[0]} exceeds the kernels' limit of 65535 rows")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: {build_extension().error_string(err)}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _tree_batch(mats: list[torch.Tensor]) -> tuple[int, torch.device]:
    """B and the device that all leaves share; raises where they differ."""
    if not mats:
        raise ValueError("dp_clip needs at least one leaf")
    b, device = mats[0].shape[0], mats[0].device
    for m in mats:
        if m.device != device:
            raise ValueError(f"dp_clip leaves on {device} and {m.device}")
        if m.ndim != 2 or m.shape[0] != b:
            raise ValueError(f"dp_clip leaves must be [B={b}, W] matrices, "
                             f"got shape {tuple(m.shape)}")
    return b, device


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


def plan_of(mats: list[torch.Tensor]) -> tuple[TreePlan, ...]:
    """K1's launches over these [B, W_l] leaves: 16-byte loads where a
    leaf's base and row stride are 16-byte aligned, elements elsewhere."""
    return tree_plan(mats[0].shape[0], tuple(
        (m.shape[1], m.element_size(),
         m.data_ptr() % 16 == 0 and m.stride(0) * m.element_size() % 16 == 0)
        for m in mats))


def sq_norms_tree_kernel(mats: list[torch.Tensor]) -> torch.Tensor:
    """K1 on the card: ``[B, W_l]`` leaves (f32 or bf16, each may differ) ->
    [B] f32 squared norms of the whole tree, one launch per
    ``K1_MAX_LEAVES`` leaves."""
    b, device = _tree_batch(mats)
    for m in mats:
        _check_matrix(m)
    ext, stream = build_extension(), _stream(mats[0])
    plans = plan_of(mats)
    counter, ws = _k1_scratch(device, stream, max(p.n_slots for p in plans))
    out = torch.empty((b,), dtype=torch.float32, device=device)
    first = 0
    for plan in plans:
        table = []
        for m, lf in zip(mats[first:], plan.leaves):
            table += [m.data_ptr(), m.stride(0), lf.width, lf.chunk, lf.ws0, lf.item0,
                      lf.n_chunks, lf.rows, lf.flags]
        err = ext.sq_norms_tree(table, plan.n_items, b, ws.data_ptr(), counter.data_ptr(),
                                out.data_ptr(), first > 0, stream)
        _raise_on(err, "dp_sq_norms")
        LAUNCHES["dp_sq_norms"] += 1
        first += len(plan.leaves)
    return out


def scaled_sum_kernel(flat_grads: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K2 on the card: [B, W], [B] f32 -> [W] f32."""
    _check_matrix(flat_grads)
    b, w = flat_grads.shape
    if (scale.shape != (b,) or scale.dtype != torch.float32
            or scale.device != flat_grads.device or not scale.is_contiguous()):
        raise ValueError(f"scale must be a contiguous f32 [{b}] on {flat_grads.device}, "
                         f"got {scale.dtype} {tuple(scale.shape)} {scale.device}")
    out = torch.empty((w,), dtype=torch.float32, device=flat_grads.device)
    split = scaled_sum_split(b, w, flat_grads.element_size(),
                             _sm_count(flat_grads.device.index))
    err = build_extension().scaled_sum(
        flat_grads.data_ptr(), flat_grads.stride(0), w, b, scale.data_ptr(),
        out.data_ptr(), split, flat_grads.dtype == torch.bfloat16, _stream(flat_grads))
    _raise_on(err, "dp_scaled_sum")
    LAUNCHES["dp_scaled_sum"] += 1
    return out


# ---------------------------------------------------------------------------
# Public functions
# ---------------------------------------------------------------------------

def _unit_column_stride(g: torch.Tensor) -> torch.Tensor:
    # a leaf reshaped to [B, W] is a view when the leaf is contiguous, as
    # per-example gradients are; a strided one is copied once
    return g if g.stride(1) == 1 else g.contiguous()


def per_example_tree_sq_norms(mats: list[torch.Tensor]) -> torch.Tensor:
    """[B, W_l] leaves -> [B] f32 squared L2 norms of the whole tree (summed
    over the leaves in order), one pass over the gradients."""
    _, device = _tree_batch(mats)
    if device.type == "cuda":
        return sq_norms_tree_kernel([_unit_column_stride(m) for m in mats])
    if device.type == "cpu":
        return per_example_tree_sq_norms_reference(mats)
    raise ValueError(f"dp_clip runs on cuda or cpu, not {device}")


def per_example_sq_norms(flat_grads: torch.Tensor) -> torch.Tensor:
    """[B, W] -> [B] f32 squared L2 norms, one pass over the gradients."""
    return per_example_tree_sq_norms([flat_grads])


def scaled_masked_sum(flat_grads: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """sum_i scale[i] * g[i]  ([B, W], [B] -> [W] f32), one pass."""
    if flat_grads.device.type == "cuda":
        return scaled_sum_kernel(_unit_column_stride(flat_grads),
                                 scale.float().contiguous())
    if flat_grads.device.type == "cpu":
        return scaled_masked_sum_reference(flat_grads, scale)
    raise ValueError(f"dp_clip runs on cuda or cpu, not {flat_grads.device}")


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
    """
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
