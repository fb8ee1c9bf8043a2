"""DP-SGD clip and reduce over per-example gradients, with hand-written Hopper
kernels for both passes.

Counterpart of ``fl4health_tpu/kernels/dp_clip.py``. Its two Pallas kernels
become CUDA kernels in ``csrc/dp_clip.cu``, built for ``sm_90a`` at first
use (never at import) into ``kernels/_build/dp_clip/``:

- K1 ``per_example_sq_norms`` (``_sq_norm_kernel``): ``[B, W] -> [B]`` f32
  squared L2 norms, a deterministic two-stage reduction over column chunks;
- K2 ``scaled_masked_sum`` (``_scaled_sum_kernel``): ``[B, W], [B] -> [W]``
  f32 ``sum_i scale[i] * g[i]``, so the clipped tensor never exists. On a
  leaf too narrow to give every SM a CTA, its rows are split over threads
  (``scaled_sum_split``, a shape rule), still in a fixed order.

Both take f32 or bf16 gradients, accumulate in f32 and read a leaf in place
as a ``[B, W]`` view: no padding copy (the JAX function's ``tile`` and
``interpret`` have no counterpart). Dispatch is on the tensor's device: a
CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
version beside it. Nothing swaps one for the other on failure. The kernels
take materialized per-example gradients and nothing differentiates through
them, so they need no ``autograd.Function``.
"""

from __future__ import annotations

import functools

import torch

from fl4health_tpu_torch.core.pytree import tree_leaves, tree_map
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.kernels.build import load_extension

# Kernel launches since the last reset: one per launch, counted by the wrapper
# right after the launch succeeded (K1's two stages count as one; the plain
# versions never count).
LAUNCHES = {"dp_sq_norms": 0, "dp_scaled_sum": 0}


# K2's launch geometry (csrc/dp_clip.cu): threads per CTA, and the most
# threads that may share one 16-byte column group
K2_THREADS, K2_MAX_SPLIT = 256, 32


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
    while (-(-groups * split // K2_THREADS) < n_sms
           and 2 * split <= min(b, K2_MAX_SPLIT)):
        split *= 2
    return split


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def per_example_sq_norms_reference(flat_grads: torch.Tensor) -> torch.Tensor:
    """[B, W] -> [B] f32 squared norms, in plain PyTorch."""
    return (flat_grads.float() ** 2).sum(1)


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
        raise ValueError(f"B={g.shape[0]} exceeds the grid limit 65535")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: {build_extension().error_string(err)}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def sq_norms_kernel(flat_grads: torch.Tensor) -> torch.Tensor:
    """K1 on the card: [B, W] -> [B] f32."""
    _check_matrix(flat_grads)
    b, w = flat_grads.shape
    out = torch.empty((b,), dtype=torch.float32, device=flat_grads.device)
    ext = build_extension()
    n_chunks = -(-w // ext.chunk_width())
    partial = torch.empty((b, n_chunks), dtype=torch.float32, device=flat_grads.device)
    err = ext.sq_norms(flat_grads.data_ptr(), flat_grads.stride(0), w, b,
                       partial.data_ptr(), out.data_ptr(),
                       flat_grads.dtype == torch.bfloat16, _stream(flat_grads))
    _raise_on(err, "dp_sq_norms")
    LAUNCHES["dp_sq_norms"] += 1
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


def per_example_sq_norms(flat_grads: torch.Tensor) -> torch.Tensor:
    """[B, W] -> [B] f32 squared L2 norms, one pass over the gradients."""
    if flat_grads.device.type == "cuda":
        return sq_norms_kernel(_unit_column_stride(flat_grads))
    if flat_grads.device.type == "cpu":
        return per_example_sq_norms_reference(flat_grads)
    raise ValueError(f"dp_clip runs on cuda or cpu, not {flat_grads.device}")


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

    K1 runs per leaf on its [B, W] view and the squared norms are summed
    across leaves; then K2 runs per leaf with the clip factor times the mask
    as the scale. Leaf sums come back f32 whatever the input dtype.
    ``return_norms=True`` also returns the pre-clip per-example norms [B].
    """
    mats = tree_map(lambda g: g.reshape(g.shape[0], -1), per_example_grads)
    sq = sum(per_example_sq_norms(m) for m in tree_leaves(mats))
    norms = torch.sqrt(torch.clamp(sq, min=0.0))
    factor = torch.clamp(clipping_bound / torch.clamp(norms, min=1e-12), max=1.0)
    scale = factor * example_mask.to(torch.float32)
    out = tree_map(lambda g, m: scaled_masked_sum(m, scale).reshape(g.shape[1:]),
                   per_example_grads, mats)
    if return_norms:
        return out, norms
    return out
