"""Flash attention: exact softmax attention under a key-padding mask, with
hand-written Hopper kernels for the forward pass and both backward passes.

Counterpart of ``fl4health_tpu/kernels/flash_attention.py``. The three
Pallas kernels there (``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel``) become CUDA kernels in ``csrc/``, built for ``sm_90a``
with ``torch.utils.cpp_extension.load`` at first use (never at import) into
``kernels/_build/``. ``_FlashAttention`` is the ``torch.autograd.Function``
counterpart of ``_flash_padded_lse``: its forward launches the forward
kernel, its backward calls ``_FlashAttentionGrads``, a second Function that
launches the dQ and dK/dV kernels.

Both Functions have a ``vmap`` rule, so attention runs under the
simulation's ``torch.func.vmap`` over clients (JAX's ``vmap(client_fit)``,
under which Pallas batches its kernels): the rule folds the vmapped axis
into the batch axis and calls the Function again, so one launch serves
every client. The key mask is a stack ``[N, B / N, T]`` of row blocks that
the kernels read through a block stride (``csrc/flash_mask.cuh``): a mask
that was not vmapped is expanded over the clients with stride 0, never
copied.

Two routes, chosen by a shape rule (``wgmma_route``), never on failure:
bf16 inputs whose head dim d is at most 64 with ``2 d`` bytes a multiple of
16 (TMA's stride rule) run all three kernels on the tensor cores
(``csrc/flash_attention_wgmma.cu``: bf16 ``wgmma`` over TMA-fed tiles, P and
dS rounded to bf16 as operands, as the JAX kernel's ``Precision.DEFAULT``
does on its chip; ``bf16_operand_bounds`` states what that may cost). f32
inputs and other bf16 head dims run the IEEE-f32 CUDA-core kernels of
``csrc/flash_attention.cu``.

Dispatch is on the tensor's device, inside both Functions: a CUDA tensor
launches the kernels (or raises), a CPU tensor runs
``flash_attention_reference`` and the plain backward versions beside it,
with the same ``(out, lse)`` contract, through the same rules. Nothing
swaps one for the other on failure. Fake tensors (round-program
introspection, ``kernels/fake.py``) take each kernel wrapper's fake branch
on either device: outputs of the right shape, the call reported to the op
counter, no launch and no count in ``LAUNCHES``.

Contract (same as the JAX function): q, k, v are ``[B, T, H, D]``;
``pad_mask`` ``[B, T]`` marks real keys with 1 and is not differentiable;
``out`` is ``[B, T, H, D]`` in ``q.dtype`` and ``lse`` ``[B, H, T]`` f32 is a
differentiable output. A query row with no real key gets ``out = 0`` and
``lse = -1e30 + log(1e-20)``: finite, not ``-inf``. f32 inputs are computed
with IEEE f32 FMAs (no TF32, as the JAX kernel forces ``Precision.HIGHEST``).
"""

from __future__ import annotations

import functools

import torch

from fl4health_tpu_torch.kernels import fake
from fl4health_tpu_torch.kernels.build import load_extension
from fl4health_tpu_torch.kernels.fold import fold_vmapped

NEG_INF = -1e30

# Kernel launches since the last reset: one per launch, counted by the wrapper
# right after the launch succeeded (the plain version never counts).
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
# Of those, the launches that took the tensor-core route (``wgmma_route``).
WGMMA_LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

# bf16 unit roundoff: one round-to-nearest to bf16 moves x by at most u |x|
BF16_UNIT = 2.0 ** -8


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, WGMMA_LAUNCHES):
        for name in counts:
            counts[name] = 0


@functools.cache
def build_extension():
    """Compile (or load from ``_build/``) the kernels for sm_90a. Needs
    ``nvcc``; called on the first CUDA launch."""
    return load_extension("flash_attention", ["flash_attention_binding.cpp",
                                              "flash_attention.cu",
                                              "flash_attention_wgmma.cu"])


def wgmma_route(q: torch.Tensor) -> bool:
    """The shape rule for the tensor-core forward, dQ and dK/dV kernels:
    bf16 with ``2 d`` a multiple of 16 bytes (a TMA stride must be).
    Everything else takes the CUDA-core kernels; head dims above 64 are
    refused by both routes."""
    return q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    pad_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense-score attention in f32 with the kernels' ``(out, lse)`` contract,
    differentiated by autograd. Used on the CPU and as the yardstick the
    kernels are held against on the card."""
    b, t, h, d = q.shape
    if pad_mask is None:
        pad_mask = torch.ones((b, t), dtype=torch.float32, device=q.device)
    valid = (pad_mask.detach() > 0)[:, None, None, :]  # [B, 1, 1, Tk]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # [B, H, T, D]
    s = torch.matmul(qf * (1.0 / d ** 0.5), kf.transpose(-1, -2))
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    # lse and out do not depend on the shift m; detaching it keeps autograd
    # from routing a gradient through the argmax
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    out = torch.matmul(p, vf) / denom
    lse = (m + torch.log(denom))[..., 0]  # [B, H, T]
    return out.transpose(1, 2).to(q.dtype), lse


def _bwd_reference_terms(q, k, v, mask, dout, lse, delta):
    """Dense P and dS of the backward kernels, [B, H, T, T] f32, with the
    operands as [B, H, T, D] f32."""
    d = q.shape[-1]
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, dout))
    valid = (mask > 0)[:, None, None, :]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / d ** 0.5)
    p = torch.where(valid, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * (1.0 / d ** 0.5)
    return qf, kf, dof, p, ds


def flash_bwd_dq_reference(q, k, v, mask, dout, lse, delta) -> torch.Tensor:
    """Plain version of the dQ kernel on the same inputs."""
    _, kf, _, _, ds = _bwd_reference_terms(q, k, v, mask, dout, lse, delta)
    return torch.matmul(ds, kf).transpose(1, 2).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, mask, dout, lse, delta
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel on the same inputs."""
    qf, _, dof, p, ds = _bwd_reference_terms(q, k, v, mask, dout, lse, delta)
    dk = torch.matmul(ds.transpose(-1, -2), qf).transpose(1, 2).to(k.dtype)
    dv = torch.matmul(p.transpose(-1, -2), dof).transpose(1, 2).to(v.dtype)
    return dk, dv


def bf16_operand_bounds(q, k, v, mask, dout=None, lse=None, delta=None, *,
                        atol: float, rtol: float, unit: float = BF16_UNIT
                        ) -> dict[str, torch.Tensor]:
    """Per-element bounds on |kernel - plain version| for the tensor-core
    route, from the plain versions in f32 on the same inputs.

    Each output gets ``atol + rtol |ref|`` (f32 summation order, and the one
    rounding of the output to bf16; rtol is twice ``unit``) plus the cost of
    the one bf16 rounding of the operand that the route rounds, each element
    of which moves by at most ``unit`` times itself:

    - ``out``: P is rounded before P V, so ``unit * sum_k p |v| / l``, which
      is the plain forward on ``|v|``;
    - ``dv``: P^T is rounded before P^T dO, so ``unit * P^T |dO|``, the
      plain dK/dV on ``|dO|``;
    - ``dk``: dS^T is rounded before dS^T Q, so ``unit * |dS|^T |Q|``;
    - ``dq``: dS is rounded before dS K, so ``unit * |dS| |K|``.

    Q K^T and dO V^T are products of bf16 values, exact in f32, so nothing
    else is rounded. With ``unit = 0`` the bounds are the f32 bounds
    ``atol + rtol |ref|``. ``dq``, ``dk`` and ``dv`` need ``dout``, ``lse``
    and ``delta``; lse keeps the bound of the CUDA-core route."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    with torch.no_grad():
        out, _ = flash_attention_reference(qf, kf, vf, mask)
        out_abs, _ = flash_attention_reference(qf, kf, vf.abs(), mask)
        bounds = {"out": atol + rtol * out.abs() + unit * out_abs}
        if dout is not None:
            # one dense P and dS serve every gradient and its rounding term
            qh, kh, doh, p, ds = _bwd_reference_terms(qf, kf, vf, mask, dout.float(),
                                                      lse, delta)
            ds_abs = ds.abs()
            terms = {  # name: (plain gradient, absolute product of the rounded operand)
                "dq": (torch.matmul(ds, kh), torch.matmul(ds_abs, kh.abs())),
                "dk": (torch.matmul(ds.transpose(-1, -2), qh),
                       torch.matmul(ds_abs.transpose(-1, -2), qh.abs())),
                "dv": (torch.matmul(p.transpose(-1, -2), doh),
                       torch.matmul(p.transpose(-1, -2), doh.abs())),
            }
            for name, (ref, rounded) in terms.items():
                bounds[name] = (atol + rtol * ref.abs() + unit * rounded).transpose(1, 2)
    return bounds


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _mask_stack(mask: torch.Tensor) -> torch.Tensor:
    """A key mask as the kernels read it: a ``[B, T]`` mask is one block of
    B rows (a view); an ``[N, B / N, T]`` stack stays as it is."""
    return mask[None] if mask.ndim == 2 else mask


def _mask_args(mask: torch.Tensor) -> tuple[int, int, int]:
    """(pointer, rows a block, block stride in floats) of a mask stack."""
    n, rows, _ = mask.shape
    return mask.data_ptr(), rows, (mask.stride(0) if n > 1 else 0)


def _check_inputs(q, k, v, mask) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash kernels need CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"{name} must match q in shape, dtype and device: "
                f"{tuple(x.shape)} {x.dtype} {x.device} vs "
                f"{tuple(q.shape)} {q.dtype} {q.device}")
    b, t, h, d = q.shape
    if d > 64:
        raise ValueError(f"flash kernels take head dims up to 64, got {d}")
    if b * h > 65535:
        raise ValueError(f"batch*heads={b * h} exceeds the grid limit 65535")
    if (mask.ndim != 3 or mask.shape[0] * mask.shape[1] != b or mask.shape[2] != t
            or mask.dtype != torch.float32 or mask.device != q.device):
        raise ValueError(f"pad_mask must be f32 [{b}, {t}] (or [N, {b} / N, {t}]) on "
                         f"{q.device}, got {mask.dtype} {tuple(mask.shape)} {mask.device}")
    if mask.stride(2) != 1 or (mask.shape[1] > 1 and mask.stride(1) != t):
        raise ValueError(f"pad_mask rows must be contiguous, got strides {mask.stride()}")
    for x in (q, k, v):
        if not x.is_contiguous():
            raise ValueError("flash kernels take contiguous tensors")


def _check_backward_inputs(q, dout, lse, delta) -> None:
    b, t, h, _ = q.shape
    if (dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device
            or not dout.is_contiguous()):
        raise ValueError(f"dout must be a contiguous {q.dtype} {tuple(q.shape)}, "
                         f"got {dout.dtype} {tuple(dout.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.shape != (b, h, t) or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name} must be a contiguous f32 [{b}, {h}, {t}] on "
                             f"{q.device}, got {x.dtype} {tuple(x.shape)} {x.device}")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: {build_extension().error_string(err)}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd(q, k, v, mask) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: ``(out [B,T,H,D] in q.dtype, lse [B,H,T] f32)``;
    ``mask`` is ``[B, T]`` or an ``[N, B / N, T]`` stack."""
    if fake.is_fake(q):
        b, t, h, _ = q.shape
        outs = (torch.empty_like(q),
                torch.empty((b, h, t), dtype=torch.float32, device=q.device))
        return fake.report("flash_fwd", (q, k, v, mask), outs)
    mask = _mask_stack(mask)
    _check_inputs(q, k, v, mask)
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *_mask_args(mask),
            out.data_ptr(), lse.data_ptr(), b, t, h, d, 1.0 / d ** 0.5)
    tensor_cores = wgmma_route(q)
    if tensor_cores:
        err = build_extension().fwd_wgmma(*ptrs, _stream(q))
    else:
        err = build_extension().fwd(*ptrs, q.dtype == torch.bfloat16, _stream(q))
    _raise_on(err, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    WGMMA_LAUNCHES["flash_fwd"] += tensor_cores
    return out, lse


def flash_bwd_dq(q, k, v, mask, dout, lse, delta) -> torch.Tensor:
    """dQ kernel; ``delta = rowsum(dO * O) - dlse`` as [B,H,T] f32."""
    if fake.is_fake(q):
        return fake.report("flash_bwd_dq", (q, k, v, mask, dout, lse, delta),
                           torch.empty_like(q))
    mask = _mask_stack(mask)
    _check_inputs(q, k, v, mask)
    _check_backward_inputs(q, dout, lse, delta)
    b, t, h, d = q.shape
    dq = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *_mask_args(mask),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, t, h, d, 1.0 / d ** 0.5)
    tensor_cores = wgmma_route(q)
    if tensor_cores:
        err = build_extension().bwd_dq_wgmma(*ptrs, _stream(q))
    else:
        err = build_extension().bwd_dq(*ptrs, q.dtype == torch.bfloat16, _stream(q))
    _raise_on(err, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    WGMMA_LAUNCHES["flash_bwd_dq"] += tensor_cores
    return dq


def flash_bwd_dkv(q, k, v, mask, dout, lse, delta
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """dK/dV kernel."""
    if fake.is_fake(q):
        return fake.report("flash_bwd_dkv", (q, k, v, mask, dout, lse, delta),
                           (torch.empty_like(k), torch.empty_like(v)))
    mask = _mask_stack(mask)
    _check_inputs(q, k, v, mask)
    _check_backward_inputs(q, dout, lse, delta)
    b, t, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *_mask_args(mask),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, t, h, d, 1.0 / d ** 0.5)
    tensor_cores = wgmma_route(q)
    if tensor_cores:
        err = build_extension().bwd_dkv_wgmma(*ptrs, _stream(q))
    else:
        err = build_extension().bwd_dkv(*ptrs, q.dtype == torch.bfloat16, _stream(q))
    _raise_on(err, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    WGMMA_LAUNCHES["flash_bwd_dkv"] += tensor_cores
    return dk, dv


def backward_delta(dout, out, dlse) -> torch.Tensor:
    """``rowsum(dO * O) - dlse`` as [B, H, T] f32 — outside the kernels, as
    in the JAX ``_bwd_call``. lse's cotangent enters the score gradient as
    ``p * (dP - delta + dlse)``, so the kernels stay the same for both APIs."""
    rowsum = (dout.float() * out.float()).sum(dim=-1)  # [B, T, H]
    return (rowsum.transpose(1, 2) - dlse.float()).contiguous()


# ---------------------------------------------------------------------------
# autograd.Functions with client-vmap rules
# ---------------------------------------------------------------------------

def _unfold(x: torch.Tensor, size: int) -> torch.Tensor:
    return x.view(size, x.shape[0] // size, *x.shape[1:])


def _plain_mask(mask: torch.Tensor) -> torch.Tensor:
    """A mask stack as the plain versions take it, ``[B, T]``."""
    return mask.reshape(-1, mask.shape[-1])


class _FlashAttention(torch.autograd.Function):
    """``(out, lse)`` with both outputs differentiable; the mask stack gets
    no gradient (counterpart of ``_flash_padded_lse``)."""

    @staticmethod
    def forward(q, k, v, mask):
        if q.device.type == "cuda" or fake.is_fake(q):
            return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), mask)
        return flash_attention_reference(q, k, v, _plain_mask(mask))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, *output)

    @staticmethod
    def backward(ctx, dout, dlse):
        dq, dk, dv = _FlashAttentionGrads.apply(*ctx.saved_tensors, dout, dlse)
        return dq, dk, dv, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, mask):
        n = info.batch_size
        out, lse = _FlashAttention.apply(*(fold_vmapped(x, d, n)[0] for x, d in
                                           zip((q, k, v), in_dims)),
                                         fold_vmapped(mask, in_dims[3], n)[0])
        return (_unfold(out, n), _unfold(lse, n)), (0, 0)


class _FlashAttentionGrads(torch.autograd.Function):
    """``(dq, dk, dv)`` of ``_FlashAttention`` from its saved tensors and the
    cotangents of ``(out, lse)``: ``delta`` in plain tensor code, then the
    dQ and dK/dV kernels. A Function of its own so that the backward, which
    receives vmapped cotangents under the client vmap, launches through a
    ``vmap`` rule too."""

    @staticmethod
    def forward(q, k, v, mask, out, lse, dout, dlse):
        delta = backward_delta(dout, out, dlse)
        if q.device.type == "cuda" or fake.is_fake(q):
            q, k, v, dout = (x.contiguous() for x in (q, k, v, dout))
            return (flash_bwd_dq(q, k, v, mask, dout, lse, delta),
                    *flash_bwd_dkv(q, k, v, mask, dout, lse, delta))
        mask = _plain_mask(mask)
        return (flash_bwd_dq_reference(q, k, v, mask, dout, lse, delta),
                *flash_bwd_dkv_reference(q, k, v, mask, dout, lse, delta))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass  # never differentiated: the attention's gradients are first order

    @staticmethod
    def vmap(info, in_dims, q, k, v, mask, out, lse, dout, dlse):
        n = info.batch_size
        args = [fold_vmapped(x, d, n)[0] for x, d in zip((q, k, v), in_dims[:3])]
        args.append(fold_vmapped(mask, in_dims[3], n)[0])
        args += [fold_vmapped(x, d, n)[0].contiguous() for x, d in
                 zip((out, lse, dout, dlse), in_dims[4:])]
        grads = _FlashAttentionGrads.apply(*args)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


# ---------------------------------------------------------------------------
# Public functions
# ---------------------------------------------------------------------------

def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    pad_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out [B,T,H,D], lse [B,H,T])``, lse differentiable.

    The JAX function's ``block_q``/``block_k`` have no counterpart: the
    Hopper kernels tile 64 x 64 and the plain version is dense."""
    b, t = q.shape[:2]
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    if pad_mask is None:
        pad_mask = torch.ones((b, t), dtype=torch.float32, device=q.device)
    pad_mask = pad_mask.detach().to(torch.float32)
    return _FlashAttention.apply(q, k, v, _mask_stack(pad_mask))


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    pad_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Exact softmax attention, flash-style; ``[B, T, H, D]`` out."""
    out, _ = flash_attention_lse(q, k, v, pad_mask)
    return out
