"""Hopper flash-attention kernels vs their plain PyTorch version, on the card.

Needs an NVIDIA card and nvcc: every test here skips with a reason where
CUDA is absent. Run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` because the repo's conftest configures JAX, which the
port's machine does not need.)
"""

import numpy as np
import pytest
import torch

from fl4health_tpu_torch.kernels import flash_attention as fa

pytestmark = pytest.mark.cuda

# f32 bounds of the JAX kernel tests (tests/kernels/test_flash_attention.py)
F32_FWD = dict(atol=2e-5, rtol=1e-4)
F32_GRAD_ATOL = 5e-4
# bf16 inputs against the plain version in f32 on the same bf16-rounded
# inputs: one bf16 rounding of out, dq, dk and dv (at most 2^-8 relative;
# rtol is twice that) plus f32 summation noise (atol). The tensor-core
# kernels also round P and dS to bf16 as operands: out, dq, dk and dv are
# held to fa.bf16_operand_bounds, which adds that rounding's term to these;
# the CUDA-core route keeps BF16_OUT and BF16_GRAD. lse stays f32 in the
# kernels: the f32 bound.
BF16_OUT = dict(atol=1e-4, rtol=2**-7)
BF16_GRAD = dict(atol=1e-4, rtol=2**-7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, t, h, d, lengths, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(rng.standard_normal((b, t, h, d)),
                                dtype=torch.float32) for _ in range(4))
    dlse = torch.tensor(rng.standard_normal((b, h, t)), dtype=torch.float32)
    mask = torch.tensor(np.arange(t)[None, :] < np.asarray(lengths)[:, None],
                        dtype=torch.float32)
    to = lambda x: x.to(device=device, dtype=dtype)  # noqa: E731
    return to(q), to(k), to(v), mask.to(device), to(do), dlse.to(device)


def _run(fn, q, k, v, mask, do, dlse):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out, lse = fn(q, k, v, mask)
    torch.autograd.backward([out.float(), lse], [do.float(), dlse])
    return out, lse, q.grad, k.grad, v.grad


@pytest.mark.parametrize("t,d,lengths", [
    (128, 64, [128, 70]),
    (100, 64, [100, 0]),       # ragged T and a batch element with no real key
    (77, 16, [77, 33]),
    (130, 32, [90, 130]),      # three tiles, the last a partial one
])
def test_kernels_match_plain_f32(cuda, t, d, lengths):
    q, k, v, mask, do, dlse = _inputs(2, t, 3, d, lengths, torch.float32, cuda)
    fa.reset_launch_counts()
    got = _run(lambda *a: fa._FlashAttention.apply(*a), q, k, v, mask, do, dlse)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    want = _run(fa.flash_attention_reference, q, k, v, mask, do, dlse)
    torch.testing.assert_close(got[0], want[0], **F32_FWD)
    torch.testing.assert_close(got[1], want[1], **F32_FWD)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, atol=F32_GRAD_ATOL, rtol=1e-4)


def test_fully_padded_row_is_finite(cuda):
    q, k, v, mask, _, _ = _inputs(2, 64, 2, 64, [64, 0], torch.float32, cuda)
    out, lse = fa.flash_fwd(q, k, v, mask)
    assert torch.all(out[1] == 0)
    assert torch.isfinite(lse).all()
    want = torch.tensor(-1e30, dtype=torch.float32) + torch.log(
        torch.tensor(1e-20, dtype=torch.float32))
    assert torch.all(lse[1] == want.to(cuda))


def _within(got, want, bound, name):
    diff = (got.float() - want).abs()
    assert torch.isfinite(got.float()).all(), name
    assert bool((diff <= bound).all()), (
        f"{name}: {int((diff > bound).sum())} beyond the bound, "
        f"share used {float((diff / bound).max()):.3f}")


@pytest.mark.parametrize("t,d", [
    pytest.param(128, 64, id="128"),
    pytest.param(96, 64, id="96"),
    pytest.param(2000, 64, id="2000"),
    # head dim 12 (24-byte rows, no TMA stride): the CUDA-core kernels, held
    # to BF16_OUT and BF16_GRAD
    pytest.param(96, 12, id="96-d12"),
    pytest.param(2000, 12, id="2000-d12"),
])
def test_kernels_match_plain_bf16(cuda, t, d):
    q, k, v, mask, do, dlse = _inputs(2, t, 2, d, [t, t // 2], torch.bfloat16,
                                      cuda, seed=1)
    tensor_cores = fa.wgmma_route(q)
    assert tensor_cores is (d == 64)
    got = _run(lambda *a: fa._FlashAttention.apply(*a), q, k, v, mask, do, dlse)
    assert got[0].dtype == torch.bfloat16 and got[2].dtype == torch.bfloat16
    with torch.no_grad():
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        out, lse = fa.flash_attention_reference(qf, kf, vf, mask)
        # the backward reads delta from O as handed out, in bf16 (as the JAX
        # _bwd_call does): the plain backward reads the kernel path's O
        delta = fa.backward_delta(do, got[0], dlse)
        want = [fa.flash_bwd_dq_reference(qf, kf, vf, mask, dof, lse, delta),
                *fa.flash_bwd_dkv_reference(qf, kf, vf, mask, dof, lse, delta)]
        bounds = fa.bf16_operand_bounds(qf, kf, vf, mask, dof, lse, delta, **BF16_OUT)
    torch.testing.assert_close(got[1], lse, **F32_FWD)
    if tensor_cores:
        _within(got[0], out, bounds["out"], "out")
        for name, g, w in zip(("dq", "dk", "dv"), got[2:], want):
            _within(g, w, bounds[name], name)
    else:
        torch.testing.assert_close(got[0].float(), out, **BF16_OUT)
        for g, w in zip(got[2:], want):
            torch.testing.assert_close(g.float(), w, **BF16_GRAD)


@pytest.mark.parametrize("t,d,lengths", [
    (96, 64, [96, 0]),     # a batch element with no real key
    (2000, 64, [2000, 1100]),
    (130, 32, [90, 130]),  # head dim 32: box columns past d arrive as zeros
    (77, 16, [77, 40]),
    (128, 64, [128, 64]),  # whole tiles, one of them all padding
])
def test_tensor_core_kernels_match_plain(cuda, t, d, lengths):
    """The forward, dQ and dK/dV kernels alone, on the kernel's lse and the
    delta of its out, held to the derived bounds."""
    q, k, v, mask, do, dlse = _inputs(2, t, 3, d, lengths, torch.bfloat16, cuda, seed=t)
    assert fa.wgmma_route(q)
    with torch.no_grad():
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        out, lse = fa.flash_fwd(q, k, v, mask)
        ref_out, ref_lse = fa.flash_attention_reference(qf, kf, vf, mask)
        delta = fa.backward_delta(do, out, dlse)
        dq = fa.flash_bwd_dq(q, k, v, mask, do, lse, delta)
        ref_dq = fa.flash_bwd_dq_reference(qf, kf, vf, mask, dof, lse, delta)
        dk, dv = fa.flash_bwd_dkv(q, k, v, mask, do, lse, delta)
        ref_dk, ref_dv = fa.flash_bwd_dkv_reference(qf, kf, vf, mask, dof, lse, delta)
        bounds = fa.bf16_operand_bounds(qf, kf, vf, mask, dof, lse, delta, **BF16_OUT)
    _within(out, ref_out, bounds["out"], "out")
    torch.testing.assert_close(lse, ref_lse, **F32_FWD)
    _within(dq, ref_dq, bounds["dq"], "dq")
    _within(dk, ref_dk, bounds["dk"], "dk")
    _within(dv, ref_dv, bounds["dv"], "dv")
    if 0 in lengths:
        empty = lengths.index(0)
        assert torch.all(out[empty] == 0) and torch.all(dq[empty] == 0)
        assert torch.all(dk[empty] == 0) and torch.all(dv[empty] == 0)


def test_tensor_core_kernels_are_bit_reproducible(cuda):
    q, k, v, mask, do, dlse = _inputs(2, 2000, 4, 64, [2000, 1300], torch.bfloat16,
                                      cuda, seed=5)
    with torch.no_grad():
        runs = []
        for _ in range(3):
            out, lse = fa.flash_fwd(q, k, v, mask)
            delta = fa.backward_delta(do, out, dlse)
            runs.append((out, lse, fa.flash_bwd_dq(q, k, v, mask, do, lse, delta),
                         *fa.flash_bwd_dkv(q, k, v, mask, do, lse, delta)))
    for again in runs[1:]:
        for a, b in zip(runs[0], again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,d,tensor_cores", [
    (torch.bfloat16, 64, True),
    (torch.bfloat16, 32, True),
    (torch.bfloat16, 12, False),   # 24-byte rows: not a TMA stride
    (torch.float32, 64, False),
])
def test_route_follows_the_shape_rule(cuda, dtype, d, tensor_cores):
    q, k, v, mask, do, dlse = _inputs(1, 70, 2, d, [60], dtype, cuda)
    assert fa.wgmma_route(q) is tensor_cores
    fa.reset_launch_counts()
    _run(lambda *a: fa._FlashAttention.apply(*a), q, k, v, mask, do, dlse)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    n = int(tensor_cores)
    assert fa.WGMMA_LAUNCHES == {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def test_public_api_dispatches_to_kernels(cuda):
    q, k, v, mask, _, _ = _inputs(1, 64, 2, 32, [50], torch.float32, cuda)
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v, mask)
    assert fa.LAUNCHES["flash_fwd"] == 1
    want, _ = fa.flash_attention_reference(q, k, v, mask)
    torch.testing.assert_close(out, want, **F32_FWD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dims_above_64_are_refused(cuda, dtype):
    q, k, v, mask, _, _ = _inputs(1, 16, 1, 128, [16], dtype, cuda)
    with pytest.raises(ValueError, match="head dims up to 64"):
        fa.flash_fwd(q, k, v, mask)
