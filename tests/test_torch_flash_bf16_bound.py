"""The bf16 operand bounds of the tensor-core flash-attention route
(``bf16_operand_bounds`` in fl4health_tpu_torch/kernels/flash_attention.py),
on the CPU.

The tensor-core kernels round four operands to bf16 that the plain version
keeps in f32: P before P V (forward), dS before dS K (dQ), P^T before P^T dO
and dS^T before dS^T Q (dK/dV); they round out, dQ, dK and dV to bf16. A
dense emulation of exactly that, in plain torch, must stay within the bounds
of the f32 plain version; an emulation that rounds P and dS four times as
coarsely (to a unit roundoff of 2^-6) must break them; and with no rounding
the bounds are the f32 bounds. The JAX kernels in bf16 (Pallas interpret
mode) stay within them too.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module("fl4health_tpu.kernels.flash_attention")

# the bounds the card holds the bf16 kernels to (chip_smoke.py, the card tests)
ATOL, RTOL = 1e-4, 2 ** -7

CASES = [
    (2, 64, 2, 64, [64, 37]),    # one tile, a ragged mask
    (2, 100, 2, 32, [100, 0]),   # ragged T; a batch element with no real key
    (1, 130, 3, 64, [77]),       # three tiles, the last partial
    (2, 48, 1, 16, [5, 48]),     # a row attending to five keys
]


def _inputs(b, t, h, d, lengths, seed):
    """bf16-valued q, k, v, dout (the operands the kernels read), the mask,
    and the plain version's lse and delta (from its own out in bf16, as the
    backward reads it)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(rng.standard_normal((b, t, h, d)), dtype=torch.float32)
                   .to(torch.bfloat16).float() for _ in range(4))
    dlse = torch.tensor(rng.standard_normal((b, h, t)), dtype=torch.float32)
    mask = torch.tensor(np.arange(t)[None, :] < np.asarray(lengths)[:, None],
                        dtype=torch.float32)
    out, lse = tfa.flash_attention_reference(q, k, v, mask)
    delta = tfa.backward_delta(do, out.to(torch.bfloat16), dlse)
    return q, k, v, mask, do, lse, delta


def _round_to(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Round to ``bits`` significant bits (unit roundoff 2^-bits)."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 2.0 ** bits) / 2.0 ** bits, e)


def _emulate(q, k, v, mask, do, lse, delta, rnd, out_rnd):
    """The tensor-core route, densely: f32 logits and P (l sums the f32 P),
    ``rnd`` applied to P, dS, P^T and dS^T before their products,
    ``out_rnd`` to out, dQ, dK and dV."""
    d = q.shape[-1]
    qf, kf, vf, dof = (x.transpose(1, 2) for x in (q, k, v, do))
    valid = (mask > 0)[:, None, None, :]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / d ** 0.5)
    s = torch.where(valid, s, torch.full_like(s, tfa.NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    out = out_rnd(torch.matmul(rnd(p), vf) / denom).transpose(1, 2)
    p = torch.where(valid, torch.exp(
        torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / d ** 0.5) - lse[..., None]),
        torch.zeros_like(s))
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None]) * (1.0 / d ** 0.5)
    dv = out_rnd(torch.matmul(rnd(p).transpose(-1, -2), dof)).transpose(1, 2)
    dk = out_rnd(torch.matmul(rnd(ds).transpose(-1, -2), qf)).transpose(1, 2)
    dq = out_rnd(torch.matmul(rnd(ds), kf)).transpose(1, 2)
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _plain(q, k, v, mask, do, lse, delta):
    out, _ = tfa.flash_attention_reference(q, k, v, mask)
    dq = tfa.flash_bwd_dq_reference(q, k, v, mask, do, lse, delta)
    dk, dv = tfa.flash_bwd_dkv_reference(q, k, v, mask, do, lse, delta)
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


def _shares(got, want, bounds):
    """The largest share of its bound that an element uses, per output."""
    return {n: float(((got[n] - want[n]).abs() / bounds[n]).max()) for n in bounds}


@pytest.mark.parametrize("b,t,h,d,lengths", CASES)
def test_bf16_emulation_within_bounds(b, t, h, d, lengths):
    inputs = _inputs(b, t, h, d, lengths, seed=t + d)
    bounds = tfa.bf16_operand_bounds(*inputs, atol=ATOL, rtol=RTOL)
    shares = _shares(_emulate(*inputs, rnd=_bf16, out_rnd=_bf16), _plain(*inputs), bounds)
    # within the bounds, and using a real share of them: the worst element
    # of each output uses 10-100% (measured 27-61% over these cases)
    for name, share in shares.items():
        assert 0.1 < share <= 1.0, (name, shares)


@pytest.mark.parametrize("b,t,h,d,lengths", CASES)
def test_coarser_rounding_breaks_bounds(b, t, h, d, lengths):
    """P, dS, P^T and dS^T rounded to a unit roundoff of 2^-6 (four times bf16's)
    break the bound of some output, and use at least 2.5 times the share
    that bf16 rounding uses in every output (measured 2.8-4.5 times): the
    bounds scale with the rounding they account for."""
    inputs = _inputs(b, t, h, d, lengths, seed=t + d)
    bounds = tfa.bf16_operand_bounds(*inputs, atol=ATOL, rtol=RTOL)
    want = _plain(*inputs)
    fine = _shares(_emulate(*inputs, rnd=_bf16, out_rnd=_bf16), want, bounds)
    coarse = _shares(_emulate(*inputs, rnd=lambda x: _round_to(x, 6), out_rnd=_bf16),
                     want, bounds)
    assert max(coarse.values()) > 1.0, coarse
    for name in bounds:
        assert coarse[name] >= 2.5 * fine[name], (name, fine, coarse)


@pytest.mark.parametrize("b,t,h,d,lengths", CASES)
def test_no_rounding_gives_f32_bounds(b, t, h, d, lengths):
    inputs = _inputs(b, t, h, d, lengths, seed=t + d)
    want = _plain(*inputs)
    bounds = tfa.bf16_operand_bounds(*inputs, atol=2e-5, rtol=1e-4, unit=0.0)
    for name, w in want.items():
        torch.testing.assert_close(bounds[name], 2e-5 + 1e-4 * w.abs(), rtol=0, atol=0)
    # the emulation without any rounding is the plain version, up to f32 order
    exact = _emulate(*inputs, rnd=lambda x: x, out_rnd=lambda x: x)
    assert max(_shares(exact, want, bounds).values()) <= 1.0


def test_bf16_rounding_is_eight_significant_bits():
    x = torch.tensor(np.random.default_rng(0).standard_normal(4096), dtype=torch.float32)
    torch.testing.assert_close(_round_to(x, 8), _bf16(x), rtol=0, atol=0)
    assert float(((_bf16(x) - x).abs() / x.abs()).max()) <= tfa.BF16_UNIT


@pytest.mark.parametrize("b,t,h,d,lengths", CASES[:2])
def test_jax_kernel_bf16_within_bounds(b, t, h, d, lengths):
    """The JAX forward's out, and its dQ under cotangents (dO, dlse), in
    bf16; the plain dQ reads the JAX kernel's own lse and its delta from the
    JAX out in bf16, as the JAX backward does."""
    q, k, v, mask, do, *_ = _inputs(b, t, h, d, lengths, seed=t + d)
    dlse = np.random.default_rng(t).standard_normal((b, h, t)).astype(np.float32)
    (out, lse), vjp = jax.vjp(
        lambda q_, k_, v_: jfa.flash_attention_lse(q_, k_, v_, jnp.asarray(mask.numpy()),
                                                   block_q=16, block_k=16),
        *(jnp.asarray(x.numpy(), dtype=jnp.bfloat16) for x in (q, k, v)))
    dq, _, _ = vjp((jnp.asarray(do.numpy(), dtype=jnp.bfloat16), jnp.asarray(dlse)))
    got = torch.tensor(np.asarray(out, dtype=np.float32))
    want, _ = tfa.flash_attention_reference(q, k, v, mask)
    jax_lse = torch.tensor(np.asarray(lse, dtype=np.float32))
    delta = tfa.backward_delta(do, got, torch.tensor(dlse))
    bounds = tfa.bf16_operand_bounds(q, k, v, mask, do, jax_lse, delta, atol=ATOL, rtol=RTOL)
    assert bool(((got - want).abs() <= bounds["out"]).all())
    got_dq = torch.tensor(np.asarray(dq, dtype=np.float32))
    want_dq = tfa.flash_bwd_dq_reference(q, k, v, mask, do, jax_lse, delta)
    assert bool(((got_dq - want_dq).abs() <= bounds["dq"]).all())
    if 0 in lengths:
        assert bool((got_dq[lengths.index(0)] == 0).all())


@pytest.mark.parametrize("dtype,d,tensor_cores", [
    (torch.bfloat16, 64, True),    # the transformer's head dim
    (torch.bfloat16, 32, True),
    (torch.bfloat16, 8, True),     # 16-byte rows: the narrowest TMA stride
    (torch.bfloat16, 12, False),   # 24-byte rows are no TMA stride
    (torch.bfloat16, 4, False),    # 8-byte rows are no TMA stride either
    (torch.float32, 64, False),    # f32 keeps IEEE f32 on the CUDA cores
])
def test_wgmma_route_rule(dtype, d, tensor_cores):
    """The shape rule that sends a call to the tensor-core kernels; it reads
    only dtype and head dim, so it holds on any device."""
    assert tfa.wgmma_route(torch.zeros((1, 4, 2, d), dtype=dtype)) is tensor_cores


def test_tensor_core_launches_count_every_kernel_and_the_plain_route_none():
    """dQ has a tensor-core count beside the forward and dK/dV; a CPU tensor
    runs the plain version through autograd and counts no launch on either
    route."""
    assert set(tfa.WGMMA_LAUNCHES) == set(tfa.LAUNCHES) == {
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}
    q, k, v, mask, do, *_ = _inputs(1, 40, 2, 16, [33], seed=4)
    tfa.reset_launch_counts()
    leaves = [x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    assert tfa.wgmma_route(leaves[0])
    out = tfa.flash_attention(*leaves, mask)
    out.float().backward(do)
    assert all(x.grad is not None for x in leaves)
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert tfa.WGMMA_LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
