"""The port's flash attention (plain version, on the CPU) against the JAX
``flash_attention_lse`` (Pallas interpret mode on the CPU): the same numpy
inputs through both, forward and gradients, at the JAX kernel tests' bounds
(tests/kernels/test_flash_attention.py: fwd atol 2e-5 / rtol 1e-4, grads
atol 5e-4)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu_torch.kernels import flash_attention as tfa

# the package re-exports the function under the module's name
jfa = importlib.import_module("fl4health_tpu.kernels.flash_attention")

FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=5e-4, rtol=1e-4)


def _inputs(b, t, h, d, lengths, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.standard_normal((b, h, t)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return q, k, v, mask, do, dlse


def _jax(q, k, v, mask, do, dlse, block):
    fn = lambda q, k, v: jfa.flash_attention_lse(  # noqa: E731
        q, k, v, jnp.asarray(mask), block_q=block, block_k=block)
    (out, lse), vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    return [np.asarray(x) for x in (out, lse, *grads)]


def _torch(q, k, v, mask, do, dlse):
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, lse = tfa.flash_attention_lse(q, k, v, torch.tensor(mask))
    torch.autograd.backward([out, lse], [torch.tensor(do), torch.tensor(dlse)])
    return [x.detach().numpy() for x in (out, lse, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("t,d,lengths", [
    (32, 16, [32, 20]),
    (40, 16, [40, 0]),   # T not a multiple of the block; one row all padding
    (24, 64, [24, 9]),   # T not a multiple of the block at the slice's head dim
])
def test_plain_version_matches_jax_kernel(t, d, lengths):
    inputs = _inputs(2, t, 2, d, lengths, seed=t + d)
    want = _jax(*inputs, block=16)
    got = _torch(*inputs)
    for name, g, w in zip(("out", "lse"), got[:2], want[:2]):
        np.testing.assert_allclose(g, w, err_msg=name, **FWD)
    for name, g, w in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD)


def test_fully_padded_row_gives_zero_out_and_finite_lse():
    q, k, v, mask, _, _ = _inputs(2, 20, 1, 16, [20, 0], seed=3)
    out, lse = tfa.flash_attention_lse(torch.tensor(q), torch.tensor(k),
                                       torch.tensor(v), torch.tensor(mask))
    assert torch.all(out[1] == 0)
    expect = np.float32(-1e30) + np.log(np.float32(1e-20))
    np.testing.assert_array_equal(lse[1].numpy(), np.full((1, 20), expect, np.float32))
    _, jlse = jfa.flash_attention_lse(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(mask),
                                      block_q=16, block_k=16)
    np.testing.assert_array_equal(lse[1].numpy(), np.asarray(jlse)[1])


def test_flash_attention_drops_lse_and_keeps_dtype():
    q, k, v, mask, _, _ = _inputs(1, 16, 2, 16, [12], seed=4)
    out = tfa.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                              torch.tensor(mask))
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(mask), block_q=16, block_k=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD)
    bf = tfa.flash_attention(*(torch.tensor(x, dtype=torch.bfloat16) for x in (q, k, v)))
    assert bf.dtype == torch.bfloat16


def test_pad_mask_gets_no_gradient():
    q, k, v, mask, _, _ = _inputs(1, 16, 1, 16, [10], seed=5)
    m = torch.tensor(mask, requires_grad=True)
    out = tfa.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), m)
    assert not out.requires_grad


def test_cpu_tensors_never_launch_kernels():
    tfa.reset_launch_counts()
    q, k, v, mask, _, _ = _inputs(1, 16, 1, 16, [16], seed=6)
    tfa.flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v))
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_kernel_wrapper_rejects_cpu_tensors_without_building():
    x = torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_fwd(x, x, x, torch.ones((1, 8)))
    assert tfa.build_extension.cache_info().currsize == 0


def test_backward_delta_folds_in_the_lse_cotangent():
    rng = np.random.default_rng(7)
    do, o = (torch.tensor(rng.standard_normal((2, 5, 3, 4)), dtype=torch.float32)
             for _ in range(2))
    dlse = torch.tensor(rng.standard_normal((2, 3, 5)), dtype=torch.float32)
    want = np.sum(do.numpy() * o.numpy(), axis=-1).transpose(0, 2, 1) - dlse.numpy()
    np.testing.assert_allclose(tfa.backward_delta(do, o, dlse).numpy(), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t,lengths", [(40, [40, 0]), (24, [24, 9])])
def test_per_kernel_backward_references_match_the_jax_gradients(t, lengths):
    # the plain versions the dQ and dK/dV kernels are held against on the card
    q, k, v, mask, do, dlse = _inputs(2, t, 2, 16, lengths, seed=t)
    want = _jax(q, k, v, mask, do, dlse, block=16)
    tq, tk, tv, tm, tdo = (torch.tensor(x) for x in (q, k, v, mask, do))
    out, lse = tfa.flash_attention_reference(tq, tk, tv, tm)
    delta = tfa.backward_delta(tdo, out, torch.tensor(dlse))
    dq = tfa.flash_bwd_dq_reference(tq, tk, tv, tm, tdo, lse, delta)
    dk, dv = tfa.flash_bwd_dkv_reference(tq, tk, tv, tm, tdo, lse, delta)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want[2:]):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **GRAD)
