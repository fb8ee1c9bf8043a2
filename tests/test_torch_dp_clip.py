"""The port's DP clip kernels (plain route on the CPU), DP-SGD primitives and
instance-level accountant against the JAX package, from the same numpy
inputs.

Bounds are the JAX kernel tests' (tests/kernels/test_dp_clip.py): squared
norms rtol 1e-5, sums atol 1e-5, for f32 and bf16 gradients alike: both
packages widen the same bf16 values to f32 and sum f32 products, so they
differ only in summation order. The JAX side runs its Pallas kernels in
interpret mode. Noise cannot match draw for draw (``jax.random`` vs a
``torch.Generator``), so the routes are compared at ``noise_multiplier=0``
and the noise by its statistics."""

import chip_smoke
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fl4health_tpu.kernels import dp_clip as jdp
from fl4health_tpu.privacy import accountants as jacc
from fl4health_tpu.privacy import dpsgd as jdpsgd
from fl4health_tpu_torch.clients import engine as tengine
from fl4health_tpu_torch.kernels import dp_clip as tdp
from fl4health_tpu_torch.privacy import accountants as tacc
from fl4health_tpu_torch.privacy import dpsgd as tdpsgd

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _matrix(b, w, dtype, seed):
    """Seeded [b, w] gradients, rounded to ``dtype`` once, for both packages."""
    x = np.random.default_rng(seed).standard_normal((b, w)).astype(np.float32)
    x = x.astype(DTYPES[dtype][0])
    return jnp.asarray(x), torch.tensor(x.astype(np.float32)).to(DTYPES[dtype][1])


def _tree(b, dtype, seed):
    """A CifarNet-like tree of [b, ...] leaves: conv kernels, dense kernels,
    biases, and widths that are no multiple of 128 (ragged tiles)."""
    shapes = {"Conv_0/kernel": (3, 3, 3, 4), "Conv_0/bias": (4,),
              "Dense_0/kernel": (36, 20), "Dense_0/bias": (20,),
              "Dense_1/kernel": (20, 7), "Dense_1/bias": (7,)}
    rng = np.random.default_rng(seed)
    leaves = {k: (rng.standard_normal((b, *s)) * 0.3).astype(np.float32)
              .astype(DTYPES[dtype][0]) for k, s in shapes.items()}
    jt = {k: jnp.asarray(v) for k, v in leaves.items()}
    tt = {k: torch.tensor(v.astype(np.float32)).to(DTYPES[dtype][1])
          for k, v in leaves.items()}
    return jt, tt


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,w", [(5, 300), (4, 129), (7, 1000), (3, 10), (2, 2048)])
def test_sq_norms_match_jax(dtype, b, w):
    jg, tg = _matrix(b, w, dtype, seed=w)
    want = jdp.per_example_sq_norms(jg, tile=128, interpret=True)
    got = tdp.per_example_sq_norms(tg)
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,w", [(6, 500), (4, 129), (7, 1000), (3, 10)])
def test_scaled_sum_matches_jax(dtype, b, w):
    jg, tg = _matrix(b, w, dtype, seed=w + 1)
    scale = np.linspace(0.0, 2.0, b).astype(np.float32)
    scale[1] = 0.0  # a masked example
    want = jdp.scaled_masked_sum(jg, jnp.asarray(scale), tile=128, interpret=True)
    got = tdp.scaled_masked_sum(tg, torch.tensor(scale))
    assert got.dtype == torch.float32 and got.shape == (w,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bound", [0.8, 100.0])
def test_fused_matches_jax(dtype, bound):
    jt, tt = _tree(6, dtype, seed=3)
    mask = np.asarray([1, 1, 0, 1, 1, 0], np.float32)
    want, wnorms = jdp.fused_clipped_masked_sum(jt, jnp.asarray(mask), bound, tile=128,
                                                interpret=True, return_norms=True)
    got, gnorms = tdp.fused_clipped_masked_sum(tt, torch.tensor(mask), bound,
                                               return_norms=True)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(gnorms.numpy(), np.asarray(wnorms), rtol=1e-5)


def test_plain_route_counts_no_launch_and_other_devices_raise():
    tdp.reset_launch_counts()
    g = torch.ones((2, 3))
    tdp.per_example_sq_norms(g)
    tdp.scaled_masked_sum(g, torch.ones(2))
    assert tdp.LAUNCHES == {"dp_sq_norms": 0, "dp_scaled_sum": 0}
    meta = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdp.per_example_sq_norms(meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdp.scaled_masked_sum(meta, torch.ones(2, device="meta"))


def test_kernel_wrappers_refuse_cpu_tensors():
    # the wrappers that launch never run the plain version in their place
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdp.sq_norms_kernel(torch.ones((2, 3)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdp.scaled_sum_kernel(torch.ones((2, 3)), torch.ones(2))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_clip_per_example_matches_jax(dtype):
    jt, tt = _tree(5, dtype, seed=4)
    jclipped, jnorms = jdpsgd.clip_per_example(jt, 0.5)
    tclipped, tnorms = tdpsgd.clip_per_example(tt, 0.5)
    # bf16 leaves: both packages compute the norms, the clip factor and the
    # product in bf16, each a rounding of at most 2^-8 relative that the two
    # may take apart: 3 * 2^-8 < 2^-6
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=2**-6, atol=0)
    np.testing.assert_allclose(tnorms.float().numpy(),
                               np.asarray(jnorms).astype(np.float32), **tol)
    for k in jclipped:
        assert tclipped[k].dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(tclipped[k].float().numpy(),
                                   np.asarray(jclipped[k]).astype(np.float32), **tol)


@pytest.mark.parametrize("fused_port", [False, True])
@pytest.mark.parametrize("fused_jax", [False, True])
def test_noisy_clipped_mean_grads_routes_match_jax(fused_port, fused_jax):
    jt, tt = _tree(6, "float32", seed=5)
    mask = np.asarray([1, 0, 1, 1, 1, 1], np.float32)
    want, wfrac = jdpsgd.noisy_clipped_mean_grads(
        jt, jnp.asarray(mask), jax.random.PRNGKey(9), 0.5, 0.0,
        use_fused_kernel=fused_jax, return_clip_fraction=True)
    got, gfrac = tdpsgd.noisy_clipped_mean_grads(
        tt, torch.tensor(mask), torch.Generator().manual_seed(9), 0.5, 0.0,
        use_fused_kernel=fused_port, return_clip_fraction=True)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5,
                                   err_msg=k)
    assert float(gfrac) == pytest.approx(float(wfrac), abs=1e-7)
    assert 0.0 < float(gfrac) <= 1.0


def test_noise_has_the_dp_std_and_fresh_draws_per_client_and_step():
    """Zero gradients isolate the noise: every coordinate is
    N(0, (sigma C)^2) / n_real. 200,000 draws estimate the std within
    ~0.16% (one standard error), so 1% is six standard errors."""
    b, sigma, bound = 8, 1.3, 0.7
    mask = torch.tensor([1, 1, 1, 0, 1, 1, 0, 1], dtype=torch.float32)
    zeros = {"w": torch.zeros((b, 400, 500))}
    draws = {}
    for client in (0, 1):
        for step in (0, 1):
            gen = tengine.step_generator([0, 3, 1001, client], step, torch.device("cpu"))
            draws[client, step] = tdpsgd.noisy_clipped_mean_grads(
                zeros, mask, gen, bound, sigma, use_fused_kernel=True)["w"]
    want_std = sigma * bound / float(mask.sum())
    for d in draws.values():
        assert float(d.mean()) == pytest.approx(0.0, abs=5 * want_std / 200_000 ** 0.5)
        assert float(d.std()) == pytest.approx(want_std, rel=0.01)
    keys = list(draws)
    for i, a in enumerate(keys):
        for c in keys[i + 1:]:
            assert not torch.equal(draws[a], draws[c]), (a, c)
    # the same client, step and entropy draw the same noise again
    gen = tengine.step_generator([0, 3, 1001, 1], 1, torch.device("cpu"))
    again = tdpsgd.noisy_clipped_mean_grads(zeros, mask, gen, bound, sigma,
                                            use_fused_kernel=True)["w"]
    assert torch.equal(again, draws[1, 1])


def test_make_per_example_grads_matches_jax():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    xs = rng.standard_normal((5, 4)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jnp.tanh(x @ p["w"]) ** 2)

    def tloss(p, x):
        return (torch.tanh(x @ p["w"]) ** 2).sum()

    want = jdpsgd.make_per_example_grads(jloss)({"w": jnp.asarray(w)}, jnp.asarray(xs))
    got = tdpsgd.make_per_example_grads(tloss)({"w": torch.tensor(w)}, torch.tensor(xs))
    assert got["w"].shape == (5, 4, 3)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), atol=1e-6)


def test_validate_rejects_batchnorm():
    ok = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.LayerNorm(4))
    tdpsgd.validate_dp_safe_model_state(ok)
    tdpsgd.validate_dp_safe_model_state(None)
    bad = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    with pytest.raises(ValueError, match="BatchNorm"):
        tdpsgd.validate_dp_safe_model_state(bad)
    with pytest.raises(ValueError, match="batch_stats|BatchNorm"):
        jdpsgd.validate_dp_safe_model_state({"batch_stats": {}})


@pytest.mark.parametrize("kw", [
    # the full-width DP run of chip_smoke.py, whose epsilon it checks on the card
    dict(q=1.0, sigma=chip_smoke.DP_SIGMA, sizes=[chip_smoke.DP_TRAIN] * chip_smoke.DP_CLIENTS,
         batch=chip_smoke.BATCH, steps=chip_smoke.LOCAL_STEPS, epochs=None,
         rounds=chip_smoke.DP_ROUNDS, delta=1 / (chip_smoke.DP_TRAIN * chip_smoke.DP_CLIENTS)),
    dict(q=0.5, sigma=1.3, sizes=[40, 57, 100], batch=8, steps=None, epochs=2,
         rounds=3, delta=1e-5),
    dict(q=0.25, sigma=0.9, sizes=[64, 33], batch=16, steps=4, epochs=None,
         rounds=5, delta=1e-6),
])
def test_instance_level_accountant_matches_jax(kw):
    args = dict(client_sampling_rate=kw["q"], noise_multiplier=kw["sigma"],
                epochs_per_round=kw["epochs"],
                client_batch_sizes=[kw["batch"]] * len(kw["sizes"]),
                client_dataset_sizes=kw["sizes"], steps_per_round=kw["steps"])
    j, t = jacc.FlInstanceLevelAccountant(**args), tacc.FlInstanceLevelAccountant(**args)
    eps_j = j.get_epsilon(kw["rounds"], kw["delta"])
    eps_t = t.get_epsilon(kw["rounds"], kw["delta"])
    assert 0.0 < eps_t < np.inf
    assert abs(eps_t - eps_j) <= 1e-9
    if len(kw["sizes"]) == chip_smoke.DP_CLIENTS:
        assert abs(eps_t - chip_smoke.DP_EPSILON) <= 1e-9
    else:  # (64 identical clients make get_delta slow and teach nothing more)
        assert abs(t.get_delta(kw["rounds"], eps_t)
                   - j.get_delta(kw["rounds"], eps_j)) <= 1e-9


@pytest.mark.parametrize("b,w,elem_bytes,split", [
    (32, 524288, 4, 1),   # Dense_0/kernel: 512 CTAs unsplit
    (32, 51200, 4, 4),    # Conv_1/kernel: 50 CTAs unsplit, 200 at 4
    (32, 2400, 4, 32),    # Conv_0/kernel: 3 CTAs unsplit
    (32, 1280, 4, 32),    # Dense_1/kernel
    (32, 32, 4, 32),      # Conv_0/bias: 8 column groups
    (32, 10, 4, 32),      # Dense_1/bias
    (32, 134144, 4, 2),   # 33,536 groups: 131 CTAs, one short of 132 SMs
    (32, 134148, 4, 1),   # 33,537 groups: 132 CTAs
    (32, 268288, 2, 2),   # the same two sides in bf16 (8 columns a group)
    (32, 268296, 2, 1),
    (7, 1000, 4, 4),      # at most B, as a power of two
    (1, 10, 4, 1),
])
def test_scaled_sum_split_rule(b, w, elem_bytes, split):
    """K2's row split is a rule on the shape and the SM count (132 on an
    H100): the least power of two that gives every SM a CTA, capped at 32
    and at B."""
    assert tdp.scaled_sum_split(b, w, elem_bytes, n_sms=132) == split
