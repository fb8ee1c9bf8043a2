"""The cohort index views of the port's client managers against the JAX
managers on the CPU: ``sample_indices`` of all four managers (ids and
``valid``) over seeds and rounds, ``FixedFractionManager`` at 100,000
clients included; ``draw_cohort`` of the three managers that have one equal
to JAX's and to ``sample_indices``; ``CohortOverflowError`` with JAX's
message; and ``rng.bernoulli``, ``rng.rademacher`` and ``rng.fold_in_many``
bit for bit against ``jax.random``."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import numpy as np
import pytest
import torch

from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu_torch import rng
from fl4health_tpu_torch.server import client_manager as tcm

SEEDS = [0, 7, 2**31 - 1]
ROUNDS = [1, 3]

# (factory over a package's module, slots)
MANAGERS = {
    "full": (lambda m: m.FullParticipationManager(10), 12),
    "full_exact": (lambda m: m.FullParticipationManager(8), 8),
    "fixed_fraction": (lambda m: m.FixedFractionManager(10, 0.3), 4),
    "fixed_fraction_min": (lambda m: m.FixedFractionManager(10, 0.05, min_clients=2), 2),
    "fixed_fraction_all": (lambda m: m.FixedFractionManager(6, 1.0), 6),
    "fixed_fraction_100k": (lambda m: m.FixedFractionManager(100_000, 64 / 100_000), 64),
    "poisson": (lambda m: m.PoissonSamplingManager(64, 0.25), 40),
    "poisson_min": (lambda m: m.PoissonSamplingManager(10, 0.2, min_clients=3), 10),
    "fixed_sampling": (lambda m: m.FixedSamplingManager(10, 0.3), 5),
}


def _round_keys(seed, rnd):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), 2000 + rnd),
            rng.fold_in(rng.PRNGKey(seed), 2000 + rnd))


@pytest.mark.parametrize("name", list(MANAGERS))
@pytest.mark.parametrize("seed", SEEDS)
def test_sample_indices_and_draw_cohort_match_jax(name, seed):
    build, slots = MANAGERS[name]
    jm, tm = build(jcm), build(tcm)
    assert hasattr(tm, "draw_cohort") == hasattr(jm, "draw_cohort")
    for rnd in ROUNDS:
        jkey, tkey = _round_keys(seed, rnd)
        want_ids, want_valid = jm.sample_indices(jkey, rnd, slots)
        got_ids, got_valid = tm.sample_indices(tkey, rnd, slots)
        assert got_ids.dtype == np.int32 and got_ids.shape == (slots,)
        np.testing.assert_array_equal(got_ids, want_ids)
        assert got_valid == want_valid
        if hasattr(tm, "draw_cohort"):
            jids, jvalid = jm.draw_cohort(jkey, rnd, slots)
            ids, valid = tm.draw_cohort(tkey, rnd, slots)
            assert ids.dtype == torch.int32 and valid.dtype == torch.int32
            np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
            assert int(valid) == int(jvalid)
            # the device draw equals the host view (no tie on the k-th place
            # at these seeds)
            np.testing.assert_array_equal(ids.numpy(), got_ids)
            assert int(valid) == got_valid


def test_poisson_empty_draw_pads_with_zero():
    for seed in range(200):
        jkey, tkey = _round_keys(seed, 1)
        want = jcm.PoissonSamplingManager(4, 0.02).sample_indices(jkey, 1, 3)
        if want[1] == 0:
            break
    else:
        pytest.fail("no empty round in 200 seeds")
    got = tcm.PoissonSamplingManager(4, 0.02).sample_indices(tkey, 1, 3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == 0 and list(got[0]) == [0, 0, 0]
    ids, valid = tcm.PoissonSamplingManager(4, 0.02).draw_cohort(tkey, 1, 3)
    assert int(valid) == 0 and ids.tolist() == [0, 0, 0]


def _message(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("case", [
    ("full", lambda m, k: m.FullParticipationManager(10).sample_indices(k, 1, 4)),
    ("full_draw", lambda m, k: m.FullParticipationManager(10).draw_cohort(k, 1, 4)),
    ("fixed", lambda m, k: m.FixedFractionManager(10, 0.5).sample_indices(k, 1, 3)),
    ("fixed_draw", lambda m, k: m.FixedFractionManager(10, 0.5).draw_cohort(k, 1, 3)),
    ("poisson", lambda m, k: m.PoissonSamplingManager(10, 1.0).sample_indices(k, 1, 3)),
], ids=lambda c: c[0])
def test_overflow_raises_as_in_jax(case):
    _, fn = case
    jkey, tkey = _round_keys(0, 1)
    want = _message(lambda: fn(jcm, jkey))
    got = _message(lambda: fn(tcm, tkey))
    assert want[0] == "CohortOverflowError"
    assert got == want
    assert issubclass(tcm.CohortOverflowError, ValueError)


def test_poisson_overflowing_draw_clamps_valid_in_the_device_draw():
    jkey, tkey = _round_keys(3, 2)
    ids, valid = tcm.PoissonSamplingManager(10, 1.0).draw_cohort(tkey, 2, 4)
    jids, jvalid = jcm.PoissonSamplingManager(10, 1.0).draw_cohort(jkey, 2, 4)
    assert int(valid) == int(jvalid) == 4
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (7,), (3, 5, 11), (1000,)])
def test_bernoulli_and_rademacher_match_jax(seed, shape):
    jkey, tkey = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    for p in (0.5, 0.3, 0.999):
        np.testing.assert_array_equal(rng.bernoulli(tkey, p, shape).numpy(),
                                      np.asarray(jax.random.bernoulli(jkey, p, shape)))
    np.testing.assert_array_equal(rng.rademacher(tkey, shape).numpy(),
                                  np.asarray(jax.random.rademacher(jkey, shape)))
    got = rng.rademacher(tkey, shape, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.rademacher(jkey, shape, jax.numpy.float32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_with_a_tensor_p_and_fold_in_many_match_jax(seed):
    jkey, tkey = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    p = np.random.default_rng(seed).random((4, 25)).astype(np.float32)
    np.testing.assert_array_equal(rng.bernoulli(tkey, torch.from_numpy(p)).numpy(),
                                  np.asarray(jax.random.bernoulli(jkey, p)))
    ids = np.arange(0, 5000, 37)
    want = np.asarray(jax.vmap(lambda i: jax.random.fold_in(jkey, i))(ids))
    np.testing.assert_array_equal(rng.fold_in_many(tkey, torch.from_numpy(ids)).numpy(), want)
    assert torch.equal(rng.fold_in_many(tkey, torch.tensor([5]))[0], rng.fold_in(tkey, 5))
