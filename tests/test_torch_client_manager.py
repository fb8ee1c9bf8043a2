"""The port's client managers against the JAX managers on the CPU: every
manager's mask over seeds x rounds bit for bit, drawn from the key the
simulations hand them (``fold_in(PRNGKey(seed), 2000 + round)``), Poisson
with ``min_clients`` and a round that samples nobody, ``FixedSamplingManager``'s
cached draw and ``reset_sample``, the four managers' ``fraction``, and the
simulation's keyed sampling."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax
import numpy as np
import pytest
import torch

from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu_torch import rng
from fl4health_tpu_torch.server import client_manager as tcm

SEEDS = [0, 7, 2**31 - 1]
ROUNDS = [1, 2, 5]


def _round_keys(seed, rnd):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), 2000 + rnd),
            rng.fold_in(rng.PRNGKey(seed), 2000 + rnd))


def _assert_same_mask(got, want):
    assert got.dtype == torch.float32 and got.shape == (len(np.asarray(want)),)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


MANAGERS = {
    "full": lambda m: m.FullParticipationManager(10),
    "fixed_fraction": lambda m: m.FixedFractionManager(10, 0.3),
    "fixed_fraction_0.7": lambda m: m.FixedFractionManager(10, 0.7),
    "fixed_fraction_min": lambda m: m.FixedFractionManager(10, 0.05, min_clients=2),
    "fixed_fraction_2000": lambda m: m.FixedFractionManager(2000, 0.01),
    "poisson": lambda m: m.PoissonSamplingManager(10, 0.5),
    "poisson_min": lambda m: m.PoissonSamplingManager(10, 0.2, min_clients=3),
    "poisson_64": lambda m: m.PoissonSamplingManager(64, 0.25),
}


@pytest.mark.parametrize("name", list(MANAGERS))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rnd", ROUNDS)
def test_mask_matches_jax(name, seed, rnd):
    jkey, tkey = _round_keys(seed, rnd)
    want = MANAGERS[name](jcm).sample(jkey, rnd)
    _assert_same_mask(MANAGERS[name](tcm).sample(tkey, rnd), want)


def test_poisson_round_that_samples_nobody():
    # fraction 0.02 over 4 clients: find a seed whose round 1 is empty, in
    # both packages, and check the min_clients top-up fills it
    for seed in range(200):
        jkey, tkey = _round_keys(seed, 1)
        want = np.asarray(jcm.PoissonSamplingManager(4, 0.02).sample(jkey, 1))
        if want.sum() == 0:
            break
    else:
        pytest.fail("no empty Poisson round among 200 seeds")
    _assert_same_mask(tcm.PoissonSamplingManager(4, 0.02).sample(tkey, 1), want)
    topped = tcm.PoissonSamplingManager(4, 0.02, min_clients=2).sample(tkey, 1)
    _assert_same_mask(topped, jcm.PoissonSamplingManager(4, 0.02, min_clients=2)
                      .sample(jkey, 1))
    assert topped.sum() == 2


def test_fixed_sampling_caches_its_draw_until_reset():
    jm, tm = jcm.FixedSamplingManager(12, 0.25), tcm.FixedSamplingManager(12, 0.25)
    first = None
    for rnd in ROUNDS:  # one draw from the first key, reused every round
        jkey, tkey = _round_keys(3, rnd)
        got = tm.sample(tkey, rnd)
        _assert_same_mask(got, jm.sample(jkey, rnd))
        first = got if first is None else first
        assert torch.equal(got, first) and got.sum() == 3
    jm.reset_sample()
    tm.reset_sample()
    jkey, tkey = _round_keys(4, 1)
    redrawn = tm.sample(tkey, 1)
    _assert_same_mask(redrawn, jm.sample(jkey, 1))
    assert not torch.equal(redrawn, first)


@pytest.mark.parametrize("name,want", [
    ("FullParticipationManager", 1.0), ("FixedFractionManager", 0.3),
    ("PoissonSamplingManager", 0.3), ("FixedSamplingManager", 0.3)])
def test_fraction(name, want):
    args = (10,) if name == "FullParticipationManager" else (10, 0.3)
    assert getattr(tcm, name)(*args).fraction == getattr(jcm, name)(*args).fraction == want


def test_fraction_floor_and_k():
    for n, q, min_clients in ((10, 0.7, 1), (10, 0.0, 1), (3, 0.5, 3), (100, 0.29, 1)):
        jm = jcm.FixedFractionManager(n, q, min_clients)
        assert tcm.FixedFractionManager(n, q, min_clients).k == jm.k
        assert tcm.FixedSamplingManager(n, q).k == jcm.FixedSamplingManager(n, q).k


def test_constructor_errors():
    with pytest.raises(ValueError, match="exceeds"):
        tcm.FixedFractionManager(3, 0.5, min_clients=4)
    with pytest.raises(ValueError, match="min_clients"):
        tcm.PoissonSamplingManager(3, 0.5, min_clients=4)


def test_mask_lives_on_the_key_device():
    key = rng.PRNGKey(0, "cpu")
    for make in MANAGERS.values():
        assert make(tcm).sample(key, 1).device == key.device
