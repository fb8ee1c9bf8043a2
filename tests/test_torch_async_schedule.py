"""The port's buffered-async scheduler (``server/async_schedule.py``)
against the JAX package's on the CPU: event plans, registry seatings, the
plans' fingerprints and ``sync_round_times`` equal array for array over a
grid of seeds, buffer sizes and straggler plans; the validation messages
word for word; and the staleness discount against ``jax.jit`` of JAX's
``(1+s)**(-exponent)``: bit for bit on staleness 0..64 at exponents 0, 0.3,
0.5 and 1, within 1 ulp on a wider grid (``torch.pow`` in f32 is not)."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.resilience import faults as jfaults
from fl4health_tpu.server import async_schedule as jas
from fl4health_tpu_torch.resilience import faults as tfaults
from fl4health_tpu_torch.server import async_schedule as tas


def _plans(mod):
    """A grid of fault plans in one package: none, one 5x straggler, a
    windowed straggler at probability 0.5 beside a compounding one."""
    return {
        "none": None,
        "slow": mod.FaultPlan(client_faults=(
            mod.ClientFault(clients=(0,), kind="slow", scale=5.0),)),
        "windowed": mod.FaultPlan(seed=4, client_faults=(
            mod.ClientFault(clients=(1, 2), kind="slow", scale=3.0, probability=0.5,
                            start_round=2, end_round=5),
            mod.ClientFault(clients=(2,), kind="slow", scale=2.0),
            mod.ClientFault(clients=(3,), kind="dropout", probability=0.5))),
    }


GRID = list(itertools.product((0, 3), (1, 2, 4), (0.0, 0.05), ("none", "slow", "windowed")))


def _same_plan(a, b):
    for f in ("arrivals", "staleness", "event_times"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("seed,k,jitter,faults", GRID)
def test_event_plans_equal_jax(seed, k, jitter, faults):
    n_clients, n_events = 6, 7
    kw = dict(buffer_size=k, compute_jitter=jitter, seed=seed)
    j = jas.build_event_plan(jas.AsyncConfig(**kw), n_events, n_clients,
                             _plans(jfaults)[faults])
    t = tas.build_event_plan(tas.AsyncConfig(**kw), n_events, n_clients,
                             _plans(tfaults)[faults])
    _same_plan(j, t)
    assert tas.plan_prefix_fingerprints(t) == jas.plan_prefix_fingerprints(j)
    for e in (0, 3, n_events):
        assert tas.plan_fingerprint(t, e) == jas.plan_fingerprint(j, e)
    assert [t.summarize_event(e) for e in range(n_events)] == [
        j.summarize_event(e) for e in range(n_events)]
    np.testing.assert_array_equal(t.cadences(), j.cadences())
    np.testing.assert_array_equal(
        tas.sync_round_times(tas.AsyncConfig(**kw), 5, n_clients, _plans(tfaults)[faults]),
        jas.sync_round_times(jas.AsyncConfig(**kw), 5, n_clients, _plans(jfaults)[faults]))


@pytest.mark.parametrize("slots,registry,k,faults", [
    (3, 6, 2, "slow"), (3, 3, 3, "none"), (4, 10, 2, "windowed"), (4, 9, 1, "none")])
def test_registry_plans_equal_jax(slots, registry, k, faults):
    kw = dict(buffer_size=k, compute_jitter=0.05, seed=2)
    j = jas.build_registry_event_plan(jas.AsyncConfig(**kw), 6, slots, registry,
                                      _plans(jfaults)[faults])
    t = tas.build_registry_event_plan(tas.AsyncConfig(**kw), 6, slots, registry,
                                      _plans(tfaults)[faults])
    _same_plan(j, t)
    assert t.slot_ids.dtype == j.slot_ids.dtype
    np.testing.assert_array_equal(t.slot_ids, j.slot_ids)
    assert tas.plan_prefix_fingerprints(t) == jas.plan_prefix_fingerprints(j)
    if slots == registry:  # no pool: the seating is the identity
        assert (t.slot_ids == np.arange(slots)).all()
    else:
        assert (t.slot_ids[1:] != t.slot_ids[:-1]).any()


def test_validation_messages_equal_jax():
    bad_configs = [dict(buffer_size=0), dict(buffer_size=1, staleness_exponent=-0.1),
                   dict(buffer_size=1, max_staleness=-1), dict(buffer_size=1, base_compute_s=0.0),
                   dict(buffer_size=1, compute_jitter=1.0)]
    for kw in bad_configs:
        with pytest.raises(ValueError) as je:
            jas.AsyncConfig(**kw)
        with pytest.raises(ValueError, match=str(je.value).replace("[", r"\[").replace(
                "(", r"\(").replace(")", r"\)")):
            tas.AsyncConfig(**kw)
    cfg = dict(buffer_size=3, max_staleness=4, compute_jitter=0.1, seed=9)
    assert tas.AsyncConfig(**cfg).describe() == jas.AsyncConfig(**cfg).describe()
    calls = [
        lambda m: m.build_event_plan(m.AsyncConfig(buffer_size=2), 0, 4),
        lambda m: m.build_event_plan(m.AsyncConfig(buffer_size=2), 2, 0),
        lambda m: m.build_event_plan(m.AsyncConfig(buffer_size=5), 2, 4),
        lambda m: m.build_registry_event_plan(m.AsyncConfig(buffer_size=2), 2, 5, 4),
        lambda m: m.sync_round_times(m.AsyncConfig(buffer_size=2), 0, 4),
        lambda m: m.plan_fingerprint(m.build_event_plan(m.AsyncConfig(buffer_size=1), 2, 2), 3),
    ]
    for call in calls:
        with pytest.raises(ValueError) as je:
            call(jas)
        with pytest.raises(ValueError) as te:
            call(tas)
        assert str(te.value) == str(je.value)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


def test_discount_equals_compiled_jax():
    jitted = jax.jit(lambda s, e: jas.staleness_discount(s, e))
    s = np.arange(65, dtype=np.float32)
    for e in (0.0, 0.3, 0.5, 1.0):
        want = np.asarray(jitted(jnp.asarray(s), jnp.asarray(e, jnp.float32)))
        got = tas.staleness_discount(torch.from_numpy(s), torch.tensor(e)).numpy()
        assert np.array_equal(got, want), e
        assert got[0] == 1.0
        # the plain f32 torch.pow parts from XLA's pow on this very grid
        if e in (0.3, 0.5):
            plain = torch.pow(1.0 + torch.from_numpy(s), -torch.tensor(e)).numpy()
            assert _ulps(plain, want).max() == 1
    # wider: within 1 ulp of XLA's pow (the f64 power rounded to f32)
    s = np.arange(2001, dtype=np.float32)
    for e in np.linspace(0.0, 3.0, 31, dtype=np.float32):
        want = np.asarray(jitted(jnp.asarray(s), jnp.asarray(e)))
        got = tas.staleness_discount(torch.from_numpy(s), torch.tensor(e)).numpy()
        assert _ulps(got, want).max() <= 1, e


def test_discount_rules():
    s = torch.tensor([0.0, 1.0, 3.0])
    np.testing.assert_allclose(tas.staleness_discount(s).numpy(),
                               [1.0, 1.0 / np.sqrt(2.0), 0.5], rtol=1e-7)
    w = tas.staleness_discount(torch.tensor([0.0, 2.0, 5.0]), max_staleness=2).numpy()
    assert w[0] == 1.0 and w[1] > 0 and w[2] == 0.0
    # the numpy path is JAX's, untouched
    np.testing.assert_array_equal(
        tas.staleness_discount(np.asarray([0.0, 2.0, 5.0]), 0.5, 2),
        jas.staleness_discount(np.asarray([0.0, 2.0, 5.0]), 0.5, 2))
