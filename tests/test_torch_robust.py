"""The port's robust aggregators (``resilience/aggregators.py``) against
the JAX package's on the CPU (``tests/resilience/test_aggregators.py``'s
cases): the coordinate median and Krum's selection equal JAX's exactly,
the trimmed and norm-bounded means (sums over the clients axis, XLA's
order only up to rounding) within 1e-6, over masks, cohort sizes, trim
fractions and NaN/Inf/scaled attackers; ``RobustFedAvg`` per method,
its empty-cohort rule and its errors word for word; and a robust run
whose pipelined and chunked routes equal each other bit for bit."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.resilience import aggregators as jagg
from fl4health_tpu.strategies.base import FitResults as JFitResults
from fl4health_tpu_torch.resilience import aggregators as tagg
from fl4health_tpu_torch.strategies.base import FitResults as TFitResults
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from tests.torch_async_sims import flat, resilience_rows, same_history, tsim_of

C = 8
MASKS = {"all": [1.0] * C, "six": [1, 1, 1, 1, 1, 1, 0, 0], "three": [0, 1, 0, 1, 1, 0, 0, 0],
         "four": [1, 0, 1, 0, 1, 0, 1, 0], "one": [0, 0, 0, 0, 0, 1, 0, 0],
         "empty": [0.0] * C}


def _stacks(seed: int, attack: str) -> dict:
    r = np.random.default_rng(seed)
    w = r.normal(size=(C, 3, 2)).astype(np.float32)
    b = r.normal(size=(C, 5)).astype(np.float32) * 0.1
    if attack == "nan_inf":
        w[0], b[3, 1] = np.nan, np.inf
    elif attack == "scaled":
        w[2] *= 1e4
        b[2] += 100.0
    return {"w": w, "b": b}


def _both(stacked, mask):
    return (({k: jnp.asarray(v) for k, v in stacked.items()}, jnp.asarray(mask, jnp.float32)),
            ({k: torch.from_numpy(v) for k, v in stacked.items()},
             torch.tensor(mask, dtype=torch.float32)))


def _close(got, want, atol):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize("attack", ["none", "nan_inf", "scaled"])
@pytest.mark.parametrize("mask", [m for m in MASKS if m != "empty"])
def test_reductions_equal_jax(attack, mask):
    (js, jm), (ts, tm) = _both(_stacks(1, attack), MASKS[mask])
    _close(tagg.coordinate_median(ts, tm), jagg.coordinate_median(js, jm), 0.0)
    for frac in (0.0, 0.2, 0.25, 0.4):
        _close(tagg.trimmed_mean(ts, tm, frac), jagg.trimmed_mean(js, jm, frac), 1e-6)
    ref = {"w": np.full((3, 2), 0.5, np.float32), "b": np.zeros((5,), np.float32)}
    counts = np.arange(1, C + 1, dtype=np.float32)
    for weighted in (True, False):
        want = jagg.norm_bounded_mean(js, {k: jnp.asarray(v) for k, v in ref.items()},
                                      jnp.asarray(counts), jm, 2.0, weighted)
        got = tagg.norm_bounded_mean(ts, {k: torch.from_numpy(v) for k, v in ref.items()},
                                     torch.from_numpy(counts), tm, 2.0, weighted)
        _close(got, want, 1e-6)
    for f, m in ((0, 1), (1, 1), (1, 2), (2, 3)):
        want = np.asarray(jagg.krum_weights(js, jm, num_byzantine=f, multi_m=m))
        np.testing.assert_array_equal(tagg.krum_weights(ts, tm, f, m).numpy(), want)
    np.testing.assert_array_equal(tagg._per_client_nonfinite_flag(ts).numpy(),
                                  np.asarray(jagg._per_client_nonfinite_flag(js)))


@pytest.mark.parametrize("method", list(tagg.ROBUST_METHODS))
@pytest.mark.parametrize("mask", ["all", "three", "empty"])
def test_robust_fedavg_aggregate_equals_jax(method, mask):
    stacked = _stacks(2, "nan_inf" if mask == "all" else "scaled")
    (js, jm), (ts, tm) = _both(stacked, MASKS[mask])
    params = {"w": np.ones((3, 2), np.float32), "b": np.zeros((5,), np.float32)}
    counts = np.arange(1, C + 1, dtype=np.float32)
    losses = np.zeros((C,), np.float32)
    jstrat, tstrat = jagg.RobustFedAvg(method), tagg.RobustFedAvg(method)
    want = jstrat.aggregate(
        jstrat.init({k: jnp.asarray(v) for k, v in params.items()}),
        JFitResults(packets=js, sample_counts=jnp.asarray(counts),
                    train_losses={"backward": jnp.asarray(losses)}, train_metrics={}, mask=jm),
        jnp.asarray(1, jnp.int32))
    got = tstrat.aggregate(
        tstrat.init({k: torch.from_numpy(v) for k, v in params.items()}),
        TFitResults(packets=ts, sample_counts=torch.from_numpy(counts),
                    train_losses={"backward": torch.from_numpy(losses)}, train_metrics={},
                    mask=tm), 1)
    _close(got.params, want.params, 1e-6)
    if mask == "empty":  # an empty cohort keeps the params
        _close(got.params, params, 0.0)


def test_every_estimator_is_fedavg_on_identical_packets():
    packets = {"w": torch.arange(3.0).expand(C, 3).contiguous()}
    res = TFitResults(packets=packets, sample_counts=torch.ones(C),
                      train_losses={"backward": torch.zeros(C)}, train_metrics={},
                      mask=torch.ones(C))
    fed = TFedAvg().aggregate(TFedAvg().init({"w": torch.zeros(3)}), res, 1)
    for method in ("median", "trimmed_mean", "krum", "multi_krum"):
        strat = tagg.RobustFedAvg(method)
        out = strat.aggregate(strat.init({"w": torch.zeros(3)}), res, 1)
        np.testing.assert_allclose(out.params["w"].numpy(), fed.params["w"].numpy(), rtol=1e-6)


def test_errors_equal_jax():
    calls = [
        lambda m, a: m.RobustFedAvg("mean_of_means"),
        lambda m, a: m.RobustFedAvg("median", max_update_norm=0.0),
        lambda m, a: m.RobustFedAvg("median", num_byzantine=-1),
        lambda m, a: m.krum_weights({"w": a(np.zeros((C, 2), np.float32))},
                                    a(np.ones(C, np.float32)), 1, multi_m=0),
        lambda m, a: m.trimmed_mean({"w": a(np.zeros((C, 2), np.float32))},
                                    a(np.ones(C, np.float32)), np.float32(0.7)),
        lambda m, a: m.trimmed_mean({"w": a(np.zeros((C, 2), np.float32))},
                                    a(np.ones(C, np.float32)), 0.5),
    ]
    for call in calls:
        with pytest.raises(ValueError) as je:
            call(jagg, jnp.asarray)
        with pytest.raises(ValueError) as te:
            call(tagg, torch.from_numpy)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("method", ["norm_bounded", "multi_krum"])
def test_robust_runs_are_bit_equal_across_routes(method):
    data = resilience_rows(C)
    runs = []
    for mode in ("pipelined", "chunked"):
        sim = tsim_of(data, tagg.RobustFedAvg(method, max_update_norm=1.0), mode=mode,
                      local_epochs=None, local_steps=2, seed=7, hidden=8, n_classes=2, lr=0.1)
        sim.fit(3)
        runs.append(sim)
    assert same_history(*runs)
    assert np.array_equal(flat(runs[0].global_params), flat(runs[1].global_params))
    assert runs[0].history[-1].fit_losses["backward"] < runs[0].history[0].fit_losses["backward"]
