"""The metrics tail of the port against the JAX package on the CPU:
``balanced_accuracy``, ``f1`` (weighted, macro, micro),
``binary_classification_metric`` (every stat), ``binned_auc`` (its
thresholds equal to ``jnp.linspace``'s, ties at a threshold counted on the
same side), ``MetricManager``'s prefix, ``ema_metric``,
``transforms_metric``, ``aggregate_metrics_list`` and
``prefix_test_metrics``, each on random, tied and masked inputs, streamed
over several batches. Tolerance 1e-6 (the reference's for single
functions)."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.metrics import aggregation as jagg
from fl4health_tpu.metrics import base as jbase
from fl4health_tpu.metrics import efficient as jeff
from fl4health_tpu_torch.metrics import aggregation as tagg
from fl4health_tpu_torch.metrics import base as tbase
from fl4health_tpu_torch.metrics import efficient as teff

TOL = 1e-6
C = 4


def _batches(kind, binary, seed=0, n_batches=3, b=17):
    """(preds, targets, mask) batches: ``random`` scores, ``tied`` scores
    on a coarse grid (argmax ties, scores exactly at thresholds) or
    ``masked`` (a third of the rows masked out); binary as logits or as
    probabilities."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        if binary:
            p = r.standard_normal((b, 1)).astype(np.float32) * 2
            if kind == "tied":
                p = (np.round(r.random((b, 1)) * 8) / 8).astype(np.float32)  # probs on 1/8s
            t = r.integers(0, 2, (b,)).astype(np.float32)
        else:
            p = r.standard_normal((b, C)).astype(np.float32)
            if kind == "tied":
                p = np.round(p).astype(np.float32)
            t = r.integers(0, C, (b,)).astype(np.int32)
        m = np.ones((b,), np.float32)
        if kind == "masked":
            m[r.random(b) < 0.33] = 0.0
        out.append((p, t, m))
    return out


def _run_both(jm, tm, batches):
    js, ts = jm.init(), tm.init("cpu")
    for p, t, m in batches:
        js = jm.update(js, jnp.asarray(p), jnp.asarray(t), jnp.asarray(m))
        ts = tm.update(ts, torch.tensor(p), torch.tensor(t), torch.tensor(m))
    return float(tm.compute(ts)), float(jm.compute(js))


KINDS = ["random", "tied", "masked"]


@pytest.mark.parametrize("kind", KINDS)
def test_balanced_accuracy_matches_jax(kind):
    got, want = _run_both(jeff.balanced_accuracy(C), teff.balanced_accuracy(C),
                          _batches(kind, False))
    assert abs(got - want) <= TOL


@pytest.mark.parametrize("average", ["weighted", "macro", "micro"])
@pytest.mark.parametrize("kind", KINDS)
def test_f1_matches_jax(kind, average):
    got, want = _run_both(jeff.f1(C, average), teff.f1(C, average), _batches(kind, False, 1))
    assert abs(got - want) <= TOL


@pytest.mark.parametrize("stat", ["precision", "recall", "specificity", "npv", "f1",
                                  "accuracy"])
@pytest.mark.parametrize("kind", KINDS)
def test_binary_classification_metric_matches_jax(kind, stat):
    got, want = _run_both(jeff.binary_classification_metric(stat, 0.5),
                          teff.binary_classification_metric(stat, 0.5),
                          _batches(kind, True, 2))
    assert abs(got - want) <= TOL


@pytest.mark.parametrize("n", [2, 7, 50, 200, 201])
def test_auc_thresholds_equal_jnp_linspace(n):
    np.testing.assert_array_equal(teff.auc_thresholds(n), np.asarray(jnp.linspace(0.0, 1.0, n)))


@pytest.mark.parametrize("n_thresholds", [9, 200])
@pytest.mark.parametrize("kind", KINDS)
def test_binned_auc_matches_jax(kind, n_thresholds):
    batches = _batches(kind, True, 3)
    got, want = _run_both(jeff.binned_auc(n_thresholds), teff.binned_auc(n_thresholds), batches)
    assert abs(got - want) <= TOL
    # the counts themselves, bit for bit (probabilities on 1/8s sit exactly
    # on thresholds at n = 9, where ">=" decides)
    js, ts = jeff.binned_auc(n_thresholds).init(), teff.binned_auc(n_thresholds).init("cpu")
    for p, t, m in batches:
        js = jeff.binned_auc(n_thresholds).update(js, jnp.asarray(p), jnp.asarray(t),
                                                  jnp.asarray(m))
        ts = teff.binned_auc(n_thresholds).update(ts, torch.tensor(p), torch.tensor(t),
                                                  torch.tensor(m))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_metric_manager_prefix_names_values_as_jax():
    batches = _batches("masked", False, 4)
    jm = jbase.MetricManager((jeff.accuracy(), jeff.f1(C)), prefix="test")
    tm = tbase.MetricManager((teff.accuracy(), teff.f1(C)), prefix="test")
    js, ts = jm.init(), tm.init("cpu")
    for p, t, m in batches:
        js = jm.update(js, jnp.asarray(p), jnp.asarray(t), jnp.asarray(m))
        ts = tm.update(ts, torch.tensor(p), torch.tensor(t), torch.tensor(m))
    want, got = jm.compute(js), tm.compute(ts)
    assert list(got) == list(want) == ["test - accuracy", "test - f1"]
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= TOL
    assert list(tbase.MetricManager((teff.accuracy(),)).compute(
        tbase.MetricManager((teff.accuracy(),)).init())) == ["accuracy"]


@pytest.mark.parametrize("smoothing", [0.1, 0.5])
@pytest.mark.parametrize("kind", KINDS)
def test_ema_metric_matches_jax(kind, smoothing):
    got, want = _run_both(jbase.ema_metric(jeff.balanced_accuracy(C), smoothing),
                          tbase.ema_metric(teff.balanced_accuracy(C), smoothing),
                          _batches(kind, False, 5, n_batches=5))
    assert abs(got - want) <= TOL
    assert tbase.ema_metric(teff.accuracy()).name == "ema_accuracy"


def test_transforms_metric_matches_jax():
    jm = jbase.transforms_metric(jeff.binary_classification_metric("f1"),
                                 pred_transforms=(lambda p: p[:, :1] - 0.25,),
                                 target_transforms=(lambda t: 1 - t,), name="shifted")
    tm = tbase.transforms_metric(teff.binary_classification_metric("f1"),
                                 pred_transforms=(lambda p: p[:, :1] - 0.25,),
                                 target_transforms=(lambda t: 1 - t,), name="shifted")
    got, want = _run_both(jm, tm, _batches("random", True, 6))
    assert abs(got - want) <= TOL and tm.name == jm.name


@pytest.mark.parametrize("weighted", [True, False])
def test_aggregate_metrics_list_matches_jax(weighted):
    r = np.random.default_rng(7)
    per_client = [{"accuracy": float(r.random()), "f1": np.float32(r.random())}
                  for _ in range(5)]
    counts = [12, 40, 7, 7, 30]
    want = jagg.aggregate_metrics_list(per_client, counts, weighted)
    got = tagg.aggregate_metrics_list(
        [{k: torch.tensor(float(v)) for k, v in m.items()} for m in per_client], counts,
        weighted)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL and isinstance(got[k], float)
    assert tagg.aggregate_metrics_list([], []) == jagg.aggregate_metrics_list([], []) == {}


def test_prefix_test_metrics_splits_as_jax():
    metrics = {"val - loss": 1.0, "test - loss": 2.0, "test - accuracy": 0.5, "accuracy": 0.7}
    assert tagg.prefix_test_metrics(metrics) == jagg.prefix_test_metrics(metrics)


def test_metric_states_stay_on_the_callers_device():
    # a "meta" device stands in for the card: init and update keep to it
    for m in (teff.balanced_accuracy(C), teff.f1(C), teff.binary_classification_metric("f1"),
              teff.binned_auc(9), tbase.ema_metric(teff.accuracy())):
        state = m.init(torch.device("meta"))
        leaves = state.values() if isinstance(state, dict) else [state]
        assert all(s.device.type == "meta" for s in leaves
                   if isinstance(s, torch.Tensor)), m.name
