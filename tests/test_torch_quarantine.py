"""The in-graph quarantine (``resilience/quarantine.py``) and its records in
``FederatedSimulation`` against the JAX package:

- ``quarantine_step`` over 6 seeded rounds under four policies, and
  ``_masked_median`` at odd k, even k and k = 0, equal to JAX's bit for
  bit; the policy's checks and messages equal JAX's;
- ``QuarantiningStrategy`` around FedAvg on the chunked and the pipelined
  route (the reference drill's recipe, its scale fault caught as norm
  outliers): the quarantine state, the ``quarantine`` JSONL events, the
  ``fl_quarantine_*`` gauge and counters, the flight recorder's
  ``quarantine`` facts and the fleet ledger's strikes equal JAX's, the
  losses and params within 5e-4;
- under a cohort (6 registry clients, 4 slots, slot 1's occupant sending a
  scaled update), the strategy's rows ride the registry and the events name
  registry ids, as JAX's do."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.resilience import quarantine as jq
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.server.registry import CohortConfig as JCohort
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.resilience import quarantine as tq
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server.registry import CohortConfig as TCohort
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from torch_resilience_sims import (POISONED, TOL, drill_obs, drill_pair, drill_sim, events,
                                   scale_fault, strip_ts)

POLICIES = {
    "default": {},
    "norm_outlier": {"norm_outlier_ratio": 3.0, "quarantine_rounds": 2},
    "dead": {"dead_norm": 0.05, "dead_rounds": 2, "quarantine_rounds": 3},
    "two_strikes": {"strikes_to_quarantine": 2, "quarantine_rounds": 1,
                    "norm_outlier_ratio": 2.0},
}


def _state_np(q) -> dict:
    return {f: np.asarray(getattr(q, f)) for f in
            ("quarantined", "strikes", "release_in", "dead_streak")}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_quarantine_step_equals_jax(name):
    n, r = 9, np.random.default_rng(7)
    jp, tp = jq.QuarantinePolicy(**POLICIES[name]), tq.QuarantinePolicy(**POLICIES[name])
    jstate, tstate = jq.init_quarantine(n), tq.init_quarantine(n)
    for _ in range(6):
        mask = (r.random(n) > 0.25).astype(np.float32)
        nonfinite = (r.random(n) > 0.85).astype(np.float32)
        norm = r.gamma(2.0, 0.05, n).astype(np.float32)
        norm[r.integers(n)] *= 20.0
        norm[r.integers(n)] = 0.01
        if r.random() > 0.5:
            norm[r.integers(n)] = np.nan
        jstate = jq.quarantine_step(jstate, jp, mask=jnp.asarray(mask),
                                    nonfinite=jnp.asarray(nonfinite),
                                    update_norm=jnp.asarray(norm))
        tstate = tq.quarantine_step(tstate, tp, mask=torch.from_numpy(mask),
                                    nonfinite=torch.from_numpy(nonfinite),
                                    update_norm=torch.from_numpy(norm))
        want, got = _state_np(jstate), _state_np(tstate)
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("keep", [[1, 1, 0, 1, 1, 0, 1], [1, 1, 0, 1, 0, 0, 1],
                                  [0, 0, 0, 0, 0, 0, 0]], ids=["odd_k", "even_k", "k0"])
def test_masked_median_equals_jax(keep):
    v = np.asarray([0.3, -1.0, 9.0, 2.5, 0.7, np.inf, 1.25], np.float32)
    k = np.asarray(keep, bool)
    got = tq._masked_median(torch.from_numpy(v), torch.from_numpy(k))
    want = jq._masked_median(jnp.asarray(v), jnp.asarray(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if k.sum() == 4:  # the mean of the two middle values (0.3, 1.25), not the lower one
        assert float(got) == float(np.float32(0.5) * (v[0] + v[6]))


@pytest.mark.parametrize("kw", [{"strikes_to_quarantine": 0}, {"quarantine_rounds": 0},
                                {"dead_rounds": 0}])
def test_policy_checks_equal_jax(kw):
    with pytest.raises(ValueError) as te:
        tq.QuarantinePolicy(**kw)
    with pytest.raises(ValueError) as je:
        jq.QuarantinePolicy(**kw)
    assert str(te.value) == str(je.value)


def _quarantine_runs(mode: str, rounds: int = 5):
    policy = {"norm_outlier_ratio": 3.0, "quarantine_rounds": 2}
    out = {}

    def make(pkg, init):
        mod, inner = (jq, JFedAvg()) if pkg == "jax" else (tq, TFedAvg())
        obs = drill_obs(pkg, watchdog=False)
        out[pkg] = obs
        return drill_sim(pkg, mode, strategy=mod.QuarantiningStrategy(
            inner, mod.QuarantinePolicy(**policy)), obs=obs, fault=scale_fault(pkg), init=init)

    js, ts = drill_pair(mode, make)
    js.fit(rounds)
    ts.fit(rounds)
    return js, ts, out["jax"], out["torch"]


@pytest.fixture(scope="module", params=["chunked", "pipelined"])
def quarantine_runs(request):
    return _quarantine_runs(request.param)


def test_quarantining_strategy_trains_as_jax(quarantine_runs):
    js, ts, _, _ = quarantine_runs
    for jr, tr in zip(js.history, ts.history):
        for k in jr.fit_losses:
            np.testing.assert_allclose(tr.fit_losses[k], jr.fit_losses[k], rtol=TOL, atol=TOL)
    want = convert.flax_to_torch(js.global_params)
    for k, v in ts.global_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=TOL, atol=TOL)
    want, got = _state_np(js.server_state.quarantine), _state_np(ts.server_state.quarantine)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    # the scale fault's clients entered quarantine
    entered = {c for e in events(quarantine_runs[3], "quarantine") for c in e["entered"]}
    assert entered == set(POISONED)


def test_quarantine_records_equal_jax(quarantine_runs):
    js, ts, jobs_, tobs_ = quarantine_runs
    jev = [strip_ts(e) for e in events(jobs_, "quarantine")]
    tev = [strip_ts(e) for e in events(tobs_, "quarantine")]
    assert tev == jev and jev, jev
    assert any(e["entered"] for e in tev)
    jsnap, tsnap = jobs_.registry.snapshot(), tobs_.registry.snapshot()
    for name in ("fl_quarantine_active_clients", "fl_quarantine_entries_total",
                 "fl_quarantine_releases_total"):
        assert tsnap.get(name) == jsnap.get(name), name
    jring = {e["round"]: e for e in jobs_.flight_recorder.entries}
    tring = {e["round"]: e for e in tobs_.flight_recorder.entries}
    assert tring.keys() == jring.keys()
    for r in jring:
        np.testing.assert_array_equal(tring[r]["quarantine"], jring[r]["quarantine"])
        assert tring[r]["quarantine_active"] == jring[r]["quarantine_active"]
    jled = {d["client_id"]: d for d in jobs_.fleet_ledger.snapshot()["clients"]}
    tled = {d["client_id"]: d for d in tobs_.fleet_ledger.snapshot()["clients"]}
    for cid in jled:
        for f in ("quarantine_strikes", "quarantine_releases", "quarantined"):
            assert tled[cid][f] == jled[cid][f], (cid, f)


def test_cohort_quarantine_rides_the_registry_as_jax():
    from fl4health_tpu import resilience as jres
    from fl4health_tpu_torch import resilience as tres

    out = {}

    def make(pkg, init):
        jax_side = pkg == "jax"
        mod, inner, res = (jq, JFedAvg(), jres) if jax_side else (tq, TFedAvg(), tres)
        cm = (jcm if jax_side else tcm).FixedFractionManager(6, 4 / 6)
        obs = drill_obs(pkg, watchdog=False)
        out[pkg] = obs
        # slot 1's occupant each round sends a scaled update
        fault = res.FaultPlan(seed=3, client_faults=(res.ClientFault(
            clients=(1,), kind="scale", scale=-15.0, probability=1.0),))
        return drill_sim(pkg, "pipelined", strategy=mod.QuarantiningStrategy(
            inner, mod.QuarantinePolicy(norm_outlier_ratio=3.0, quarantine_rounds=2)),
            obs=obs, client_manager=cm, fault=fault,
            cohort=(JCohort if jax_side else TCohort)(slots=4), init=init)

    js, ts = drill_pair("pipelined", make)
    js.fit(4)
    ts.fit(4)
    jev = [strip_ts(e) for e in events(out["jax"], "quarantine")]
    tev = [strip_ts(e) for e in events(out["torch"], "quarantine")]
    assert tev == jev
    assert any(e["entered"] for e in tev)  # registry ids, kept across rounds
    assert ts.registry.dirty_rows == js.registry.dirty_rows
    for jr, tr in zip(js.history, ts.history):
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   rtol=TOL, atol=TOL)
