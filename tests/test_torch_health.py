"""The health watchdog (``observability/health.py``) against the JAX
package: the same ``HealthPolicy``s fed the same host telemetry decide
alike (summaries, halts, quarantine keep-masks, the ``health`` and
``quarantine`` events, the gauges), and a NaN-poisoned client halts ``fit``
naming the same round, client and check in both packages, on both routes of
the port."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import numpy as np
import pytest

from fl4health_tpu.observability import health as jhealth
from fl4health_tpu_torch.observability import health as thealth
from torch_obs_sims import data_of, obs_of, sim_of

FIELDS = ("train_loss", "train_loss_min", "train_loss_max", "grad_norm_mean",
          "grad_norm_max", "update_norm", "clip_fraction", "nonfinite_params",
          "nonfinite_loss", "nonfinite_eval_loss", "divergence")


def _rounds(n_clients=5, n_rounds=8):
    """Host telemetry rounds with every signal: a NaN client (round 3), a
    dead client (near-zero update norms from round 2), a skewed one
    (round 5), and aggregate losses that diverge (rounds 6-7)."""
    r = np.random.default_rng(11)
    out = []
    for rnd in range(1, n_rounds + 1):
        t = {k: r.uniform(0.5, 1.5, n_clients).astype(np.float32) for k in FIELDS}
        for k in ("nonfinite_params", "nonfinite_loss", "nonfinite_eval_loss"):
            t[k] = np.zeros(n_clients, np.float32)
        if rnd == 3:
            t["train_loss"][2] = np.nan
            t["nonfinite_params"][2] = 4.0
        if rnd >= 2:
            t["update_norm"][1] = 1e-4
        if rnd == 5:
            t["update_norm"][4] = 40.0
        mask = np.ones(n_clients, np.float32)
        if rnd == 4:
            mask[0] = 0.0
        loss = [1.0, 0.8, 0.7, 0.7, 0.6, 1.5, 1.6, 0.5][rnd - 1]
        out.append((rnd, t, mask, loss))
    return out


POLICIES = {
    "default": {},
    "everything": dict(on_nonfinite="mitigate", loss_divergence_window=2,
                       loss_divergence_factor=2.0, on_loss_divergence="warn",
                       dead_client_norm=0.01, dead_client_rounds=2, on_dead_client="mitigate",
                       skew_ratio=5.0, on_skew="warn", quarantine_rounds=2),
    "halt_on_skew": dict(on_nonfinite="warn", skew_ratio=5.0, on_skew="halt"),
}


def _drive(pkg_health, pkg, policy):
    obs = obs_of(pkg)
    dog = pkg_health.HealthWatchdog(pkg_health.HealthPolicy(**policy))
    trace = []
    for rnd, t, mask, loss in _rounds():
        try:
            trace.append(("ok", dog.observe(rnd, t, mask, loss, obs=obs)))
        except pkg_health.TrainingHealthError as e:
            trace.append(("halt", str(e), e.round, e.clients, e.check))
            break
        keep = dog.quarantine_keep_mask(5)
        trace.append(("keep", None if keep is None else keep.tolist()))
    evs = [{k: v for k, v in e.items() if k != "ts"} for e in obs.registry.events]
    obs.shutdown()
    return trace, evs, obs.registry.snapshot(), obs.unhealthy_reason is not None


@pytest.mark.parametrize("policy", list(POLICIES))
def test_watchdog_decisions_equal_jax(policy):
    got = _drive(thealth, "torch", POLICIES[policy])
    want = _drive(jhealth, "jax", POLICIES[policy])
    assert got == want
    assert any(step[0] == "halt" for step in got[0]) == (policy != "everything")


def test_policy_validation_equals_jax():
    for bad in (dict(on_nonfinite="explode"), dict(loss_divergence_window=-1),
                dict(quarantine_rounds=0)):
        with pytest.raises(ValueError) as tj:
            jhealth.HealthPolicy(**bad)
        with pytest.raises(ValueError) as tt:
            thealth.HealthPolicy(**bad)
        assert str(tt.value) == str(tj.value)


def _halt(pkg, mode="auto"):
    obs = obs_of(pkg, watchdog=(jhealth if pkg == "jax" else thealth).HealthWatchdog(
        (jhealth if pkg == "jax" else thealth).HealthPolicy()))
    sim = sim_of(pkg, data_of(4, poison=3), mode=mode, obs=obs)
    with pytest.raises((jhealth if pkg == "jax" else thealth).TrainingHealthError) as ei:
        sim.fit(2)
    return sim, obs, ei.value


def test_nan_client_halts_as_in_jax_on_both_routes():
    js, jobs, jerr = _halt("jax")
    for mode in ("chunked", "pipelined"):
        ts, tobs, terr = _halt("torch", mode)
        assert (terr.round, terr.clients, terr.check, str(terr)) == (
            jerr.round, jerr.clients, jerr.check, str(jerr)) == (
            1, [3], "nonfinite", str(jerr))
        # the round's record landed before the halt, and /healthz went 503
        assert [r.round for r in ts.history] == [1]
        assert tobs.unhealthy_reason is not None
        health = [e for e in tobs.registry.events if e["event"] == "health"]
        assert health[-1]["status"] == "halt" and health[-1]["nonfinite_clients"] == [3]
