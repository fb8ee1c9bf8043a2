"""The suspect ranking (``resilience/suspects.py``) and the retry primitives
(``resilience/retry.py``) against the JAX package's:

- ``rank_suspects``, ``detect_divergence_onset`` and
  ``client_ids_for_entry`` equal JAX's on seeded rings with NaN state,
  norm outliers, chaos disclosures, quarantine facts, staleness, cohort
  registry ids and a fleet-ledger prior;
- the reference drill's cohort of six: client 3's honest norms sit at
  z 2.03 against the 2.0 cut (a cohort of six caps z at sqrt(5)), and both
  packages name it;
- ``RetryPolicy.backoff_s`` under one seeded ``random.Random``, the
  breaker's state sequence under a fake clock, ``classify_failure`` and
  ``call_with_retry``'s attempts, sleeps and deadline error equal JAX's."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import math
import random

import numpy as np
import pytest

from fl4health_tpu.observability.fleet import FleetLedger as JLedger
from fl4health_tpu.resilience import retry as jretry
from fl4health_tpu.resilience import suspects as jsus
from fl4health_tpu_torch.observability.fleet import FleetLedger as TLedger
from fl4health_tpu_torch.resilience import retry as tretry
from fl4health_tpu_torch.resilience import suspects as tsus


def _ring(seed: int, n: int = 8, rounds: int = 6, cohort: bool = False) -> list[dict]:
    """A seeded ring: noisy norms with planted outliers, NaN losses and
    params, chaos disclosures, quarantine facts and staleness; with
    ``cohort``, each round's slots map to registry ids."""
    r = np.random.default_rng(seed)
    ring = []
    for rnd in range(1, rounds + 1):
        gn = r.normal(1.0, 0.1, n).astype(np.float32)
        un = r.normal(0.1, 0.01, n).astype(np.float32)
        gn[r.integers(n)] *= 6.0  # a z outlier
        un[r.integers(n)] = np.nan
        loss_nf = np.zeros(n, np.float32)
        loss_nf[r.integers(n)] = 2.0
        params_nf = np.zeros(n, np.float32)
        params_nf[r.integers(n)] = np.nan  # counts as one non-finite
        mask = (r.random(n) > 0.2).astype(np.float32)
        entry = {"round": rnd, "fit_loss": float(r.random() + (3.0 if rnd == 4 else 0.0)),
                 "mask": mask,
                 "telemetry": {"grad_norm_mean": gn, "update_norm": un,
                               "nonfinite_loss": loss_nf, "nonfinite_params": params_nf,
                               "staleness": r.integers(0, 6, n).astype(np.float32)}}
        if rnd % 2 == 0:
            bad = sorted(r.choice(n, 2, replace=False).tolist())
            entry["fault"] = {"round": rnd, "dropped": [], "corrupted": bad,
                              "kinds": {"scale": bad}}
        if rnd >= 3:
            q = np.zeros(n, np.float32)
            q[r.integers(n)] = 1.0
            entry["quarantine"] = q
            entry["quarantine_active"] = [int(c) for c in np.nonzero(q)[0]]
        if cohort:
            entry["registry_ids"] = np.sort(r.choice(1000, n, replace=False))
        ring.append(entry)
    r.shuffle(ring)  # the ranking sorts by round itself
    return ring


def _ledgers(seed: int, n: int = 8):
    """The same lifetime history absorbed by a fleet ledger of each package."""
    r = np.random.default_rng(seed)
    out = []
    for cls in (JLedger, TLedger):
        led, rr = cls(), np.random.default_rng(seed)
        for rnd in range(1, 5):
            ids = np.arange(n)
            led.absorb_round(rnd, ids, losses=rr.random(n), update_norms=rr.random(n),
                             nonfinite=(rr.random(n) > 0.8).astype(np.float32),
                             quarantined_ids=[int(rr.integers(n))],
                             fault_ids=[int(rr.integers(n))])
        out.append(led)
    del r
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cohort", [False, True])
def test_ranking_equals_jax_on_seeded_rings(seed, cohort):
    ring = _ring(seed, cohort=cohort)
    jled, tled = _ledgers(seed)
    for top in (3, 8):
        assert tsus.rank_suspects(ring, top=top) == jsus.rank_suspects(ring, top=top)
        # the ledger prior, from a live ledger and from its snapshot
        want = jsus.rank_suspects(ring, top=top, ledger=jled)
        assert tsus.rank_suspects(ring, top=top, ledger=tled) == want
        assert tsus.rank_suspects(ring, top=top, ledger=tled.snapshot()) == want
    for entry in ring:
        np.testing.assert_array_equal(tsus.client_ids_for_entry(entry),
                                      jsus.client_ids_for_entry(entry))


def test_onset_equals_jax():
    ring = _ring(4)
    for factor in (1.3, 2.0, 5.0):
        assert (tsus.detect_divergence_onset(ring, factor)
                == jsus.detect_divergence_onset(ring, factor))
    nan_ring = [{"round": 1, "fit_loss": 1.0}, {"round": 2, "fit_loss": float("nan")}]
    got = tsus.detect_divergence_onset(nan_ring)
    want = jsus.detect_divergence_onset(nan_ring)
    assert got["round"] == want["round"] == 2 and got["reason"] == want["reason"]
    assert math.isnan(got["loss"]) and got["best"] == want["best"] == 1.0
    assert tsus.detect_divergence_onset([]) is jsus.detect_divergence_onset([]) is None


def test_a_cohort_of_six_names_its_largest_honest_norm():
    """The reference drill's round 3 (grad and update norms as its ring
    holds them): client 3 trains honestly, yet its norms stand 2.03 and
    2.05 sigma above the cohort mean, past the 2.0 cut, so both packages
    rank it (the cut is JAX's; a cohort of six caps z at sqrt(5))."""
    gn = np.asarray([1.088, 1.429, 1.221, 2.428, 0.762, 1.374], np.float32)
    un = np.asarray([0.101, 0.134, 0.115, 0.239, 0.069, 0.128], np.float32)
    ring = [{"round": 3, "fit_loss": 1.28, "mask": np.ones(6, np.float32),
             "telemetry": {"grad_norm_mean": gn, "update_norm": un},
             "fault": {"round": 3, "dropped": [], "corrupted": [1, 2],
                       "kinds": {"scale": [1, 2]}}}]
    got, want = tsus.rank_suspects(ring), jsus.rank_suspects(ring)
    assert got == want
    assert [s["client"] for s in got] == [1, 2, 3]
    assert 2.0 < got[2]["score"] / 2 < math.sqrt(5)


# -- retry ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"jitter": 0.0}, {"base_delay_s": 0.5, "max_delay_s": 1.0,
                                                      "backoff_factor": 3.0}])
def test_backoff_equals_jax(kw):
    tp, jp = tretry.RetryPolicy(**kw), jretry.RetryPolicy(**kw)
    tr, jr = random.Random(11), random.Random(11)
    assert ([tp.backoff_s(a, tr) for a in range(8)]
            == [jp.backoff_s(a, jr) for a in range(8)])


@pytest.mark.parametrize("kw", [{"max_attempts": 0}, {"jitter": 1.5},
                                {"base_delay_s": 2.0, "max_delay_s": 1.0},
                                {"deadline_s": 0.0}])
def test_policy_validation_equals_jax(kw):
    with pytest.raises(ValueError) as te:
        tretry.RetryPolicy(**kw)
    with pytest.raises(ValueError) as je:
        jretry.RetryPolicy(**kw)
    assert str(te.value) == str(je.value)


def test_breaker_state_sequence_equals_jax():
    def drive(mod):
        now = [0.0]
        b = mod.CircuitBreaker(failure_threshold=2, reset_after_s=5.0, clock=lambda: now[0])
        seq = []
        for t, op in ((0, "fail"), (1, "fail"), (2, "allow"), (6, "allow"), (6, "allow"),
                      (6, "fail"), (7, "allow"), (12, "allow"), (12, "ok"), (13, "allow"),
                      (13, "fail"), (14, "fail"), (14, "allow")):
            now[0] = float(t)
            if op == "fail":
                b.record_failure()
            elif op == "ok":
                b.record_success()
            else:
                seq.append(b.allow())
            seq.append(b.state)
        return seq

    assert drive(tretry) == drive(jretry)
    with pytest.raises(ValueError):
        tretry.CircuitBreaker(failure_threshold=0)


def test_classify_failure_equals_jax():
    excs = [TimeoutError("t"), ConnectionResetError("c"), ValueError("v"), KeyError("k"),
            TypeError("x"), OSError("o"), RuntimeError("r")]
    for e in excs:
        assert tretry.classify_failure(e) == jretry.classify_failure(e)
    assert tretry.classify_failure(tretry.CircuitOpenError()) == "circuit_open"
    assert tretry.classify_failure(tretry.RetryDeadlineError()) == "deadline"


@pytest.mark.parametrize("deadline", [None, 0.12])
def test_call_with_retry_equals_jax(deadline):
    def drive(mod):
        now, sleeps, calls, seen = [0.0], [], [0], []

        def do_call():
            calls[0] += 1
            now[0] += 0.01
            if calls[0] < 4:
                raise ConnectionError(f"down {calls[0]}")
            return "up"

        def sleep(s):
            sleeps.append(s)
            now[0] += s

        policy = mod.RetryPolicy(max_attempts=5, base_delay_s=0.05, deadline_s=deadline)
        try:
            out = mod.call_with_retry(
                do_call, policy, breaker=mod.CircuitBreaker(failure_threshold=10),
                on_failure=lambda e, a, w: seen.append((type(e).__name__, a, w)),
                sleep=sleep, rng=random.Random(3), clock=lambda: now[0])
        except Exception as e:  # noqa: BLE001 (the outcome is compared)
            out = (type(e).__name__, str(e), type(e.__cause__).__name__)
        return out, sleeps, calls[0], seen

    assert drive(tretry) == drive(jretry)
