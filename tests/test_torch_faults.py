"""The port's ``FaultPlan`` (``resilience/faults.py``) against the JAX
package's on the CPU (``tests/resilience/test_faults.py``'s cases):

- every draw equal: the dropout keep-mask, the corruption factors, the
  straggler compute-time factors and ``summarize_round``, over rounds,
  seeds, windows and probabilities; the corrupted packets of both packet
  layouts; the validation messages word for word;
- an empty plan leaves a run bit for bit as ``fault_plan=None``, on the
  dense and the cohort routes;
- faulted synchronous runs (dropout, scaling, sign flip) match JAX's
  within 5e-4 on both dense routes and both cohort routes, each pair of
  routes bit for bit, with each round's ``summarize_round`` in
  ``round_metrics``;
- dropout takes a client out of the aggregate, and the robustness claim:
  under amplified sign-flipping clients FedAvg diverges while the median
  keeps converging, the median run within 5e-4 of JAX's."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fl4health_tpu.resilience import aggregators as jagg
from fl4health_tpu.resilience import faults as jfaults
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.server import registry as jreg
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch.resilience import aggregators as tagg
from fl4health_tpu_torch.resilience import faults as tfaults
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import registry as treg
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from tests.torch_async_sims import (assert_matches_jax, flat, jax_init, jsim_of,
                                    resilience_rows, rows, same_history, tsim_of)

C = 8


def _mixed(m, seed):
    return m.FaultPlan(seed=seed, client_faults=(
        m.ClientFault(clients=(1, 4), kind="scale", scale=3.0, probability=0.5),
        m.ClientFault(clients=(2,), kind="dropout", probability=0.5),
        m.ClientFault(clients=(0,), kind="nan", start_round=3, end_round=4),
        m.ClientFault(clients=(4, 6), kind="sign_flip", probability=0.3, start_round=2),
        m.ClientFault(clients=(5,), kind="dropout"),
        m.ClientFault(clients=(3, 5), kind="slow", scale=2.0, probability=0.5),
        m.ClientFault(clients=(5,), kind="slow", scale=3.0, end_round=6)))


@pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
def test_every_draw_equals_jax(seed):
    jp, tp = _mixed(jfaults, seed), _mixed(tfaults, seed)
    varied = set()
    for r in range(0, 9):
        keep, factors = tp.participation_factor(r, C), tp.corruption_factors(r, C)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jp.participation_factor(r, C)))
        np.testing.assert_array_equal(factors.numpy(), np.asarray(jp.corruption_factors(r, C)))
        np.testing.assert_array_equal(tp.compute_time_factors(r, C),
                                      jp.compute_time_factors(r, C))
        assert tp.summarize_round(r, C) == jp.summarize_round(r, C)
        varied.add(tuple(np.nan_to_num(factors.numpy(), nan=7.0)))
    assert len(varied) > 2  # the probabilities draw differently across rounds
    assert tfaults.FaultPlan().summarize_round(1, C) is None


def test_validation_messages_equal_jax():
    specs = [dict(clients=(0,), kind="gamma_ray"), dict(clients=(0,), kind="nan", probability=1.5),
             dict(clients=(), kind="nan"), dict(clients=(0,), kind="slow", scale=0.0)]
    for kw in specs:
        with pytest.raises(ValueError) as je:
            jfaults.ClientFault(**kw)
        with pytest.raises(ValueError) as te:
            tfaults.ClientFault(**kw)
        assert str(te.value) == str(je.value)
    for call in ("participation_factor", "corruption_factors", "compute_time_factors"):
        msgs = []
        for m in (jfaults, tfaults):
            plan = m.FaultPlan(client_faults=(m.ClientFault(clients=(C,), kind="nan"),))
            with pytest.raises(ValueError, match="cohort has") as err:
                getattr(plan, call)(1, C)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    assert tfaults.TransportFaultPolicy(drop_probability=0.4) == tfaults.TransportFaultPolicy(0.4)


def test_corrupted_packets_equal_jax():
    r = np.random.default_rng(1)
    packets = {"a": r.normal(size=(C, 3, 2)).astype(np.float32),
               "b": r.normal(size=(C, 5)).astype(np.float32)}
    payload = {"a": r.normal(size=(3, 2)).astype(np.float32),
               "b": r.normal(size=(5,)).astype(np.float32)}
    for seed in (0, 3):
        jp, tp = _mixed(jfaults, seed), _mixed(tfaults, seed)
        for rnd in (2, 3):
            want = jp.corrupt_packets({k: jnp.asarray(v) for k, v in packets.items()},
                                      {k: jnp.asarray(v) for k, v in payload.items()}, rnd, C)
            got = tp.corrupt_packets({k: torch.from_numpy(v) for k, v in packets.items()},
                                     {k: torch.from_numpy(v) for k, v in payload.items()},
                                     rnd, C)
            for k in packets:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                           atol=1e-6, equal_nan=True)
            # another layout: multiplicative on each float leaf
            want = jp.corrupt_packets({"x": jnp.asarray(packets["b"])},
                                      {k: jnp.asarray(v) for k, v in payload.items()}, rnd, C)
            got = tp.corrupt_packets({"x": torch.from_numpy(packets["b"])},
                                     {k: torch.from_numpy(v) for k, v in payload.items()},
                                     rnd, C)
            np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))


@pytest.mark.parametrize("mode", ["pipelined", "auto"])
@pytest.mark.parametrize("cohort", [False, True])
def test_an_empty_plan_is_no_plan_bit_for_bit(mode, cohort):
    data = rows(6 if cohort else 4)
    kw = (dict(cohort=treg.CohortConfig(slots=3), client_manager=tcm.FixedFractionManager(6, 0.5))
          if cohort else {})
    sims = [tsim_of(data, TFedAvg(), mode=mode, fault_plan=p, **kw)
            for p in (None, tfaults.FaultPlan(seed=9))]
    for sim in sims:
        sim.fit(3)
    assert same_history(*sims)
    assert np.array_equal(flat(sims[0].global_params), flat(sims[1].global_params))
    # the same facts (the cohort's walls aside), and no fault entry
    assert [sorted(m) for m in sims[0].round_metrics] == [sorted(m) for m in
                                                          sims[1].round_metrics]
    assert all("fault" not in m for m in sims[1].round_metrics)


def _sync_plan(m):
    return m.FaultPlan(seed=3, client_faults=(
        m.ClientFault(clients=(0,), kind="scale", scale=-5.0, probability=0.7),
        m.ClientFault(clients=(2,), kind="sign_flip", probability=0.5),
        m.ClientFault(clients=(1,), kind="dropout", probability=0.8)))


@pytest.mark.parametrize("cohort", [False, True])
def test_faulted_sync_runs_match_jax_on_both_routes(cohort):
    n, rounds = (6, 4) if cohort else (4, 4)
    data = rows(n)

    def kw(pkg):
        m, cm, rg, fedavg = ((jfaults, jcm, jreg, JFedAvg) if pkg == "jax"
                             else (tfaults, tcm, treg, TFedAvg))
        extra = (dict(cohort=rg.CohortConfig(slots=3),
                      client_manager=cm.FixedFractionManager(6, 0.5)) if cohort else {})
        return dict(strategy=fedavg(), fault_plan=_sync_plan(m), **extra)

    js = jsim_of(data, **kw("jax"))
    init = jax_init(js)
    jhist = js.fit(rounds)
    runs = []
    for mode in ("pipelined", "auto"):
        ts = tsim_of(data, mode=mode, **kw("torch"))
        ts.set_global_params(init)
        ts.fit(rounds)
        assert_matches_jax(ts, jhist, js)
        assert [m["fault"] for m in ts.round_metrics] == [
            js._fault_plan.summarize_round(r, 3 if cohort else n) for r in range(1, rounds + 1)]
        runs.append(ts)
    assert same_history(*runs)
    assert np.array_equal(flat(runs[0].global_params), flat(runs[1].global_params))
    assert any(m["fault"] and m["fault"]["dropped"] for m in runs[0].round_metrics)


def test_dropout_takes_clients_out_of_the_aggregate():
    plan = tfaults.FaultPlan(client_faults=(
        tfaults.ClientFault(clients=tuple(range(1, C)), kind="dropout"),))
    sim = tsim_of(resilience_rows(C), TFedAvg(), fault_plan=plan, n_classes=2)
    sim.fit(1)
    solo = {k: v[0] for k, v in sim.client_states.params.items()}
    np.testing.assert_allclose(flat(sim.global_params), flat(solo), rtol=1e-6)


def test_robustness_claim_median_converges_fedavg_diverges():
    """``TestRobustnessClaim``: the same seeds and plan (two clients scaled
    by -15 every round), 8 rounds."""
    def plan(m):
        return m.FaultPlan(seed=1, client_faults=(
            m.ClientFault(clients=(0, 1), kind="scale", scale=-15.0),))

    common = dict(local_epochs=None, local_steps=2, seed=7, hidden=8, n_classes=2, lr=0.1)
    data = resilience_rows(C)
    js = jsim_of(data, jagg.RobustFedAvg("median"), fault_plan=plan(jfaults), **common)
    init = jax_init(js)
    jhist = js.fit(8)
    trajectories = {}
    for name, strategy in (("median", tagg.RobustFedAvg("median")), ("fedavg", TFedAvg()),
                           ("trimmed", tagg.RobustFedAvg("trimmed_mean", trim_fraction=0.25))):
        ts = tsim_of(data, strategy, fault_plan=plan(tfaults), **common)
        ts.set_global_params(init)
        ts.fit(8)
        trajectories[name] = [r.fit_losses["backward"] for r in ts.history]
        if name == "median":
            assert_matches_jax(ts, jhist, js)
    t = trajectories["fedavg"]
    assert not t[-1] <= 2.0 * t[0], t  # blew up (or went non-finite)
    for name in ("median", "trimmed"):
        t = trajectories[name]
        assert all(np.isfinite(t)) and t[-1] < t[0], (name, t)
