"""The recovery supervisor (``resilience/supervisor.py``) and its wiring in
``FederatedSimulation`` against the JAX package:

- ``RecoveryPolicy``'s checks and messages, and the simulation's refusal
  of a duck-typed policy, equal JAX's;
- the ladder, the roster and probation on a scripted fake simulation,
  driven through both supervisors alike: the same attempts, resets,
  rebuilds, swaps, relaxations, rosters, events and ledger documents; a
  ledger written by either package's supervisor is read by the other's;
- ``ClientRegistry.reset_rows`` and ``_reset_to_initial`` rebuild a fresh
  simulation's states bit for bit; an armed policy that never engages
  leaves a run bit for bit as it was, on both routes;
- the reference drill on both routes (a probability-1 scale fault, the
  watchdog, a frame every round): the unsupervised halt, then the
  supervised run's verdicts, suspect rankings, rungs, rollbacks, roster,
  ledger, metrics and bundles equal JAX's, the losses within 5e-4. Both
  packages name client 3 too (ROADMAP.md R8);
- the pipelined cohort route quarantines by registry id as JAX does, and
  the chunked cohort route refuses supervision with JAX's reason;
- R7: ``InstanceLevelDpServer`` reports the epsilon of ``n_rounds`` in both
  packages though a rollback made the run dispatch more rounds."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import json

import numpy as np
import pytest
import torch

from fl4health_tpu import observability as jobs
from fl4health_tpu import resilience as jres
from fl4health_tpu.checkpointing.state import CheckpointCorruptError as JCorrupt
from fl4health_tpu.checkpointing.state import SimulationStateCheckpointer as JCheckpointer
from fl4health_tpu.observability import bundle as jbundle
from fl4health_tpu.server import client_manager as jcm
from fl4health_tpu.server.registry import CohortConfig as JCohort
from fl4health_tpu.server import servers as jservers
from fl4health_tpu.server.servers import InstanceLevelDpServer as JDpServer
from fl4health_tpu.server.simulation import FailurePolicy as JFailurePolicy
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu.transport import QuorumError as JQuorumError
from fl4health_tpu_torch import observability as tobs
from fl4health_tpu_torch import resilience as tres
from fl4health_tpu_torch.checkpointing.state import CheckpointCorruptError as TCorrupt
from fl4health_tpu_torch.checkpointing.state import SimulationStateCheckpointer as TCheckpointer
from fl4health_tpu_torch.models import convert
from fl4health_tpu_torch.observability import bundle as tbundle
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server.registry import CohortConfig as TCohort
from fl4health_tpu_torch.server import servers as tservers
from fl4health_tpu_torch.server.servers import InstanceLevelDpServer as TDpServer
from fl4health_tpu_torch.server.simulation import FailurePolicy as TFailurePolicy
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from torch_obs_sims import data_of, sim_of
from torch_resilience_sims import (TOL, drill_data, drill_obs, drill_pair, drill_sim, events,
                                   scale_fault, strip_ts)

PKGS = ("jax", "torch")


def _m(pkg, j, t):
    return j if pkg == "jax" else t


# -- the policy ------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"rungs": ()}, {"rungs": ("nope",)}, {"rungs": ("retry", "retry")},
    {"recover_kinds": ("sigterm",)}, {"attempts_per_rung": 0}, {"max_total_attempts": 0},
    {"probation_rounds": 0}, {"quarantine_rounds": -1}, {"max_suspects": 0},
    {"quorum_relax": 0.0}, {"cohort_shrink": 1.5}, {"server_lr_factor": 0.0},
    {"robust_method": "nope"}])
def test_policy_checks_equal_jax(kw):
    with pytest.raises(ValueError) as te:
        tres.RecoveryPolicy(**kw)
    with pytest.raises(ValueError) as je:
        jres.RecoveryPolicy(**kw)
    assert str(te.value) == str(je.value)


def test_defaults_and_the_duck_typed_policy_as_jax():
    assert tres.RecoveryPolicy() == tres.RecoveryPolicy(
        **{f: getattr(jres.RecoveryPolicy(), f)
           for f in jres.RecoveryPolicy.__dataclass_fields__})
    msgs = []
    for pkg in PKGS:
        with pytest.raises(TypeError) as e:
            drill_sim(pkg, recovery={"rungs": ("retry",)})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "RecoveryPolicy" in msgs[0]


# -- the ladder on a scripted simulation ------------------------------------

class _Manager:
    def __init__(self, fraction=0.5, n_clients=8):
        self.fraction = fraction
        self.n_clients = n_clients


class _FakeSim:
    """The surface the supervisor drives, in one package; ``failures`` is
    the exception each successive attempt raises (None: a clean end)."""

    def __init__(self, pkg, failures, strategy=None, manager=None, checkpointer=None):
        m = _m(pkg, jobs, tobs)
        self._failures = list(failures)
        self.observability = m.Observability(enabled=False, tracer=m.Tracer(),
                                             registry=m.MetricsRegistry())
        self.state_checkpointer = checkpointer
        self.strategy = strategy if strategy is not None else _m(pkg, JFedAvg, TFedAvg)()
        self.client_manager = manager
        self._async_active = self._cohort_active = False
        self.n_clients, self._fit_n_rounds = 8, 4
        self.fits = self.resets = self.rebuilds = 0

    def _fit_unsupervised(self, n_rounds):
        self.fits += 1
        if self._failures:
            exc = self._failures.pop(0)
            if exc is not None:
                raise exc
        return "done"

    def _reset_to_initial(self):
        self.resets += 1

    def _build_compiled(self):
        self.rebuilds += 1


def _halt(pkg, round_=2, clients=(3,)):
    return _m(pkg, jobs, tobs).TrainingHealthError(
        "halt", round=round_, clients=list(clients), check="nonfinite")


class QuorumError(RuntimeError):
    """The port's verdicts match ``QuorumError`` by name (its transport is
    not ported); this stand-in carries JAX's attributes."""

    def __init__(self, message, *, required, succeeded, failures):
        super().__init__(message)
        self.required, self.succeeded, self.failures = required, succeeded, failures


def _outcome(sup, sim, run):
    try:
        result = run()
    except BaseException as e:  # noqa: BLE001 (the outcome is compared)
        result = type(e).__name__
    doc = sup._ledger_doc()
    if doc["last_verdict"]:
        doc["last_verdict"] = {k: v for k, v in doc["last_verdict"].items() if k != "ts"}
    return {"result": result, "attempts": dict(sup._attempts), "total": sup._total_attempts,
            "fits": sim.fits, "resets": sim.resets, "rebuilds": sim.rebuilds,
            "strategy": type(sim.strategy).__name__,
            "fraction": getattr(sim.client_manager, "fraction", None),
            "quorum": sup.quorum_control.quorum if sup.quorum_control else None,
            "roster": sup.quarantined_ids(1), "ledger": doc}


SCENARIOS = {
    "every_rung_then_halt": lambda pkg: (
        [_halt(pkg)] * 5, dict(manager=_Manager()),
        dict(attempts_per_rung=1, probation_rounds=100), 3),
    "recovers": lambda pkg: ([_halt(pkg), None], {}, {}, None),
    "quarantine_skipped": lambda pkg: (
        [_halt(pkg, clients=()), _halt(pkg, clients=())], {},
        dict(rungs=("quarantine", "robustify")), None),
    "non_recoverable": lambda pkg: ([RuntimeError("boom")], {}, {}, None),
    "max_total_attempts": lambda pkg: (
        [_halt(pkg)] * 10, {}, dict(attempts_per_rung=10, max_total_attempts=2), None),
    "quorum": lambda pkg: (
        [(JQuorumError if pkg == "jax" else QuorumError)(
            "quorum lost", required=3, succeeded=1, failures=[("h:1", "timeout")]), None],
        dict(manager=_Manager()), dict(rungs=("degrade",)), 3),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ladder_equals_jax(name):
    out = []
    for pkg in PKGS:
        failures, sim_kw, pol_kw, quorum = SCENARIOS[name](pkg)
        sim = _FakeSim(pkg, failures, **sim_kw)
        m = _m(pkg, jres, tres)
        sup = m.RecoverySupervisor(
            sim, m.RecoveryPolicy(**pol_kw),
            quorum_control=m.QuorumControl(quorum=quorum) if quorum else None)
        out.append(_outcome(sup, sim, lambda: sup.run(4)))
    assert out[0] == out[1]


def test_corrupt_checkpoint_clears_the_ring_as_jax(tmp_path):
    out = []
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        sc = _m(pkg, JCheckpointer, TCheckpointer)(str(d))
        bad = d / "state.g00000001.ckpt"
        bad.write_bytes(b"FL4HCKPT garbage")
        err = _m(pkg, JCorrupt, TCorrupt)(str(bad), "CRC32 mismatch")
        sim = _FakeSim(pkg, [err, None], checkpointer=sc)
        m = _m(pkg, jres, tres)
        sup = m.RecoverySupervisor(sim, m.RecoveryPolicy(rungs=("retry",)))
        res = _outcome(sup, sim, lambda: sup.run(4))
        assert not sc.exists()
        out.append(res)
    assert out[0]["ledger"].pop("last_verdict") == out[1]["ledger"].pop("last_verdict")
    assert out[0] == out[1]


def test_roster_and_probation_equal_jax():
    out = []
    for pkg in PKGS:
        m = _m(pkg, jres, tres)
        sim = _FakeSim(pkg, [])
        sup = m.RecoverySupervisor(sim, m.RecoveryPolicy(quarantine_rounds=3))
        rec = [sup.keep_mask(1, 6)]
        rec.append(sup._apply_quarantine([1, 4], resume_round=5))
        rec += [sup.keep_mask(5, 6).tolist(), sup.quarantined_ids(7), sup.keep_mask(8, 6),
                sup.quarantined_ids(8)]
        obs = sim.observability
        obs.enabled = True
        sup2 = m.RecoverySupervisor(sim, m.RecoveryPolicy(probation_rounds=2,
                                                          attempts_per_rung=3))
        sup2._attempts, sup2._rung_idx, sup2._engaged = {"retry": 2}, 1, True
        sup2._probation_after = 4
        obs.mark_unhealthy("recovering")
        for r in (3, 4, 5):
            sup2.note_round(r)
            rec.append((sup2._healthy_rounds, sup2._engaged, obs.unhealthy_reason))
        sup2.note_round(6)
        snap = obs.registry.snapshot()
        rec += [sup2._engaged, sup2._attempts, sup2._rung_idx, obs.unhealthy_reason,
                snap["fl_recovery_engaged"], snap["fl_recovery_probations_passed_total"],
                [strip_ts(e) for e in obs.registry.events]]
        out.append(rec)
    assert out[0] == out[1]


def _ledger_run(pkg, path, quorum_ctl=None):
    m = _m(pkg, jres, tres)
    sim = _FakeSim(pkg, [_halt(pkg, clients=(2,)), _halt(pkg), _halt(pkg), None],
                   manager=_m(pkg, jcm, tcm).FixedFractionManager(8, 0.5))
    sup = m.RecoverySupervisor(
        sim, m.RecoveryPolicy(rungs=("quarantine", "robustify", "degrade"),
                              quarantine_rounds=0),
        ledger_path=str(path), quorum_control=quorum_ctl)
    assert sup.run(4) == "done"
    return sim


@pytest.mark.parametrize("writer", PKGS)
def test_ledgers_cross_read(writer, tmp_path):
    """Either package's supervisor writes JAX's document, and the other's
    re-arms from it: the roster, the robustify swap and the degraded
    fraction and quorum."""
    reader = "torch" if writer == "jax" else "jax"
    docs = {}
    for pkg in PKGS:
        _ledger_run(pkg, tmp_path / f"{pkg}.json",
                    _m(pkg, jres, tres).QuorumControl(quorum=3))
        doc = json.loads((tmp_path / f"{pkg}.json").read_text())
        doc["last_verdict"].pop("ts")
        docs[pkg] = doc
    assert docs["jax"] == docs["torch"]
    m = _m(reader, jres, tres)
    sim = _FakeSim(reader, [], manager=_m(reader, jcm, tcm).FixedFractionManager(8, 0.5))
    ctl = m.QuorumControl(quorum=3)
    sup = m.RecoverySupervisor(sim, m.RecoveryPolicy(), ledger_path=str(
        tmp_path / f"{writer}.json"), quorum_control=ctl)
    assert sup.quarantined_ids(1) == [2] and sup._engaged and sup._total_attempts == 3
    assert type(sim.strategy).__name__ == "RobustFedAvg" and sim.rebuilds == 1
    assert sim.client_manager.fraction == pytest.approx(0.25) and sim.client_manager.k == 2
    assert ctl.quorum == 2


# -- mitigations on real simulations -------------------------------------------

def test_in_graph_seeding_equals_jax():
    """The quarantine rung's post-restore seeding of a
    ``QuarantiningStrategy``'s state, by tensor indexing in the port."""
    out = []
    for pkg in PKGS:
        m, inner = (jres, JFedAvg()) if pkg == "jax" else (tres, TFedAvg())
        sim = drill_sim(pkg, strategy=m.QuarantiningStrategy(inner, m.QuarantinePolicy()))
        sup = m.RecoverySupervisor(sim, m.RecoveryPolicy(quarantine_rounds=4))
        sup._engaged, sup._pending_seed = True, [1, 3]
        sup.on_resume(2)
        q = sim.server_state.quarantine
        out.append([np.asarray(getattr(q, f)).tolist()
                    for f in ("quarantined", "strikes", "release_in", "dead_streak")])
    assert out[0] == out[1]
    assert out[1][0] == [0, 1, 0, 1, 0, 0] and out[1][2][1] == out[1][2][3] == 4.0


def test_robustify_rung_on_real_simulations_as_jax():
    from fl4health_tpu.strategies.fedopt import fed_adam as jfed_adam
    from fl4health_tpu_torch.core.pytree import tree_leaves
    from fl4health_tpu_torch.strategies.fedopt import fed_adam as tfed_adam

    facts = {}
    for pkg in PKGS:
        m = _m(pkg, jres, tres)
        sim = drill_sim(pkg)
        sup = m.RecoverySupervisor(sim, m.RecoveryPolicy())
        facts[pkg] = [sup._apply_robustify()]
        assert type(sim.strategy).__name__ == "RobustFedAvg"
        tight = drill_sim(pkg, strategy=m.RobustFedAvg(method="trimmed_mean"))
        facts[pkg].append(m.RecoverySupervisor(tight, m.RecoveryPolicy())._apply_robustify())
        facts[pkg].append(tight.strategy.trim_fraction)
        adam = drill_sim(pkg, strategy=_m(pkg, jfed_adam, tfed_adam)(lr=0.01))
        facts[pkg].append(m.RecoverySupervisor(adam, m.RecoveryPolicy())._robustify_target())
        if pkg == "torch":
            # RobustFedAvg's state is FedAvg's: the swapped simulation fits
            before = [t.shape for t in tree_leaves(sim.server_state)]
            assert len(sim.fit(2)) == 2
            assert [t.shape for t in tree_leaves(sim.server_state)] == before
    assert facts["jax"] == facts["torch"]
    assert facts["torch"][0] == {"robustify": "swap", "method": "trimmed_mean",
                                 "trim_fraction": 0.2}
    assert facts["torch"][2] == pytest.approx(0.3) and facts["torch"][3] is None


def test_client_failures_heal_by_quarantine_as_jax():
    """``accept_failures=False`` and a NaN client 2: the supervisor
    quarantines it (a restart: no ring) and the run completes."""
    rosters = []
    for pkg in PKGS:
        sim = drill_sim(pkg, "pipelined", data=drill_data(4, poison_nan=(2,)),
                        failure_policy=_m(pkg, JFailurePolicy, TFailurePolicy)(
                            accept_failures=False),
                        recovery=_m(pkg, jres, tres).RecoveryPolicy(rungs=("quarantine",),
                                                                    quarantine_rounds=0))
        assert len(sim.fit(3)) == 3
        rosters.append(sim._recovery_supervisor.quarantined_ids(1))
    assert rosters == [[2], [2]]


# -- resets and the idle policy ----------------------------------------------

def _states_equal(a, b) -> bool:
    from fl4health_tpu_torch.core.pytree import tree_leaves

    la = tree_leaves(a.server_state) + tree_leaves(a.client_states)
    lb = tree_leaves(b.server_state) + tree_leaves(b.client_states)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("cohort", [False, True])
def test_reset_to_initial_rebuilds_a_fresh_simulation(cohort):
    kw = (dict(client_manager=tcm.FixedFractionManager(6, 0.5), cohort=TCohort(slots=3))
          if cohort else {})
    obs = drill_obs("torch", watchdog=False)
    run = drill_sim("torch", "pipelined", obs=obs, **kw)
    run.fit(2)
    assert run.history and obs.fleet_ledger.snapshot()["clients"]
    if cohort:
        assert run.registry.dirty_rows > 0
    run._reset_to_initial()
    fresh = drill_sim("torch", "pipelined", **kw)
    assert _states_equal(run, fresh)
    assert run.history == [] and obs.fleet_ledger.snapshot()["clients"] == []
    if cohort:
        assert run.registry.dirty_rows == 0
    # and it trains as the fresh one
    run.fit(1)
    fresh.fit(1)
    assert run.history[0].fit_losses == fresh.history[0].fit_losses
    assert _states_equal(run, fresh)


@pytest.mark.parametrize("mode", ["pipelined", "chunked"])
def test_an_armed_idle_policy_is_bit_identical(mode):
    base = drill_sim("torch", mode)
    armed = drill_sim("torch", mode, recovery=tres.RecoveryPolicy())
    hb, ha = base.fit(3), armed.fit(3)
    assert [r.fit_losses for r in hb] == [r.fit_losses for r in ha]
    assert _states_equal(base, armed)
    sup = armed._recovery_supervisor
    assert sup is not None and sup._total_attempts == 0 and not sup._engaged


# -- the drill -----------------------------------------------------------------

N_ROUNDS = 10


def _drill(mode, tmp_path):
    """The unsupervised halt and the supervised run, in both packages."""
    halts = {}
    for pkg in PKGS:
        with pytest.raises(_m(pkg, jobs, tobs).TrainingHealthError) as e:
            drill_sim(pkg, mode, obs=drill_obs(pkg), fault=scale_fault(pkg)).fit(N_ROUNDS)
        halts[pkg] = (e.value.round, e.value.check, list(e.value.clients))
    obs = {}

    def make(pkg, init):
        obs[pkg] = drill_obs(pkg, tmp_path / pkg / "obs")
        return drill_sim(pkg, mode, obs=obs[pkg], fault=scale_fault(pkg),
                         ckpt_dir=tmp_path / pkg / "ck", init=init,
                         recovery=_m(pkg, jres, tres).RecoveryPolicy(
                             probation_rounds=3, quarantine_rounds=0))

    sims = dict(zip(PKGS, drill_pair(mode, make)))
    hists = {pkg: sims[pkg].fit(N_ROUNDS) for pkg in PKGS}
    return halts, sims, hists, obs


@pytest.fixture(scope="module", params=["pipelined", "chunked"])
def drill(request, tmp_path_factory):
    return _drill(request.param, tmp_path_factory.mktemp(f"drill_{request.param}"))


def _trail(pkg, d, obs):
    """The recovery events: each attempt's bundle's tail, then the last
    run's JSONL (each attempt's shutdown exports and clears the log)."""
    b = _m(pkg, jbundle, tbundle)
    out, verdicts = [], []
    for path in b.list_bundles(str(d / pkg / "obs")):
        bundle = b.load_bundle(path)
        verdicts.append({k: bundle["verdict"].get(k) for k in ("kind", "round", "check",
                                                               "clients")})
        out.extend(bundle["events"])
    with open(d / pkg / "obs" / "metrics.jsonl") as f:
        out.extend(json.loads(line) for line in f if line.strip())
    return verdicts, [strip_ts(e) for e in out if e.get("event") in ("recovery",
                                                                     "quarantine")]


def test_the_unsupervised_drill_halts_as_jax(drill):
    halts = drill[0]
    assert halts["jax"] == halts["torch"]
    assert halts["torch"][1] == "loss_divergence"


def test_the_supervised_drill_heals_as_jax(drill, tmp_path_factory):
    _, sims, hists, obs = drill
    for pkg in PKGS:
        assert [r.round for r in hists[pkg]] == list(range(1, N_ROUNDS + 1))
    sups = {pkg: sims[pkg]._recovery_supervisor for pkg in PKGS}
    # R8: the reference's ranking names the honest client 3 beside the two
    # faulted ones; the port mirrors it
    assert sorted(sups["torch"]._quarantine) == sorted(sups["jax"]._quarantine) == [1, 2, 3]
    for pkg in PKGS:
        assert sups[pkg]._attempts == {} and not sups[pkg]._engaged
        assert obs[pkg].unhealthy_reason is None
    docs = {pkg: sups[pkg]._ledger_doc() for pkg in PKGS}
    for doc in docs.values():
        doc["last_verdict"].pop("ts")
    assert docs["jax"] == docs["torch"]
    for jr, tr in zip(hists["jax"], hists["torch"]):
        for k, v in jr.fit_losses.items():
            np.testing.assert_allclose(tr.fit_losses[k], v, rtol=TOL, atol=TOL)
        for k, v in jr.eval_losses.items():
            np.testing.assert_allclose(tr.eval_losses[k], v, rtol=TOL, atol=TOL)
    want = convert.flax_to_torch(sims["jax"].global_params)
    for k, v in sims["torch"].global_params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=TOL, atol=TOL)
    snaps = {pkg: obs[pkg].registry.snapshot() for pkg in PKGS}
    for name in ("fl_recovery_attempts_total", "fl_recovery_engaged", "fl_recovery_rung",
                 "fl_recovery_quarantined_clients", "fl_recovery_rollbacks_total",
                 "fl_recovery_probations_passed_total"):
        assert snaps["torch"].get(name) == snaps["jax"].get(name), name
    assert snaps["torch"]["fl_recovery_attempts_total"] == {'{rung="retry"}': 1.0,
                                                           '{rung="quarantine"}': 1.0}


def test_the_drill_trail_equals_jax(drill):
    _, sims, _, obs = drill
    d = {pkg: obs[pkg].output_dir for pkg in PKGS}
    from pathlib import Path

    trails = {pkg: _trail(pkg, Path(d[pkg]).parent.parent, obs[pkg]) for pkg in PKGS}
    verdicts, events_ = trails["torch"]
    assert verdicts == trails["jax"][0] and len(verdicts) == 2
    assert all(v["kind"] == "training_health" for v in verdicts)
    assert events_ == trails["jax"][1]
    engages = [e for e in events_ if e.get("phase") == "engage"]
    assert [e["rung"] for e in engages] == ["retry", "quarantine"]
    assert [e["rollback"]["mode"] for e in engages] == ["checkpoint", "checkpoint"]
    assert any(e.get("phase") == "probation_passed" for e in events_)


# -- cohorts ---------------------------------------------------------------

def test_cohort_supervision_quarantines_registry_ids_as_jax(tmp_path):
    # a client first drawn in round 2 (not round 1): its failure rolls back
    # to round 1's frame, so both packages resume from the same state
    draw = [set(jcm.FixedFractionManager(6, 0.5).sample_indices(
        __import__("jax").random.fold_in(__import__("jax").random.PRNGKey(9), 2000 + r),
        r, 3)[0].tolist()) for r in (1, 2)]
    poisoned = min(draw[1] - draw[0])
    data = drill_data(poison_nan=(poisoned,))
    out = {}

    def make(pkg, init):
        jax_side = pkg == "jax"
        out[pkg] = drill_obs(pkg, watchdog=False)
        return drill_sim(
            pkg, "pipelined", data=data, obs=out[pkg], ckpt_dir=tmp_path / pkg, init=init,
            client_manager=_m(pkg, jcm, tcm).FixedFractionManager(6, 0.5),
            cohort=(JCohort if jax_side else TCohort)(slots=3),
            failure_policy=_m(pkg, JFailurePolicy, TFailurePolicy)(accept_failures=False),
            recovery=_m(pkg, jres, tres).RecoveryPolicy(rungs=("quarantine",),
                                                        quarantine_rounds=0))

    js, ts = drill_pair("pipelined", make)
    hj, ht = js.fit(4), ts.fit(4)
    assert ts._recovery_supervisor.quarantined_ids(1) == [poisoned]
    assert js._recovery_supervisor.quarantined_ids(1) == [poisoned]
    assert [r.round for r in ht] == [r.round for r in hj] == [1, 2, 3, 4]
    for jr, tr in zip(hj, ht):
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   rtol=TOL, atol=TOL)
    tev = [strip_ts(e) for e in events(out["torch"], "recovery")]
    assert tev == [strip_ts(e) for e in events(out["jax"], "recovery")]


def test_the_chunked_cohort_route_refuses_supervision_as_jax():
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError) as e:
            drill_sim(pkg, "chunked", client_manager=_m(pkg, jcm, tcm).FixedFractionManager(
                6, 0.5), cohort=_m(pkg, JCohort, TCohort)(slots=3),
                recovery=_m(pkg, jres, tres).RecoveryPolicy()).fit(1)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[1] == ("execution_mode='chunked' but recovery supervision refreshes the "
                       "quarantine keep-mask against the live registry every round")


# -- R7 --------------------------------------------------------------------------

def test_r7_the_dp_accountant_charges_n_rounds_after_a_rollback():
    """A supervised DP run whose client 2 fails in round 1: the supervisor
    quarantines it and restarts, so 5 rounds were dispatched (round 1 twice,
    each aggregated), yet both packages report the epsilon of 4 rounds. With
    a checkpoint ring the replayed rounds also redraw the abandoned rounds'
    noise (the clients' keys come back from the frame)."""
    n = 4
    eps = {}
    for pkg in PKGS:
        sim = sim_of(pkg, data_of(4, poison=2), mode="pipelined",
                     failure_policy=_m(pkg, JFailurePolicy, TFailurePolicy)(
                         accept_failures=False),
                     recovery=_m(pkg, jres, tres).RecoveryPolicy(rungs=("quarantine",),
                                                                 quarantine_rounds=0))
        server = _m(pkg, JDpServer, TDpServer)(sim, noise_multiplier=0.5, batch_size=8)
        hist, epsilon = server.fit(n)
        sup = sim._recovery_supervisor
        assert len(hist) == n and sup._total_attempts == 1
        assert sup._ledger_doc()["last_verdict"]["round"] == 1  # round 1 ran, then again
        delta = 1.0 / sum(_m(pkg, jservers, tservers).poll_sample_counts(sim))
        assert epsilon == pytest.approx(server.accountant.get_epsilon(n, delta), rel=1e-12)
        assert epsilon < server.accountant.get_epsilon(n + 1, delta)
        eps[pkg] = epsilon
    assert eps["torch"] == pytest.approx(eps["jax"], rel=1e-9)
