"""The flight recorder (``observability/flightrec.py``) and postmortem
bundles (``observability/bundle.py``) against the JAX package:

- the ring keeps the newest ``window`` rounds (entries equal JAX's for the
  same records), a recorder-on run trains bit for bit as a recorder-off one;
- ``trap_sigterm``'s four contracts (SIGTERM becomes a ``SigtermShutdown``
  with exit code 143 and the disposition is restored; a caller's handler is
  never displaced; off the main thread it is a no-op; ``on_signal`` runs
  before the raise) and the lock-free ``last_round_hint``;
- verdicts equal JAX's for the same exceptions over the same ring;
- a bundle dumped by the port loads with JAX's ``load_bundle`` (the ring
  frame's CRC intact) and renders with ``tools/postmortem.py``, and a JAX
  bundle loads with the port's;
- a cohort run's halt names the poisoned client's REGISTRY id;
- ``/healthz`` answers 503 after a halt and 200 again after
  ``mark_healthy``;
- the SIGTERM drill on the CPU: a child SIGTERMed after a save exits 143
  with a ``sigterm`` bundle, and a fresh child resumes bit for bit with the
  frame's fleet ledger adopted."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import contextlib
import importlib.util
import io
import json
import signal
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from fl4health_tpu.checkpointing import state as jstate
from fl4health_tpu.observability import bundle as jbundle
from fl4health_tpu.observability import flightrec as jflight
from fl4health_tpu.observability import health as jhealth
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu_torch import rng as trng
from fl4health_tpu_torch.checkpointing import state as tstate
from fl4health_tpu_torch.observability import bundle as tbundle
from fl4health_tpu_torch.observability import flightrec as tflight
from fl4health_tpu_torch.observability import health as thealth
from fl4health_tpu_torch.server import client_manager as tcm
from fl4health_tpu_torch.server import registry as treg
from fl4health_tpu_torch.server import simulation as tsim
from torch_obs_sims import data_of, obs_of, sim_of

ROOT = Path(__file__).resolve().parent.parent


def _record(rec, ids=False):
    """Five rounds of records (and a checkpoint note after round 4) into a
    recorder of either package."""
    for r in range(1, 6):
        rec.record_round(
            r, {"round": r, "execution_mode": "chunked_scan", "participants": 3},
            fit_loss=1.0 / r, eval_loss=2.0 / r, mask=np.asarray([1.0, 1.0, 0.0, 1.0]),
            telemetry={"train_loss": np.asarray([0.5, r, np.nan, 1.5], np.float32),
                       "nonfinite_loss": np.asarray([0.0, 0.0, 1.0, 0.0], np.float32)},
            registry_ids=np.asarray([7, 11, 2, 5]) if ids else None,
            fault={"dropped": [2], "corrupted": []} if r == 3 else None)
        if r == 4:
            rec.note_checkpoint({"round": 4, "generation": 4, "path": "/ckpt/g4",
                                 "bytes": 1000, "kind": "sync"})
    rec.set_run_facts(execution_mode="chunked_scan", n_rounds=5)
    rec.attach(5, quarantine=np.asarray([0.0, 1.0, 0.0, 0.0]))
    return rec


def _entries_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], dict):
                assert x[k].keys() == y[k].keys()
                for kk in x[k]:
                    np.testing.assert_array_equal(np.asarray(x[k][kk]), np.asarray(y[k][kk]))
            else:
                np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


class TestRing:
    def test_ring_bounds_and_entries_equal_jax(self):
        t, j = _record(tflight.FlightRecorder(window=3)), _record(jflight.FlightRecorder(window=3))
        assert t.rounds == j.rounds == [3, 4, 5]
        _entries_equal(t.entries, j.entries)
        assert t.nbytes() == j.nbytes() > 0
        assert t.checkpoint == j.checkpoint and t.run_facts == j.run_facts
        assert t.last_round() == j.last_round() == 5
        with pytest.raises(ValueError):
            tflight.FlightRecorder(window=0)
        t.clear()
        assert t.rounds == [] and t.last_round_hint is None

    def test_last_round_hint_is_lock_free(self):
        rec = tflight.FlightRecorder(window=2)
        rec.record_round(7, {"round": 7})
        with rec._lock:  # a signal landing mid-record must still read it
            assert rec.last_round_hint == 7

    @pytest.mark.parametrize("mode", ["chunked", "pipelined"])
    def test_recorder_on_is_bit_identical_to_off(self, mode):
        runs = []
        for recorder in (False, True):
            obs = obs_of("torch", flight_recorder=recorder, fleet_ledger=recorder)
            sim = sim_of("torch", data_of(4), dp=False, mode=mode, obs=obs)
            sim.fit(2)
            runs.append((sim, obs))
        (off, _), (on, obs) = runs
        assert [r.fit_losses for r in off.history] == [r.fit_losses for r in on.history]
        for k, v in off.global_params.items():
            assert torch.equal(v, on.global_params[k]), k
        assert obs.flight_recorder.rounds == [1, 2]
        assert obs.registry.snapshot()["fl_flightrec_rounds_total"] == 2.0


class TestSigtermTrap:
    def test_sigterm_becomes_shutdown_and_the_disposition_is_restored(self):
        before = signal.getsignal(signal.SIGTERM)
        with pytest.raises(tflight.SigtermShutdown) as ei:
            with tflight.trap_sigterm() as armed:
                assert armed
                signal.raise_signal(signal.SIGTERM)
        assert ei.value.code == 143 == jflight.SIGTERM_EXIT_CODE
        assert signal.getsignal(signal.SIGTERM) is before

    def test_a_callers_handler_is_never_displaced(self):
        sentinel = lambda *a: None  # noqa: E731
        prev = signal.signal(signal.SIGTERM, sentinel)
        try:
            with tflight.trap_sigterm() as armed:
                assert not armed
            assert signal.getsignal(signal.SIGTERM) is sentinel
        finally:
            signal.signal(signal.SIGTERM, prev)

    def test_off_the_main_thread_it_is_a_no_op(self):
        result = {}

        def worker():
            with tflight.trap_sigterm() as armed:
                result["armed"] = armed

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and result["armed"] is False

    def test_on_signal_runs_before_the_raise(self):
        seen = []
        with pytest.raises(tflight.SigtermShutdown):
            with tflight.trap_sigterm(on_signal=lambda: seen.append(True)):
                signal.raise_signal(signal.SIGTERM)
        assert seen == [True]


class _QuorumReport:
    def __init__(self):
        self.results = [type("R", (), dict(silo="silo:0", ok=True, reason=None, attempts=1,
                                           elapsed_s=0.25))(),
                        type("R", (), dict(silo="silo:1", ok=False, reason="timeout",
                                           attempts=3, elapsed_s=2.0))()]


class QuorumError(RuntimeError):
    """Duck-typed as the verdict reads it (the transport is not ported)."""

    def __init__(self):
        super().__init__("quorum lost: 1 of 2 silos replied, 2 required")
        self.required, self.succeeded = 2, 1
        self.failures = [("silo:1", "timeout")]
        self.report = _QuorumReport()


def _exceptions(pkg):
    health, flight, state, sim = ((jhealth, jflight, jstate, jsim) if pkg == "jax"
                                  else (thealth, tflight, tstate, tsim))
    cf = sim.ClientFailuresError("clients [1] failed", clients=[1])
    cf.round = 4
    cohort_cf = sim.ClientFailuresError("clients [0, 3] failed", clients=[0, 3])
    cohort_cf.round, cohort_cf.registry_clients = 5, [7, 5]
    return {
        "sigterm": flight.SigtermShutdown(),
        "training_health": health.TrainingHealthError(
            "halted", round=5, clients=[1, 3], check="nonfinite"),
        "client_failures": cf,
        "cohort_client_failures": cohort_cf,
        "quorum": QuorumError(),
        "checkpoint_corrupt": state.CheckpointCorruptError("/ckpt/g4", "crc mismatch"),
        "exception": ValueError("boom"),
    }


@pytest.mark.parametrize("case", list(_exceptions("torch")))
@pytest.mark.parametrize("ids", [False, True], ids=["dense", "cohort"])
def test_verdicts_equal_jax(case, ids):
    got = tbundle.verdict_from_exception(
        _exceptions("torch")[case], recorder=_record(tflight.FlightRecorder(), ids))
    want = jbundle.verdict_from_exception(
        _exceptions("jax")[case], recorder=_record(jflight.FlightRecorder(), ids))
    got.pop("ts"), want.pop("ts")
    assert got == want
    assert got["kind"] == case.replace("cohort_", "")


def _postmortem(bundle_dir, capsys):
    spec = importlib.util.spec_from_file_location("postmortem_tool",
                                                  ROOT / "tools" / "postmortem.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    capsys.readouterr()
    assert tool.main([bundle_dir, "--json"]) == 0
    return json.loads(capsys.readouterr().out)


def _dump(pkg, out_dir):
    bundle, flight, health = ((jbundle, jflight, jhealth) if pkg == "jax"
                              else (tbundle, tflight, thealth))
    rec = _record(flight.FlightRecorder(), ids=True)
    verdict = bundle.verdict_from_exception(
        health.TrainingHealthError("halted", round=5, clients=[1], check="nonfinite"),
        recorder=rec)
    fleet = {"version": 1, "clients": {}}
    return bundle.dump_bundle(str(out_dir), verdict, recorder=rec,
                              manifest={"execution_mode": "chunked_scan"}, fleet=fleet,
                              timestamp=1.7e9)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_bundles_cross_load_and_render(tmp_path, capsys, writer):
    path = _dump(writer, tmp_path / writer)
    loaders = {"torch": tbundle.load_bundle, "jax": jbundle.load_bundle}
    got, want = (loaders[p](path) for p in ("jax", "torch"))
    for b in (got, want):
        assert b["verdict"]["kind"] == "training_health"
        assert b["verdict"]["clients"] == [11] and b["verdict"]["slot_clients"] == [1]
        assert b["ring_header"]["rounds"] == [1, 2, 3, 4, 5]
        assert b["ring_meta"]["kind"] == "flightrec"
    _entries_equal(got["ring"], want["ring"])
    assert got["fleet"] == want["fleet"] and got["manifest"] == want["manifest"]
    assert tbundle.list_bundles(str(tmp_path / writer)) == [path]
    report = _postmortem(path, capsys)
    assert report["verdict"]["clients"] == [11]
    # a flipped byte in the ring frame is detected, in either reader
    ring = Path(path) / tbundle.RING_FRAME
    data = bytearray(ring.read_bytes())
    data[len(data) // 2] ^= 0xFF
    ring.write_bytes(bytes(data))
    with pytest.raises(tstate.CheckpointCorruptError):
        tbundle.load_bundle(path)


def test_sigterm_drill_exits_143_with_a_bundle_and_resumes(tmp_path):
    """The graceful-preemption drill on the CPU: a child SIGTERMed right
    after round 2's frame publishes exits 143 with a ``sigterm`` bundle
    naming round 2; a fresh child resumes from round 3, adopts the frame's
    fleet ledger (no client is new in round 3) and ends where an
    uninterrupted run ends, bit for bit."""
    from fl4health_tpu_torch.resilience.recovery import run_child

    def spec(tag, kill=None):
        return ({"factory_file": str(ROOT / "tests" / "torch_recovery_factories.py"),
                 "factory_name": "sync_chunked_observed", "n_rounds": 4,
                 "ckpt_dir": str(tmp_path / "ckpt"), "out_dir": str(tmp_path / tag),
                 "kill": kill, "device": "cpu"}, str(tmp_path / f"{tag}.json"))

    killed = run_child(*spec("killed", {"round": 2, "signal_name": "SIGTERM"}))
    assert killed.returncode == 143, killed.stderr[-2000:]
    (path,) = tbundle.list_bundles(str(tmp_path / "obs"))
    b = tbundle.load_bundle(path)
    assert b["verdict"]["kind"] == "sigterm" and b["verdict"]["round"] == 2
    assert b["verdict"]["resume"]["round"] == 2 and b["ring_header"]["rounds"][0] == 1
    assert jbundle.load_bundle(path)["verdict"] == b["verdict"]
    resumed = run_child(*spec("resumed"))
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert resumed.done["resume"]["next_round"] == 3
    assert [row["round"] for row in resumed.history] == [1, 2, 3, 4]
    with open(tmp_path / "obs" / "metrics.jsonl") as f:
        rounds = [json.loads(line) for line in f if '"event": "round"' in line]
    assert [(e["round"], e["participants_new"]) for e in rounds] == [(3, 0), (4, 0)]
    from fl4health_tpu_torch.checkpointing import serialization
    from fl4health_tpu_torch.checkpointing.checkpointer import nest_params

    threads = torch.get_num_threads()
    try:
        # the children's factory computes on one thread (set at its import)
        import torch_recovery_factories as factories

        straight = factories.sync_chunked_every1(None)
        straight.fit(4)
    finally:
        torch.set_num_threads(threads)
    assert serialization.to_bytes(nest_params(straight.global_params)) == resumed.params_bytes


def _scrape(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_cohort_halt_names_the_registry_id_and_healthz_goes_503(tmp_path, capsys):
    n, k = 6, 3
    idx, _ = tcm.FixedFractionManager(n, k / n).sample_indices(
        trng.fold_in(trng.PRNGKey(5), 2001), 1, k)
    poisoned = int(np.asarray(idx)[-1])  # a client round 1 samples, not in slot 0
    obs = obs_of("torch", output_dir=str(tmp_path / "obs"), http_port=0,
                 watchdog=thealth.HealthWatchdog(thealth.HealthPolicy()))
    try:
        assert _scrape(obs.scrape_url + "/healthz") == (200, "ok\n")
        sim = sim_of("torch", data_of(n, poison=poisoned), dp=False, obs=obs,
                     cohort=treg.CohortConfig(slots=k),
                     client_manager=tcm.FixedFractionManager(n, k / n))
        with pytest.raises(thealth.TrainingHealthError) as ei:
            sim.fit(2)
        assert ei.value.round == 1 and ei.value.clients == [k - 1]
        (path,) = tbundle.list_bundles(str(tmp_path / "obs"))
        b = jbundle.load_bundle(path)
        assert b["verdict"]["kind"] == "training_health"
        assert b["verdict"]["clients"] == [poisoned] and b["verdict"]["slot_clients"] == [k - 1]
        np.testing.assert_array_equal(b["ring"][0]["registry_ids"], np.asarray(idx))
        assert _postmortem(path, capsys)["verdict"]["clients"] == [poisoned]
        # the run's shutdown closed the endpoint: re-arm it with the verdict
        # as a live orchestrator saw it, then recover through mark_healthy
        was = obs.unhealthy_reason
        assert was is not None and "nonfinite" in was
        obs.start()
        obs.mark_unhealthy(was)
        code, body = _scrape(obs.scrape_url + "/healthz")
        assert code == 503 and body.startswith("unhealthy:") and "nonfinite" in body
        assert _scrape(obs.scrape_url + "/metrics")[0] == 200
        obs.mark_healthy()
        assert _scrape(obs.scrape_url + "/healthz") == (200, "ok\n")
    finally:
        with contextlib.redirect_stderr(io.StringIO()):
            obs.shutdown()
