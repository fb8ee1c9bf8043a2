"""The operations plane (``observability/timeseries.py``, ``slo.py``,
``adminplane.py`` and the admin routes of ``exposition.py``) in the port,
against the JAX package:

- one sequence of round summaries fed to both packages' ``RoundTimeSeries``
  and ``SLOEngine`` gives the same KPIs, verdicts, ``slo`` events and
  ``fl_slo_*`` lines; the admin plane's validation, rejections, journal and
  descriptor are JAX's;
- the status, ``Allow`` header and body of every ``/healthz`` and
  ``/admin/*`` request equal JAX's server's; the admin routes are absent
  while the plane is unarmed;
- an armed plane leaves parameters and histories bit-equal to an unarmed
  one (pipelined and forced chunked), and demotes the auto route with
  JAX's reason word for word;
- the live-retune drill (JAX's ``tests/observability/test_ops_plane.py``):
  a ``POST /admin/scalars`` at round 3 of 6 on ``fed_adam(0.1)`` applies at
  that round's boundary, is journaled, replays bit for bit through
  ``schedule()``, diverges from the control, and trains as JAX's retuned
  run (5e-4); an SLO breach reads ``degraded: eval_loss`` on ``/healthz``;
  the supervisor's recovery events feed the MTTR KPI."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fl4health_tpu import observability as jobs
from fl4health_tpu.resilience.aggregators import RobustFedAvg as JRobust
from fl4health_tpu.server import simulation as jsim
from fl4health_tpu.strategies import fedopt as jfedopt
from fl4health_tpu.strategies.fedavg import FedAvg as JFedAvg
from fl4health_tpu_torch import observability as tobs
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.resilience.aggregators import RobustFedAvg as TRobust
from fl4health_tpu_torch.server import simulation as tsim
from fl4health_tpu_torch.strategies import fedopt as tfedopt
from fl4health_tpu_torch.strategies.fedavg import FedAvg as TFedAvg
from torch_obs_sims import jax_init
from torch_resilience_sims import TOL, drill_sim

PKG = {"jax": (jobs, jsim, jfedopt, JFedAvg, JRobust),
       "torch": (tobs, tsim, tfedopt, TFedAvg, TRobust)}


def _obs(pkg: str, **kw):
    m = PKG[pkg][0]
    return m.Observability(enabled=True, tracer=m.Tracer(), registry=m.MetricsRegistry(),
                           sync_device=False, flight_recorder=False, introspection=False,
                           **kw)


# ---------------------------------------------------------------------------
# Pure-Python parts against JAX's
# ---------------------------------------------------------------------------

def _summaries():
    """Eight rounds: a slowing cadence, a stalling then breaching eval loss,
    wire bytes, a fleet straggler tail."""
    out = []
    for r in range(1, 9):
        out.append(({"round": r, "fit_s": 0.5 + 0.1 * r, "eval_s": 0.05,
                     "participants": 4, "broadcast_bytes": 1000.0 * r,
                     "gather_bytes": 800.0, "gather_bytes_wire": 200.0 if r > 4 else None,
                     "fleet": {"straggler_p99": 1.0 + r}},
                    1.0 / r, 0.9 if r < 4 else 0.9 + 0.1 * r, 100.0 + 30.0 * r))
    return out


POLICIES = {
    "all": dict(min_rounds_per_hour=200.0, max_eval_loss=1.0, stall_rounds=2,
                stall_min_delta=0.01, max_bytes_per_client=1500.0, max_mttr_s=5.0,
                max_straggler_p99=6.0, error_budget=0.25, short_window=2, long_window=4),
    "eval_only": dict(max_eval_loss=1.2, short_window=1, long_window=3),
}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_timeseries_and_slo_verdicts_equal_jax(policy):
    outs = {}
    for pkg in ("jax", "torch"):
        m = PKG[pkg][0]
        reg = m.MetricsRegistry()
        clock = iter(float(t) for t in range(1000, 2000, 7))
        ts = m.RoundTimeSeries(window=4, clock=lambda: next(clock))
        engine = m.SLOEngine(m.SLOPolicy(**POLICIES[policy]), reg)
        verdicts = []
        for summary, fit_loss, eval_loss, t in _summaries():
            if summary["round"] == 3:
                ts.note_recovery("engage", ts=t - 20.0)
            if summary["round"] == 5:
                ts.note_recovery("probation_passed", ts=t - 5.0)
            kpis = ts.observe_round(summary, fit_loss=fit_loss, eval_loss=eval_loss, ts=t)
            verdicts.append((kpis, engine.evaluate(summary["round"], kpis)))
        slo_lines = [ln for ln in reg.to_prometheus().splitlines() if "fl_slo" in ln]
        events = [{k: v for k, v in e.items() if k != "ts"} for e in reg.events]
        outs[pkg] = (verdicts, engine.standing(), slo_lines, events, ts.kpis(), ts.nbytes)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][3]  # transitions were logged


def _bound_plane(pkg: str, strategy_name: str, mode_name: str):
    m, sim_mod, fedopt, fedavg, robust = PKG[pkg]
    plane = m.AdminPlane("s3cr3t", m.MetricsRegistry(), clock=lambda: 7.0)
    strategies = {"fed_adam": lambda: fedopt.fed_adam(0.1), "fedavg": fedavg,
                  "robust": lambda: robust(trim_fraction=0.1)}
    if strategy_name is not None:
        mode = getattr(sim_mod, mode_name)
        plane.bind_run(strategies[strategy_name](), mode)
    return plane


def _rejection(plane, scalars):
    try:
        return ("ok", plane.submit(scalars))
    except Exception as e:  # both packages' AdminRejection
        return (type(e).__name__, getattr(e, "status", None), getattr(e, "error", None),
                str(e))


@pytest.mark.parametrize("strategy,mode,scalars", [
    (None, None, {"server_lr": 0.1}),
    ("fed_adam", "EXEC_PIPELINED", {}),
    ("fed_adam", "EXEC_PIPELINED", [1, 2]),
    ("fed_adam", "EXEC_PIPELINED", {"nope": 1.0}),
    ("fed_adam", "EXEC_PIPELINED", {"server_lr": "abc"}),
    ("fed_adam", "EXEC_PIPELINED", {"server_lr": -1.0}),
    ("fed_adam", "EXEC_PIPELINED", {"server_lr": 0.2, "nope": 1.0}),
    ("fed_adam", "EXEC_PIPELINED", {"server_lr": 0.02}),
    ("fedavg", "EXEC_PIPELINED", {"server_lr": 0.1}),
    ("fed_adam", "EXEC_CHUNKED", {"server_lr": 0.1}),
    ("robust", "EXEC_PIPELINED", {"trim_fraction": 0.2}),
])
def test_admin_plane_answers_as_jax(strategy, mode, scalars):
    got = {pkg: _rejection(_bound_plane(pkg, strategy, mode), scalars)
           for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"]


def test_admin_journal_and_descriptor_equal_jax():
    out = {}
    for pkg in ("jax", "torch"):
        plane = _bound_plane(pkg, "fed_adam", "EXEC_PIPELINED")
        plane.schedule(2, {"server_lr": 0.05})
        plane.submit({"server_lr": 0.03})
        due = [plane.drain(r) for r in (1, 2, 3)]
        plane.note_applied(1, due[0])
        plane.note_applied(2, due[1], source="schedule")
        with pytest.raises(ValueError, match="shared secret"):
            PKG[pkg][0].AdminPlane("")
        out[pkg] = (due, plane.journal(), plane.descriptor(),
                    [{k: v for k, v in e.items() if k != "ts"} for e in plane._registry.events])
    assert out["torch"] == out["jax"]


def test_unarmed_handle_builds_no_plane_and_recovery_feeds_mttr():
    obs = _obs("torch")
    assert obs.slo is None and obs.admin is None and obs.timeseries is None
    assert obs.observe_round_kpis(1, {"fit_s": 1.0}) is None
    obs.shutdown()
    obs = _obs("torch", slo=tobs.SLOPolicy(max_mttr_s=1e9))
    rec = obs.log_event("recovery", phase="engage")
    obs.log_event("recovery", phase="probation_passed")
    assert obs.timeseries.recoveries == 1 and rec["event"] == "recovery"
    assert obs.timeseries.kpis()["mttr_s"] >= 0.0
    obs.shutdown()


# ---------------------------------------------------------------------------
# The endpoint against JAX's
# ---------------------------------------------------------------------------

def _request(url: str, method: str = "GET", body=None, token=None):
    """(status, Allow header, content type, body) without raising."""
    headers = {}
    if token is not None:
        headers["X-Admin-Token"] = token
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(url, data=data, headers=headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return (resp.status, resp.headers.get("Allow"),
                    resp.headers.get("Content-Type"), resp.read())
    except urllib.error.HTTPError as err:
        return (err.code, err.headers.get("Allow"), err.headers.get("Content-Type"),
                err.read())


def _served(pkg: str, armed: bool = True):
    kw = dict(slo=PKG[pkg][0].SLOPolicy(max_eval_loss=1.0), admin_token="s3cr3t") if armed \
        else {}
    return _obs(pkg, http_port=0, **kw)


_SCRIPT = [
    ("GET", "/healthz", None, None), ("HEAD", "/healthz", None, None),
    ("GET", "/admin/slo", None, None), ("HEAD", "/admin/slo", None, None),
    ("HEAD", "/metrics", None, None), ("POST", "/metrics", {}, None),
    ("GET", "/admin/scalars", None, None), ("HEAD", "/admin/scalars", None, None),
    ("DELETE", "/metrics", None, None), ("PUT", "/admin/scalars", None, None),
    ("GET", "/nope", None, None), ("POST", "/nope", {}, None),
    ("POST", "/admin/scalars", {"server_lr": 0.1}, None),
    ("POST", "/admin/scalars", {"server_lr": 0.1}, "wrong"),
    ("POST", "/admin/scalars", b"not json{", "s3cr3t"),
    ("POST", "/admin/scalars", {"server_lr": 0.1}, "s3cr3t"),  # no run bound: 409
    ("bind", "fed_adam", "EXEC_PIPELINED", None),
    ("POST", "/admin/scalars", {"nope": 1.0}, "s3cr3t"),
    ("POST", "/admin/scalars", {"server_lr": 0.05}, "s3cr3t"),
    ("bind", "fedavg", "EXEC_PIPELINED", None),
    ("POST", "/admin/scalars", {"server_lr": 0.1}, "s3cr3t"),
    ("bind", "robust", "EXEC_PIPELINED", None),
    ("POST", "/admin/scalars", {"trim_fraction": 0.2}, "s3cr3t"),
    ("bind", "fed_adam", "EXEC_CHUNKED", None),
    ("POST", "/admin/scalars", {"server_lr": 0.1}, "s3cr3t"),
    ("degrade", "eval_loss", None, None), ("GET", "/healthz", None, None),
    ("unhealthy", "watchdog: loss diverged", None, None), ("GET", "/healthz", None, None),
    ("heal", None, None, None), ("GET", "/healthz", None, None),
]


def _play(pkg: str, armed: bool) -> list:
    obs = _served(pkg, armed)
    m, sim_mod, fedopt, fedavg, robust = PKG[pkg]
    strategies = {"fed_adam": lambda: fedopt.fed_adam(0.1), "fedavg": fedavg,
                  "robust": lambda: robust(trim_fraction=0.1)}
    out = []
    try:
        for verb, a, b, token in _SCRIPT:
            if verb == "bind":
                if obs.admin is not None:
                    obs.admin.bind_run(strategies[a](), getattr(sim_mod, b))
            elif verb == "degrade":
                obs.mark_degraded(a)
            elif verb == "unhealthy":
                obs.mark_unhealthy(a)
            elif verb == "heal":
                obs.mark_healthy()
                obs.clear_degraded()
            else:
                out.append((verb, a, _request(obs.scrape_url + a, verb, b, token)))
    finally:
        obs.shutdown()
    return out


@pytest.mark.parametrize("armed", [True, False], ids=["armed", "unarmed"])
def test_endpoint_answers_as_jax(armed):
    jax_answers, torch_answers = _play("jax", armed), _play("torch", armed)
    assert [a[:2] for a in torch_answers] == [a[:2] for a in jax_answers]
    for (verb, path, t), (_, _, j) in zip(torch_answers, jax_answers):
        assert t[:3] == j[:3], (verb, path)
        if t[2] == "application/json" and j[3]:
            assert json.loads(t[3]) == json.loads(j[3]), (verb, path)
        else:
            assert t[3] == j[3], (verb, path)
    if armed:
        statuses = {(v, p): r[0] for v, p, r in torch_answers}
        assert statuses[("GET", "/admin/scalars")] == 405


# ---------------------------------------------------------------------------
# Runs
# ---------------------------------------------------------------------------

def _params(sim):
    return [t.clone() for t in ptu.tree_leaves(sim.global_params)]


def _losses(sim):
    return [(r.fit_losses, r.eval_losses) for r in sim.history]


@pytest.mark.parametrize("mode", ["pipelined", "chunked"])
def test_armed_plane_leaves_every_bit(mode):
    runs = []
    for armed in (True, False):
        obs = (_obs("torch", slo=tobs.SLOPolicy(max_eval_loss=1e9, stall_rounds=10_000),
                    admin_token="t") if armed else _obs("torch"))
        sim = drill_sim("torch", mode, obs=obs)
        sim.fit(3)
        runs.append((_params(sim), _losses(sim)))
        if armed and mode == "chunked":
            # forced chunked stays legal: the plane answers mid_chunk
            with pytest.raises(tobs.AdminRejection, match="chunked_scan"):
                obs.admin.submit({"server_lr": 0.1})
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert runs[0][1] == runs[1][1]


def test_admin_plane_demotes_auto_with_jax_reason():
    got = {}
    for pkg in ("jax", "torch"):
        armed = drill_sim(pkg, "auto", obs=_obs(pkg, admin_token="t"))
        plain = drill_sim(pkg, "auto", obs=_obs(pkg))
        got[pkg] = (armed._select_execution_mode(3), plain._select_execution_mode(3))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (tsim.EXEC_PIPELINED,
                               "admin retune endpoint armed (live scalar rebinds apply "
                               "at per-round boundaries)")


def test_live_retune_drill():
    token, posted = "drill-token", {}

    def posting_provider(rnd):
        if rnd == 3 and "resp" not in posted:
            posted["resp"] = _request(live_obs.scrape_url + "/admin/scalars", "POST",
                                      {"server_lr": 0.02}, token)
        return None

    def noop(rnd):
        return None

    # JAX's retuned run, its journal replayed through schedule()
    jobs_ = _obs("jax", admin_token=token)
    jobs_.admin.schedule(3, {"server_lr": 0.02})
    js = drill_sim("jax", "pipelined", strategy=jfedopt.fed_adam(0.1), obs=jobs_,
                   train_data_provider=noop)
    init = jax_init(js)
    js.fit(6)

    live_obs = _obs("torch", admin_token=token, http_port=0)
    live = drill_sim("torch", "pipelined", strategy=tfedopt.fed_adam(0.1), obs=live_obs,
                     train_data_provider=posting_provider, init=init)
    live.fit(6)
    status, _, _, body = posted["resp"]
    doc = json.loads(body)
    assert status == 200 and doc["accepted"] == {"server_lr": 0.02}
    assert doc["applies"] == "next_round_boundary"
    admin_events = [e for e in live_obs.registry.events if e["event"] == "admin"]
    assert [(e["round"], e["scalars"]) for e in admin_events] == [(3, {"server_lr": 0.02})]
    assert live_obs.manifest["admin"] == {
        "enabled": True,
        "retunes": [{"round": 3, "scalars": {"server_lr": 0.02}, "source": "live"}]}
    rounds = [e for e in live_obs.registry.events if e["event"] == "round"]
    assert [r["compiles"] for r in rounds] == [0] * 6  # no extension build on this path

    replay_obs = _obs("torch", admin_token=token)
    replay_obs.admin.schedule(3, {"server_lr": 0.02})
    replay = drill_sim("torch", "pipelined", strategy=tfedopt.fed_adam(0.1), obs=replay_obs,
                       train_data_provider=noop, init=init)
    replay.fit(6)
    assert all(torch.equal(a, b) for a, b in zip(_params(live), _params(replay)))
    assert _losses(live) == _losses(replay)

    control = drill_sim("torch", "pipelined", strategy=tfedopt.fed_adam(0.1),
                        obs=_obs("torch"), train_data_provider=noop, init=init)
    control.fit(6)
    assert _losses(control)[:2] == _losses(live)[:2]
    assert _losses(control) != _losses(live)

    for tr, jr in zip(live.history, js.history):
        np.testing.assert_allclose(tr.fit_losses["backward"], jr.fit_losses["backward"],
                                   rtol=TOL, atol=1e-6)
        np.testing.assert_allclose(tr.eval_losses["checkpoint"],
                                   jr.eval_losses["checkpoint"], rtol=TOL, atol=1e-6)


def test_slo_breach_reads_degraded_on_healthz():
    seen = []
    obs = _obs("torch", slo=tobs.SLOPolicy(max_eval_loss=1e-3, short_window=1, long_window=1),
               http_port=0)
    real_observe = obs.observe_round_kpis

    def observe(rnd, summary, **kw):
        verdict = real_observe(rnd, summary, **kw)
        seen.append(_request(obs.scrape_url + "/healthz")[::3])
        return verdict

    obs.observe_round_kpis = observe
    drill_sim("torch", "chunked", obs=obs).fit(2)
    assert seen == [(200, b"degraded: eval_loss\n")] * 2
    slo_events = [e for e in obs.registry.events if e["event"] == "slo"]
    assert [(e["slo"], e["standing"]) for e in slo_events] == [("eval_loss", "breach")]
