"""The observability records of a run against the JAX package's, on the
tiny DP recipe of ``tests/torch_obs_sims.py``:

- the same JSONL event names, the same ``round`` event keys (values at
  5e-4, counts exact; timestamps, walls and compile counts excluded, and
  the counted ``program_flops_round``/``tflops_measured`` compared by key:
  the port counts every local step, XLA one scan body, ROADMAP.md C R9),
  the same ``execution_mode`` event and manifest config hash, and the same
  ``program`` and ``stage`` event keys with introspection on in both;
- the same Prometheus metric names, ``fl_program_*`` and ``fl_stage_*``
  included, less the compile events the port has no counterpart of (it
  counts extension builds under ``jax_backend_compiles_*``);
- ``tools/perf_report.py`` renders the port's ``metrics.jsonl``;
- the route reasons for ``profile_round_idx`` and ``per_round_spans``
  equal JAX's word for word;
- a disabled handle adds no device sync and writes no artifact; an
  enabled one arms the operations plane from its arguments and runs the
  introspection."""

import torch_threads  # noqa: F401  (first: one torch thread a test process)
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from fl4health_tpu_torch import observability as tobservability
from fl4health_tpu_torch.observability import cudamon
from fl4health_tpu_torch.server import simulation as tsim
from torch_obs_sims import TOL, data_of, jax_init, obs_of, sim_of

ROOT = Path(__file__).resolve().parent.parent
# JAX's compile events without a port counterpart
JAX_ONLY = ("jax_jaxpr_traces", "jax_mlir_lowerings", "jax_persistent_cache",
            "jax_cache_compile_requests")
# host walls and compile counts: measured, not computed
UNTIMED = {"ts", "compiles", "compile_s", "device_wait_s", "fit_s", "eval_s", "host_s",
           "program_exec_s"}
# counted work: XLA counts a scan body once, the port every step (R9)
BY_KEY = {"program_flops_round", "tflops_measured"}


def _runs(tmp_path, mode="chunked"):
    out = {}
    for pkg in ("jax", "torch"):
        obs = obs_of(pkg, output_dir=str(tmp_path / pkg), introspection=True)
        sim = sim_of(pkg, data_of(4), mode=mode, obs=obs)
        if pkg == "jax":
            init = jax_init(sim)
        else:
            sim.set_global_params(init)
        sim.fit(2)
        with open(tmp_path / pkg / "metrics.jsonl") as f:
            evs = [json.loads(line) for line in f]
        with open(tmp_path / pkg / "metrics.prom") as f:
            prom = f.read()
        out[pkg] = (evs, prom, obs.manifest)
    return out


def _metric_names(prom: str) -> set[str]:
    return {line.split()[2] for line in prom.splitlines() if line.startswith("# TYPE ")}


@pytest.mark.parametrize("mode", ["chunked", "pipelined"])
def test_records_equal_jax(tmp_path, mode):
    runs = _runs(tmp_path, mode)
    (tev, tprom, tman), (jev, jprom, jman) = runs["torch"], runs["jax"]
    assert {e["event"] for e in tev} == {e["event"] for e in jev}
    trounds, jrounds = ([e for e in evs if e["event"] == "round"] for evs in (tev, jev))
    assert len(trounds) == len(jrounds) == 2
    for t, j in zip(trounds, jrounds):
        assert t.keys() == j.keys() and BY_KEY <= t.keys()
        for k in t.keys() - UNTIMED - BY_KEY:
            if isinstance(j[k], float):
                np.testing.assert_allclose(t[k], j[k], rtol=TOL, atol=1e-6, err_msg=k)
            else:
                assert t[k] == j[k], k
    pick = lambda evs: [{k: e[k] for k in ("mode", "reason")}  # noqa: E731
                        for e in evs if e["event"] == "execution_mode"]
    assert pick(tev) == pick(jev)
    programs = lambda evs: {e["name"]: set(e) for e in evs  # noqa: E731
                            if e["event"] == "program"}
    assert programs(tev) == programs(jev)
    stage_keys = lambda evs: {frozenset(e) for e in evs if e["event"] == "stage"}  # noqa: E731
    assert stage_keys(tev) == stage_keys(jev)
    assert tman["config_hash"] == jman["config_hash"]
    assert tman["config"] == jman["config"]
    tnames, jnames = _metric_names(tprom), _metric_names(jprom)
    assert tnames <= jnames
    assert all(n.startswith(JAX_ONLY) for n in jnames - tnames), jnames - tnames
    assert "fl_rounds_total" in tnames and "fl_flightrec_ring_bytes" in tnames


def test_perf_report_renders_the_ports_log(tmp_path, capsys):
    obs = obs_of("torch", output_dir=str(tmp_path))
    sim_of("torch", data_of(4), obs=obs).fit(2)
    spec = importlib.util.spec_from_file_location("perf_report_tool",
                                                  ROOT / "tools" / "perf_report.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    capsys.readouterr()
    assert tool.main([str(tmp_path / "metrics.jsonl"), "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert len(report["rounds"]) == 2


def _forced(sim):
    """The forced chunked route's answer: the mode, or the refusal's words."""
    try:
        return sim._select_execution_mode(2)
    except ValueError as e:
        return str(e)


def test_route_reasons_equal_jax(tmp_path):
    cases = {"profile": dict(profile_round_idx=1, output_dir=str(tmp_path)),
             "spans": dict(per_round_spans=True),
             "profile_without_output_dir": dict(profile_round_idx=1)}
    for name, kw in cases.items():
        got = {}
        for pkg in ("jax", "torch"):
            sims = [sim_of(pkg, data_of(2), mode=mode, obs=obs_of(pkg, **kw))
                    for mode in ("auto", "chunked")]
            got[pkg] = (sims[0]._select_execution_mode(2), _forced(sims[1]))
            for sim in sims:
                sim.observability.shutdown()
        assert got["torch"] == got["jax"], name
        assert got["torch"][0][0] == (tsim.EXEC_CHUNKED if name == "profile_without_output_dir"
                                      else tsim.EXEC_PIPELINED)


def test_disabled_handle_adds_no_sync_and_writes_nothing(tmp_path, monkeypatch):
    def no_sync():
        raise AssertionError("a disabled handle synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    obs = tobservability.Observability(enabled=False, output_dir=str(tmp_path / "off"),
                                       registry=tobservability.MetricsRegistry(),
                                       tracer=tobservability.Tracer())
    for mode in ("chunked", "pipelined"):
        sim = sim_of("torch", data_of(2), mode=mode, obs=obs)
        sim.fit(1)
        assert "clip_fraction" not in sim.history[0].fit_losses
    assert not (tmp_path / "off").exists()
    assert obs.registry.events == [] and obs.fence({"x": torch.ones(2)})[1] == 0.0
    # enabled, a CPU tree has nothing to wait for
    assert cudamon.synced({"x": torch.ones(2)}, enabled=True)[1] == 0.0


def test_operations_plane_arms_and_introspection_runs():
    obs = tobservability.Observability(
        enabled=True, tracer=tobservability.Tracer(),
        registry=tobservability.MetricsRegistry(),
        slo=tobservability.SLOPolicy(max_eval_loss=1e9), admin_token="secret")
    assert obs.slo is not None and obs.admin is not None and obs.timeseries is not None
    assert obs.introspection_enabled
    sim = sim_of("torch", data_of(2), mode="chunked", obs=obs)
    sim.fit(1)
    assert set(obs.introspector.reports) == {"fit_chunk_eval"}
    assert "fl_slo_burn_rate" in obs.registry.to_prometheus()
    assert "program_flops_round" in [e for e in obs.registry.events
                                     if e["event"] == "round"][0]
    off = tobservability.Observability(enabled=False, slo=tobservability.SLOPolicy(),
                                       admin_token="secret")
    assert not off.introspection_enabled and off.observe_round_kpis(1, {}) is None


def test_compile_monitor_counts_extension_builds():
    reg = tobservability.MetricsRegistry()
    with cudamon.CompileMonitor(reg):
        cudamon.note_build("dp_clip", 2.5)
    cudamon.note_build("dp_clip", 9.0)  # uninstalled: not counted
    snap = reg.snapshot()
    assert snap["jax_backend_compiles_total"] == 1.0
    assert snap["jax_backend_compiles_seconds_total"] == 2.5


def test_profile_dir_writes_a_torch_profiler_trace(tmp_path):
    sim = sim_of("torch", data_of(2), dp=False, profile_dir=str(tmp_path / "prof"))
    sim.fit(1)
    (trace,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / trace) as f:
        assert "traceEvents" in json.load(f)
