"""Observability (counterpart of ``fl4health_tpu/observability``): round-level
tracing, metrics, in-graph telemetry, the health watchdog, the flight
recorder, the fleet ledger and postmortem bundles.

- :mod:`~fl4health_tpu_torch.observability.spans` — nested spans on
  monotonic clocks, exported as Chrome trace-event JSON;
- :mod:`~fl4health_tpu_torch.observability.registry` — counters, gauges
  and histograms with Prometheus text and a JSONL event log
  (``tools/perf_report.py`` renders it);
- :mod:`~fl4health_tpu_torch.observability.cudamon` — the CUDA hooks:
  extension-build counting under JAX's compile-counter names, honest
  device-time fencing (``torch.cuda.synchronize`` only when enabled),
  opt-in ``torch.profiler`` capture of one round;
- :mod:`~fl4health_tpu_torch.observability.telemetry` — the
  ``RoundTelemetry`` tree of per-client training-health statistics that
  the round programs return beside their results;
- :mod:`~fl4health_tpu_torch.observability.health` — the
  ``HealthWatchdog`` over that telemetry, able to halt ``fit()`` with a
  ``TrainingHealthError``;
- :mod:`~fl4health_tpu_torch.observability.flightrec`,
  :mod:`~fl4health_tpu_torch.observability.bundle`,
  :mod:`~fl4health_tpu_torch.observability.fleet` — the black box of the
  last rounds, the postmortem bundle it publishes on an abnormal end, and
  per-client lifetime records;
- :mod:`~fl4health_tpu_torch.observability.introspect`,
  :mod:`~fl4health_tpu_torch.observability.hloscan`,
  :mod:`~fl4health_tpu_torch.observability.stages` — round-program
  introspection: each round function run once on fake tensors under an op
  counter (flops, bytes, footprint, per-stage rows), feeding measured MFU
  and the HBM-headroom gauge;
- :mod:`~fl4health_tpu_torch.observability.timeseries`,
  :mod:`~fl4health_tpu_torch.observability.slo`,
  :mod:`~fl4health_tpu_torch.observability.adminplane` — the operations
  plane: serving KPIs over a bounded window, declarative SLOs with
  burn-rate standing, and live retunes of the hoisted scalars;
- :mod:`~fl4health_tpu_torch.observability.exposition` /
  :mod:`~fl4health_tpu_torch.observability.manifest` — the HTTP pull
  endpoint (``/metrics``, ``/manifest``, ``/healthz``, ``/fleet``,
  ``/clients/<id>``, and ``/admin/slo``, ``/admin/scalars`` while the
  operations plane is armed) and the run manifest;
- :mod:`~fl4health_tpu_torch.observability.device_specs` — published
  device peaks;
- :mod:`~fl4health_tpu_torch.observability.tracectx` — the cross-silo
  trace context that rides in a wire frame's header, and the flow ids that
  join the coordinator's and the silos' traces.

:class:`Observability` is the facade ``FederatedSimulation`` accepts, with
JAX's constructor. Disabled, every hook is a shared no-op: no device sync,
no allocation on the round's path.
"""

from __future__ import annotations

import json
import os
from typing import Any

from fl4health_tpu_torch.core.io import atomic_write
from fl4health_tpu_torch.observability.adminplane import AdminPlane, AdminRejection
from fl4health_tpu_torch.observability.cudamon import CompileMonitor, profile_round, synced
from fl4health_tpu_torch.observability.exposition import ScrapeServer
from fl4health_tpu_torch.observability.fleet import FleetLedger
from fl4health_tpu_torch.observability.flightrec import (DEFAULT_WINDOW, FlightRecorder,
                                                         SigtermShutdown, trap_sigterm)
from fl4health_tpu_torch.observability.health import (HealthPolicy, HealthWatchdog,
                                                      TrainingHealthError)
from fl4health_tpu_torch.observability.introspect import ProgramIntrospector, ProgramReport
from fl4health_tpu_torch.observability.manifest import config_hash, run_manifest
from fl4health_tpu_torch.observability.registry import (Counter, Gauge, Histogram,
                                                        MetricsRegistry, get_registry,
                                                        set_registry)
from fl4health_tpu_torch.observability.slo import SLOEngine, SLOPolicy
from fl4health_tpu_torch.observability.spans import (_NULL_SPAN, Span, Tracer, get_tracer,
                                                     set_tracer)
from fl4health_tpu_torch.observability.timeseries import RoundTimeSeries
from fl4health_tpu_torch.observability.tracectx import TraceContext, flow_id, traced_handler

__all__ = [
    "Observability",
    "AdminPlane",
    "AdminRejection",
    "SLOPolicy",
    "SLOEngine",
    "RoundTimeSeries",
    "FleetLedger",
    "FlightRecorder",
    "SigtermShutdown",
    "trap_sigterm",
    "Tracer",
    "Span",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "CompileMonitor",
    "HealthPolicy",
    "HealthWatchdog",
    "TrainingHealthError",
    "ProgramIntrospector",
    "ProgramReport",
    "ScrapeServer",
    "run_manifest",
    "config_hash",
    "get_tracer",
    "set_tracer",
    "get_registry",
    "set_registry",
    "profile_round",
    "synced",
    "TraceContext",
    "flow_id",
    "traced_handler",
]

class Observability:
    """One handle bundling tracer + registry + CUDA hooks for a run (JAX's
    constructor and semantics).

    Defaults bind to the process-wide tracer and registry (the port's own,
    not JAX's); pass private instances for isolation (tests do).

    ``profile_round_idx`` selects ONE round for a ``torch.profiler`` capture
    under ``output_dir/xprof``. ``telemetry`` (default on) makes the round
    programs return the ``RoundTelemetry`` tree beside their results, which
    rides the existing pull and leaves the trajectory bit-identical.
    ``watchdog`` attaches a ``HealthWatchdog``. ``per_round_spans`` forces
    ``fit()`` onto the pipelined route so spans and fences keep per-round
    granularity. ``http_port`` starts the ``ScrapeServer`` for the handle's
    armed lifetime (``0``: an OS-assigned port, read from ``scrape_url``).
    ``flight_recorder`` and ``fleet_ledger`` (default on) keep the ring of
    the last ``flightrec_window`` rounds and the per-client lifetime
    records. ``introspection`` (default on) runs each round program once on
    fake tensors when ``fit()`` starts (``ProgramIntrospector``): the
    ``program`` and ``stage`` records, measured MFU on every round record
    and the HBM-headroom gauge, with no device work.

    The operations plane (both OFF by default): ``slo`` takes an
    ``SLOPolicy`` evaluated each round in the epilogue (``fl_slo_*``
    gauges, ``slo`` events, the ``degraded`` healthz state);
    ``admin_token`` arms the ``AdminPlane`` behind ``POST /admin/scalars``
    (shared-secret header) for live, journaled retunes of the hoisted
    scalars. Either one also arms the ``RoundTimeSeries`` of the last
    ``ops_window`` rounds that computes the serving KPIs.
    """

    def __init__(
        self,
        enabled: bool = True,
        output_dir: str | None = None,
        tracer: Tracer | None = None,
        registry: MetricsRegistry | None = None,
        profile_round_idx: int | None = None,
        sync_device: bool = True,
        telemetry: bool = True,
        per_round_spans: bool = False,
        watchdog: "HealthWatchdog | None" = None,
        introspection: bool = True,
        http_port: int | None = None,
        http_host: str = "127.0.0.1",
        flight_recorder: "bool | FlightRecorder" = True,
        flightrec_window: int | None = None,
        fleet_ledger: "bool | FleetLedger" = True,
        slo: Any = None,
        admin_token: str | None = None,
        ops_window: int = 256,
    ):
        self.enabled = enabled
        self.output_dir = output_dir
        self.tracer = tracer if tracer is not None else get_tracer()
        self.registry = registry if registry is not None else get_registry()
        self.profile_round_idx = profile_round_idx
        self.sync_device = sync_device
        self.telemetry = telemetry
        self.per_round_spans = per_round_spans
        self.watchdog = watchdog
        self.introspection = introspection
        self.http_port = http_port
        self.http_host = http_host
        self.ops_window = ops_window
        if isinstance(flight_recorder, FlightRecorder):
            self.flight_recorder: FlightRecorder | None = flight_recorder
        elif flight_recorder:
            self.flight_recorder = FlightRecorder(window=flightrec_window or DEFAULT_WINDOW)
        else:
            self.flight_recorder = None
        if isinstance(fleet_ledger, FleetLedger):
            self.fleet_ledger: FleetLedger | None = fleet_ledger
        elif fleet_ledger:
            self.fleet_ledger = FleetLedger()
        else:
            self.fleet_ledger = None
        # the operations plane: host-side only, fed from epilogue summaries
        # the run already pulled, so arming it adds no device sync
        self.slo: SLOEngine | None = SLOEngine(slo, self.registry) if slo is not None else None
        self.admin: AdminPlane | None = (AdminPlane(admin_token, self.registry)
                                         if admin_token is not None else None)
        self.timeseries: RoundTimeSeries | None = (
            RoundTimeSeries(window=ops_window)
            if (self.slo is not None or self.admin is not None) else None)
        self._unhealthy: str | None = None
        self._degraded: str | None = None
        self.introspector = ProgramIntrospector(self.registry)
        self._manifest: dict[str, Any] = {}
        self._scrape_server: ScrapeServer | None = None
        self.compile_monitor = CompileMonitor(self.registry)
        # only the handle that flipped the tracer on flips it off (and
        # clears its events) at shutdown
        self._owns_tracer_enable = False
        if enabled:
            self.start()

    @property
    def telemetry_enabled(self) -> bool:
        """True when the round programs should return ``RoundTelemetry``."""
        return self.enabled and self.telemetry

    @property
    def introspection_enabled(self) -> bool:
        """True when ``fit()`` should introspect its round programs."""
        return self.enabled and self.introspection

    @property
    def scrape_url(self) -> str | None:
        """Base URL of the live scrape endpoint, or None when not serving."""
        return self._scrape_server.url if self._scrape_server else None

    # -- run manifest ----------------------------------------------------
    def update_manifest(self, fields: "dict[str, Any]") -> dict:
        """Merge ``fields`` into the run manifest served at ``/manifest``
        (and exported as manifest.json). Returns the current manifest."""
        self._manifest.update(fields)
        return dict(self._manifest)

    @property
    def manifest(self) -> dict:
        return dict(self._manifest)

    def start(self) -> "Observability":
        """(Re-)arm the hooks: enable the tracer (streaming to
        ``output_dir/trace.json``), install the compile monitor, reset the
        watchdog's per-run state, start the scrape server. Called by
        ``__init__`` and again at each ``fit()``; idempotent; a no-op when
        disabled."""
        if self.enabled:
            self._unhealthy = None
            self._degraded = None
            if self.watchdog is not None:
                self.watchdog.reset()
            if not self.tracer.enabled:
                self.tracer.enabled = True
                self._owns_tracer_enable = True
            if self.output_dir is not None:
                os.makedirs(self.output_dir, exist_ok=True)
                self.tracer.stream_to(os.path.join(self.output_dir, "trace.json"))
            self.compile_monitor.install()
            if self.http_port is not None and self._scrape_server is None:
                ledger = self.fleet_ledger
                self._scrape_server = ScrapeServer(
                    self.registry,
                    manifest_provider=lambda: dict(self._manifest),
                    host=self.http_host,
                    port=self.http_port,
                    health_provider=lambda: self._unhealthy,
                    fleet_provider=((lambda: ledger.summary()) if ledger is not None
                                    else None),
                    client_provider=((lambda cid: ledger.get(cid)) if ledger is not None
                                     else None),
                    degraded_provider=lambda: self._degraded,
                    slo_provider=((lambda: self.slo.standing()) if self.slo is not None
                                  else None),
                    admin_plane=self.admin,
                )
        return self

    # -- abnormal-end surface -------------------------------------------
    @property
    def unhealthy_reason(self) -> str | None:
        """The verdict summary once the run halted, else None (healthy)."""
        return self._unhealthy

    def mark_unhealthy(self, reason: str) -> None:
        """Flip ``/healthz`` to 503 with ``reason`` as the body (a watchdog
        halt, every postmortem bundle)."""
        self._unhealthy = str(reason)

    def mark_healthy(self) -> None:
        """Reset ``/healthz`` back to 200 ("ok")."""
        self._unhealthy = None

    @property
    def degraded_slo(self) -> str | None:
        """Name of the SLO objective standing in breach, else None."""
        return self._degraded

    def mark_degraded(self, slo_name: str) -> None:
        """Flip ``/healthz`` to 200 ``degraded: <slo>``; a 503 verdict
        always wins over this channel."""
        self._degraded = str(slo_name)

    def clear_degraded(self) -> None:
        self._degraded = None

    def dump_bundle(self, verdict: "dict[str, Any]") -> str | None:
        """Publish a postmortem bundle (``observability/bundle.py``) under
        ``output_dir`` from the flight recorder's ring and the live trace,
        registry, manifest and ledger. Returns its path, or None when
        disabled or there is nowhere to publish. Marks the run unhealthy."""
        if not self.enabled or self.output_dir is None:
            return None
        from fl4health_tpu_torch.observability.bundle import dump_bundle

        path = dump_bundle(
            self.output_dir, verdict,
            recorder=self.flight_recorder,
            tracer=self.tracer if self.tracer.enabled else None,
            registry=self.registry,
            manifest=self._manifest or None,
            fleet=(self.fleet_ledger.snapshot() if self.fleet_ledger is not None else None),
        )
        self.mark_unhealthy(f"{verdict.get('kind', 'exception')}: "
                            f"{verdict.get('message', '')} (bundle: {path})")
        self.registry.counter(
            "fl_flightrec_bundles_total",
            help="postmortem bundles published on abnormal ends").inc()
        return path

    # -- tracing ---------------------------------------------------------
    def span(self, name: str, cat: str = "round", **args: Any):
        if not self.enabled:
            return _NULL_SPAN
        return self.tracer.span(name, cat=cat, **args)

    def instant(self, name: str, **args: Any) -> None:
        if self.enabled:
            self.tracer.instant(name, **args)

    # -- metrics ---------------------------------------------------------
    def counter(self, name: str, help: str = "", labels=None) -> Counter:
        return self.registry.counter(name, help=help, labels=labels)

    def gauge(self, name: str, help: str = "", labels=None) -> Gauge:
        return self.registry.gauge(name, help=help, labels=labels)

    def histogram(self, name: str, help: str = "", labels=None, **kw) -> Histogram:
        return self.registry.histogram(name, help=help, labels=labels, **kw)

    def log_event(self, event: str, **fields: Any) -> dict | None:
        if not self.enabled:
            return None
        rec = self.registry.log_event(event, **fields)
        if event == "recovery" and self.timeseries is not None:
            # the supervisor's ladder: engage/probation_passed/halt feed
            # the MTTR KPI
            self.timeseries.note_recovery(fields.get("phase"), ts=rec.get("ts"))
        return rec

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    # -- operations plane ------------------------------------------------
    def observe_round_kpis(self, rnd: int, summary: "dict[str, Any]", *,
                           fit_loss: float | None = None,
                           eval_loss: float | None = None):
        """Feed one epilogue round summary to the operations plane: refresh
        the KPI time-series, evaluate the SLO policy, and drive the
        degraded healthz channel. None when the plane is unarmed."""
        ts = self.timeseries
        if not self.enabled or ts is None:
            return None
        kpis = ts.observe_round(summary, fit_loss=fit_loss, eval_loss=eval_loss)
        if self.slo is None:
            return kpis
        verdict = self.slo.evaluate(rnd, kpis)
        if verdict["degraded_slo"] is not None:
            self.mark_degraded(verdict["degraded_slo"])
        else:
            self.clear_degraded()
        return verdict

    # -- CUDA hooks ------------------------------------------------------
    def fence(self, tree: Any) -> tuple[Any, float]:
        """Wait for the device and return (tree, wait_seconds); a pure
        pass-through when disabled: no sync on the disabled path."""
        return synced(tree, enabled=self.enabled and self.sync_device)

    def maybe_profile(self, round_idx: int):
        """``torch.profiler`` context for the chosen round, else a no-op."""
        if (self.enabled and self.profile_round_idx is not None
                and round_idx == self.profile_round_idx and self.output_dir is not None):
            return profile_round(os.path.join(self.output_dir, "xprof"))
        return profile_round(None)

    # -- export ----------------------------------------------------------
    def export(self) -> dict[str, str]:
        """Write trace.json, metrics.prom, metrics.jsonl (and manifest.json)
        under ``output_dir``. Returns {artifact: path}; empty when disabled
        or without an output_dir."""
        if not self.enabled or self.output_dir is None:
            return {}
        os.makedirs(self.output_dir, exist_ok=True)
        paths = {
            "trace": self.tracer.export(os.path.join(self.output_dir, "trace.json")),
            "prometheus": self.registry.export_prometheus(
                os.path.join(self.output_dir, "metrics.prom")),
            "events": self.registry.dump_jsonl(os.path.join(self.output_dir, "metrics.jsonl")),
        }
        if self._manifest:
            mpath = os.path.join(self.output_dir, "manifest.json")
            with atomic_write(mpath) as f:
                f.write(json.dumps(self._manifest, indent=2, default=str))
            paths["manifest"] = mpath
        return paths

    def shutdown(self) -> dict[str, str]:
        """Export the artifacts and disarm every hook: detach the compile
        monitor, close and join the scrape server, and (if this handle
        enabled the tracer) disable it and drop its events. ``start()``
        re-arms."""
        paths = self.export()
        self.compile_monitor.uninstall()
        if self._scrape_server is not None:
            self._scrape_server.close()
            self._scrape_server = None
        if self._owns_tracer_enable:
            self.tracer.enabled = False
            self.tracer.close_stream()
            self.tracer.clear()
            self._owns_tracer_enable = False
        if "events" in paths:
            self.registry.clear_events()
        return paths
