"""Round-program introspection (counterpart of
``fl4health_tpu/observability/introspect.py``) — what each round function
actually does.

JAX asks XLA at build time: ``compiled.cost_analysis()`` for flops,
transcendentals and bytes, ``compiled.memory_analysis()`` for the program's
device-memory footprint. The port has no compiled program, so
:meth:`ProgramIntrospector.introspect_fn` runs the function once under
``FakeTensorMode`` with the op counter of ``observability/hloscan.py``
inside it (``hloscan.count_program``):

- **no device work**: the run takes no device memory, launches no kernel
  and leaves the trajectory untouched, as JAX's build-time lowering does;
  each hand-written kernel's wrapper answers fake tensors with outputs of
  the right shape and reports the call (a custom call, 0 flops);
- ``flops``, ``transcendentals`` and ``bytes_accessed`` are the counter's
  totals. Unlike XLA's ``cost_analysis``, which counts a ``lax.scan`` body
  once, they count every op one dispatch runs, every local step included
  (ROADMAP.md C, R9);
- ``argument_bytes`` and ``output_bytes`` are what the names say;
  ``temp_bytes`` is the peak of live intermediate bytes, tracked as fake
  outputs are made and freed, less the outputs; ``generated_code_bytes``
  is None (there is no compiled program);
- ``compile_seconds`` is the traced run's wall time; ``cache_hits`` and
  ``cache_misses`` stay 0 (there is no compilation cache).

Each :class:`ProgramReport` lands in the metrics registry (``fl_program_*``
gauges labeled by program, ``fl_stage_*`` per stage), the JSONL event log
(one ``program`` event, one ``stage`` event a stage) and the
``fl_hbm_headroom_bytes`` gauge (device memory minus the largest program
footprint), under JAX's names and keys.

From a report plus a measured round time, measured MFU is ``flops / time /
peak``. As in JAX, a hand-written kernel's flops are not in the count.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any

from fl4health_tpu_torch.observability import device_specs, hloscan
from fl4health_tpu_torch.observability import stages as stage_attr
from fl4health_tpu_torch.observability.registry import MetricsRegistry

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ProgramReport:
    """One round program's cost, memory and trace accounting (JAX's fields).

    ``None`` fields mean the analysis is not available — callers must
    propagate the absence (a ``null`` in artifacts), never substitute a
    zero that reads as "measured: nothing"."""

    name: str
    backend: str
    device_kind: str
    # counted work of one dispatch
    flops: float | None = None
    transcendentals: float | None = None
    bytes_accessed: float | None = None
    # device-memory footprint components
    argument_bytes: int | None = None
    output_bytes: int | None = None
    temp_bytes: int | None = None
    generated_code_bytes: int | None = None
    # trace accounting
    compile_seconds: float | None = None
    cache_hits: int = 0
    cache_misses: int = 0
    # a chunk program executes this many rounds per dispatch
    rounds_per_dispatch: int = 1
    # cohort-draw site of a registry program ("in_graph" for the cohort
    # chunk); None on dense programs (omitted from as_dict/events)
    cohort_draw: str | None = None
    # the mesh descriptor (RoundProgramBuilder.descriptor()) of a program
    # built for a mesh; None without one (omitted from as_dict/events)
    mesh: dict | None = None
    # precision-policy descriptor under an active mixed-precision policy;
    # None on f32 builds (omitted from as_dict/events)
    precision: dict | None = None
    # per-stage cost rows (observability/hloscan.py) when stage attribution
    # is enabled; None otherwise (omitted from as_dict/events)
    stages: list | None = None

    @property
    def peak_hbm_bytes(self) -> int | None:
        """Conservative device-memory footprint of one dispatch: arguments
        + outputs + temporaries + generated code."""
        parts = (self.argument_bytes, self.output_bytes, self.temp_bytes,
                 self.generated_code_bytes)
        if all(p is None for p in parts):
            return None
        return int(sum(p or 0 for p in parts))

    @property
    def flops_per_round(self) -> float | None:
        if self.flops is None:
            return None
        return self.flops / max(self.rounds_per_dispatch, 1)

    @property
    def cache_hit(self) -> bool | None:
        """None: no compilation cache exists to hit or miss."""
        if self.cache_hits == 0 and self.cache_misses == 0:
            return None
        return self.cache_misses == 0

    def roofline(self) -> dict | None:
        return device_specs.roofline(self.flops, self.bytes_accessed, self.device_kind)

    def as_dict(self) -> dict[str, Any]:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for key in ("mesh", "precision", "cohort_draw", "stages"):
            if d.get(key) is None:
                del d[key]
        d["peak_hbm_bytes"] = self.peak_hbm_bytes
        d["cache_hit"] = self.cache_hit
        roof = self.roofline()
        if roof:
            d["roofline"] = roof
        return d


def device_identity(device) -> tuple[str, str]:
    """(backend, device kind) of a torch device: ``("gpu", <card name>)``
    on CUDA, else the device type twice."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return "gpu", torch.cuda.get_device_name(device)
    return device.type, device.type


class ProgramIntrospector:
    """Collects :class:`ProgramReport`\\ s for a run's round programs.

    One instance per ``Observability`` handle; reports accumulate in
    ``.reports`` (the last introspection of a name wins), each one's op
    counter in ``.counters``, and every capture lands in the registry and
    the JSONL log."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.reports: dict[str, ProgramReport] = {}
        self.counters: dict[str, hloscan.OpCounter] = {}

    # -- capture ---------------------------------------------------------
    def introspect_fn(self, name: str, fn: Any, args: tuple, device="cpu",
                      rounds_per_dispatch: int = 1, precision: dict | None = None,
                      cohort_draw: str | None = None,
                      mesh: dict | None = None) -> ProgramReport | None:
        """Run ``fn(*args)`` once on fake tensors (``hloscan.count_program``)
        and record the report. A chunk's ``args`` hold one round's inputs
        (its rounds are one function run back to back): its counts are
        scaled to its ``rounds_per_dispatch`` rounds, so the cost of
        introspection does not grow with the run. Returns None (after
        logging) on any failure — introspection must never take down a
        run."""
        try:
            backend, kind = device_identity(device)
            t0 = time.perf_counter()
            counter = hloscan.count_program(fn, args, device)
            seconds = time.perf_counter() - t0
            rows = counter.rows(kind, scale=rounds_per_dispatch)
            total = hloscan.totals(rows)
            report = ProgramReport(
                name=name, backend=backend, device_kind=kind,
                flops=total["flops"], transcendentals=total["transcendentals"],
                bytes_accessed=total["bytes_accessed"],
                argument_bytes=counter.argument_bytes, output_bytes=counter.output_bytes,
                temp_bytes=counter.temp_bytes, generated_code_bytes=None,
                compile_seconds=seconds, rounds_per_dispatch=rounds_per_dispatch,
                cohort_draw=cohort_draw, precision=precision, mesh=mesh,
                stages=rows if stage_attr.enabled() else None)
        except Exception:
            logger.warning("program introspection failed for %r", name, exc_info=True)
            return None
        self.counters[name] = counter
        self.record(report)
        return report

    def record(self, report: ProgramReport) -> ProgramReport:
        """Register a report's numbers as ``fl_program_*`` gauges (labeled
        by program) plus one ``program`` JSONL event."""
        self.reports[report.name] = report
        reg = self.registry
        labels = {"program": report.name}
        gauges = (
            ("fl_program_flops",
             "counted FLOPs of one round-program dispatch", report.flops),
            ("fl_program_bytes_accessed",
             "counted bytes accessed by one dispatch", report.bytes_accessed),
            ("fl_program_transcendentals",
             "counted transcendental ops per dispatch", report.transcendentals),
            ("fl_program_hbm_peak_bytes",
             "program device-memory footprint (args+outputs+temps+code)",
             report.peak_hbm_bytes),
            ("fl_program_compile_seconds",
             "wall time of this program's traced run", report.compile_seconds),
        )
        for gname, ghelp, value in gauges:
            if value is not None:
                reg.gauge(gname, help=ghelp, labels=labels).set(float(value))
        for row in report.stages or ():
            slabels = {"program": report.name, "stage": row["stage"]}
            reg.gauge("fl_stage_flops",
                      help="op-attributed FLOPs of one spine stage per dispatch",
                      labels=slabels).set(float(row["flops"]))
            reg.gauge("fl_stage_bytes",
                      help="op-attributed memory bytes of one spine stage per dispatch",
                      labels=slabels).set(float(row["bytes_accessed"]))
            if "bound" in row:
                # only when the device roofline is known — never fabricated
                reg.gauge("fl_stage_bound",
                          help="1 = stage is compute-bound on this device, 0 = memory-bound",
                          labels=slabels).set(1.0 if row["bound"] == "compute" else 0.0)
            reg.log_event("stage", program=report.name, **row)
        reg.log_event("program", **report.as_dict())
        return report

    # -- derived numbers -------------------------------------------------
    def max_program_footprint(self) -> int | None:
        peaks = [r.peak_hbm_bytes for r in self.reports.values()
                 if r.peak_hbm_bytes is not None]
        return max(peaks) if peaks else None

    def hbm_headroom_bytes(self, device: int = 0) -> int | None:
        """Device memory minus the largest program footprint; sets the
        ``fl_hbm_headroom_bytes`` gauge when computable (a card's capacity
        and at least one report)."""
        footprint = self.max_program_footprint()
        total = device_specs.device_memory_bytes(device)
        if footprint is None or total is None:
            return None
        headroom = int(total - footprint)
        self.registry.gauge(
            "fl_hbm_headroom_bytes",
            help="device memory minus peak round-program footprint",
        ).set(headroom)
        return headroom

    def round_flops(self, names: tuple[str, ...]) -> float | None:
        """Sum of per-round FLOPs over the named programs (the ones one
        federated round dispatches); None when none were counted."""
        vals = [self.reports[n].flops_per_round for n in names
                if n in self.reports and self.reports[n].flops_per_round is not None]
        return sum(vals) if vals else None

    def clear(self) -> None:
        self.reports.clear()
        self.counters.clear()
