"""Postmortem bundles (counterpart of ``fl4health_tpu/observability/bundle.py``,
the same layout and verdicts over the port's frame writer): self-contained
evidence directories for abnormal ends.

When ``fit()`` dies — watchdog ``TrainingHealthError``, a failure policy's
``ClientFailuresError``, a cross-silo ``QuorumError``, a corrupt-checkpoint
restore, an unhandled exception, or a SIGTERM preemption —
:func:`dump_bundle` publishes everything a postmortem needs into ONE
atomically-renamed directory:

    postmortem_<ts>/
      ring.msgpack       the flight recorder's last-``window`` round records,
                         written through the checkpointing frame writer
                         (versioned header + msgpack blob + CRC32 footer —
                         corruption is DETECTED at read, like checkpoints)
      manifest.json      the run manifest (versions, chip, execution mode,
                         config hash) as served at /manifest
      trace.json         the span tracer's Chrome trace — properly
                         TERMINATED here, whatever state the live stream is in
      events.tail.jsonl  the JSONL event log still in memory (pre-rollover
                         history rides along as events.*.jsonl.gz when the
                         registry archives evicted segments)
      metrics.prom       a final Prometheus scrape of the registry
      fleet.json         the fleet ledger's lifetime snapshot (per-client
                         records + sketches), when a ledger was armed
      verdict.json       what killed the run: kind, round, clients (REGISTRY
                         ids under cohort-slot execution), check, message,
                         per-silo outcomes for quorum failures, and the
                         newest good checkpoint generation to resume from

``tools/postmortem.py`` renders a bundle into an incident report with no
access to the dead process; :func:`load_bundle` is the shared reader. A
bundle written by either package loads with the other's ``load_bundle``:
the ring frame is the checkpoint frame, byte for byte flax's msgpack
(``checkpointing/serialization.py``).

Atomicity: the directory is assembled under a ``.tmp`` sibling and
published with one ``os.rename`` — a crash mid-dump never leaves a
half-written ``postmortem_*`` directory for an operator to trust.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import time
from typing import Any, Mapping

import numpy as np

from fl4health_tpu_torch.core.io import atomic_write

BUNDLE_PREFIX = "postmortem_"
RING_FRAME = "ring.msgpack"
VERDICT_FILE = "verdict.json"
TRACE_FILE = "trace.json"
EVENTS_FILE = "events.tail.jsonl"
METRICS_FILE = "metrics.prom"
MANIFEST_FILE = "manifest.json"
FLEET_FILE = "fleet.json"


def _jsonable(obj: Any) -> Any:
    """Best-effort JSON coercion for verdict/header facts (numpy scalars,
    arrays, exceptions)."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def _registry_ids_for_round(recorder, round_idx: int):
    for entry in reversed(recorder.entries):
        if entry["round"] == int(round_idx):
            ids = entry.get("registry_ids")
            if ids is not None:
                return np.asarray(ids)
            return None
    return None


def verdict_from_exception(exc: BaseException, recorder=None) -> dict:
    """Classify an abnormal end into the ``verdict.json`` document.

    Typed failures keep their structure (round, clients, check, quorum
    silo outcomes, corrupt file); everything else lands as
    ``kind="exception"``. When the recorder maps the verdict round's slots
    to registry ids (cohort-slot execution), ``clients`` is translated to
    REGISTRY ids (``slot_clients`` keeps the raw positions)."""
    verdict: dict[str, Any] = {
        "exception": type(exc).__name__,
        "message": str(exc),
        "ts": time.time(),
    }
    from fl4health_tpu_torch.observability.flightrec import SigtermShutdown
    from fl4health_tpu_torch.observability.health import TrainingHealthError

    if isinstance(exc, SigtermShutdown):
        verdict["kind"] = "sigterm"
        verdict["signal"] = "SIGTERM"
        # SystemExit's str() is its exit code — say what actually happened
        verdict["message"] = "SIGTERM received during fit()"
        if recorder is not None and recorder.last_round() is not None:
            verdict["round"] = recorder.last_round()
    elif isinstance(exc, TrainingHealthError):
        verdict["kind"] = "training_health"
        verdict["round"] = exc.round
        verdict["clients"] = list(exc.clients)
        verdict["check"] = exc.check
    elif type(exc).__name__ == "ClientFailuresError":
        verdict["kind"] = "client_failures"
        if getattr(exc, "round", None) is not None:
            verdict["round"] = int(exc.round)
        elif recorder is not None and recorder.last_round() is not None:
            verdict["round"] = recorder.last_round()
        reg_clients = getattr(exc, "registry_clients", None)
        clients = getattr(exc, "clients", None)
        if reg_clients is not None:
            # cohort rounds: the epilogue already mapped slots -> ids
            verdict["clients"] = list(reg_clients)
            verdict["slot_clients"] = list(clients or [])
        elif clients:
            verdict["clients"] = list(clients)
    elif type(exc).__name__ == "QuorumError":
        # duck-typed: the transport that raises it is not ported yet
        verdict["kind"] = "quorum"
        verdict["required"] = getattr(exc, "required", None)
        verdict["succeeded"] = getattr(exc, "succeeded", None)
        verdict["failures"] = [
            list(f) for f in getattr(exc, "failures", [])
        ]
        report = getattr(exc, "report", None)
        if report is not None:
            # per-silo outcomes of the failed broadcast — who replied, who
            # timed out, after how many attempts (transport/coordinator.py)
            verdict["silos"] = [
                {
                    "silo": r.silo, "ok": r.ok, "reason": r.reason,
                    "attempts": r.attempts,
                    "elapsed_s": round(float(r.elapsed_s), 6),
                }
                for r in report.results
            ]
    elif type(exc).__name__ == "CheckpointCorruptError":
        verdict["kind"] = "checkpoint_corrupt"
        verdict["path"] = getattr(exc, "path", None)
        verdict["reason"] = getattr(exc, "reason", None)
    else:
        verdict["kind"] = "exception"
        if recorder is not None and recorder.last_round() is not None:
            verdict["round"] = recorder.last_round()
    if recorder is not None:
        ck = recorder.checkpoint
        if ck:
            # "what to resume from": the newest durable generation the dead
            # run published (the retention ring's newest-good fallback
            # covers it being damaged later)
            verdict["resume"] = {
                k: ck.get(k)
                for k in ("path", "generation", "round", "kind", "bytes")
                if k in ck
            }
        if (verdict.get("clients") and "slot_clients" not in verdict):
            # cohort rounds recorded registry ids for the verdict round:
            # translate slot positions into the ids operators know
            ids = _registry_ids_for_round(recorder, verdict.get("round", -1))
            if ids is not None:
                verdict["slot_clients"] = list(verdict["clients"])
                verdict["clients"] = [
                    int(ids[c]) for c in verdict["slot_clients"]
                    if 0 <= int(c) < len(ids)
                ]
    return _jsonable(verdict)


def dump_bundle(out_dir: str, verdict: Mapping[str, Any], *,
                recorder=None, tracer=None, registry=None,
                manifest: Mapping[str, Any] | None = None,
                fleet: Mapping[str, Any] | None = None,
                timestamp: float | None = None) -> str:
    """Assemble and atomically publish one ``postmortem_<ts>/`` directory
    under ``out_dir``; returns its path. Never raises into the caller's
    (already failing) control flow beyond filesystem errors — callers wrap
    it (``FederatedSimulation._dump_postmortem`` logs and continues)."""
    ts = time.strftime("%Y%m%d_%H%M%S",
                       time.localtime(timestamp or time.time()))
    final = os.path.join(out_dir, f"{BUNDLE_PREFIX}{ts}")
    n = 0
    while os.path.exists(final):  # two abnormal ends in one second
        n += 1
        final = os.path.join(out_dir, f"{BUNDLE_PREFIX}{ts}_{n}")
    tmp = f"{final}.tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    try:
        with atomic_write(os.path.join(tmp, VERDICT_FILE)) as f:
            json.dump(_jsonable(dict(verdict)), f, indent=2, default=str)
        if recorder is not None:
            # frame-writer reuse (checkpointing/state.py): versioned header
            # + msgpack blob + CRC32 footer, read back by load_bundle
            from fl4health_tpu_torch.checkpointing.state import write_frame

            write_frame(
                os.path.join(tmp, RING_FRAME),
                {"rounds": {str(i): e for i, e
                            in enumerate(recorder.entries)}},
                host_header={
                    "window": recorder.window,
                    "rounds": recorder.rounds,
                    "checkpoint": _jsonable(recorder.checkpoint),
                    "run": _jsonable(recorder.run_facts),
                },
                meta={"kind": "flightrec"},
            )
        if manifest:
            with atomic_write(os.path.join(tmp, MANIFEST_FILE)) as f:
                json.dump(_jsonable(dict(manifest)), f, indent=2,
                          default=str)
        if fleet:
            # the fleet ledger's lifetime snapshot (observability/fleet.py)
            # — repeat-offender evidence for the suspect ranking, beyond
            # the ring's 16-round window
            with atomic_write(os.path.join(tmp, FLEET_FILE)) as f:
                json.dump(_jsonable(dict(fleet)), f, default=str)
        if tracer is not None:
            # a COMPLETE Chrome trace envelope, whatever state the live
            # stream file is in — the bundle's copy always json.load()s
            with atomic_write(os.path.join(tmp, TRACE_FILE)) as f:
                json.dump(tracer.to_chrome_trace(), f)
        if registry is not None:
            with atomic_write(os.path.join(tmp, EVENTS_FILE)) as f:
                for rec in registry.events:
                    f.write(json.dumps(rec, default=str) + "\n")
            with atomic_write(os.path.join(tmp, METRICS_FILE)) as f:
                f.write(registry.to_prometheus())
            for seg in getattr(registry, "archive_paths", lambda: [])():
                # pre-rollover history the archive rollover preserved
                shutil.copy2(seg, os.path.join(tmp, os.path.basename(seg)))
        os.rename(tmp, final)  # single atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _unflax(obj: Any) -> Any:
    """Undo the frame serialization's list->{"0": ..} dict convention so the
    restored ring reads like the recorder's entries."""
    if isinstance(obj, dict):
        out = {k: _unflax(v) for k, v in obj.items()}
        keys = list(out.keys())
        if keys and all(isinstance(k, str) and k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx == list(range(len(idx))):
                return [out[str(i)] for i in idx]
        return out
    return obj


def list_bundles(out_dir: str) -> list[str]:
    """Published bundle directories under ``out_dir``, oldest first."""
    return sorted(
        p for p in glob.glob(os.path.join(out_dir, f"{BUNDLE_PREFIX}*"))
        if os.path.isdir(p) and ".tmp." not in os.path.basename(p)
    )


def load_bundle(path: str) -> dict:
    """Read one bundle directory -> ``{verdict, ring, ring_header,
    manifest, events, trace, metrics_prom, archives}``. CRC-verifies the
    ring frame (raises ``CheckpointCorruptError`` on damage); absent
    artifacts load as None/empty. Standalone: needs nothing from the
    process that wrote the bundle."""
    out: dict[str, Any] = {"path": path}
    vpath = os.path.join(path, VERDICT_FILE)
    with open(vpath) as f:
        out["verdict"] = json.load(f)
    ring_path = os.path.join(path, RING_FRAME)
    out["ring"], out["ring_header"] = [], {}
    if os.path.exists(ring_path):
        from fl4health_tpu_torch.checkpointing import serialization
        from fl4health_tpu_torch.checkpointing.state import read_frame

        header, meta, blob = read_frame(ring_path)
        out["ring_header"] = header
        out["ring_meta"] = meta
        rounds = _unflax(serialization.msgpack_restore(blob)).get("rounds")
        if isinstance(rounds, dict):  # zero/one-entry rings stay dicts
            rounds = [rounds[k] for k in sorted(rounds, key=int)]
        out["ring"] = rounds or []
    mpath = os.path.join(path, MANIFEST_FILE)
    out["manifest"] = None
    if os.path.exists(mpath):
        with open(mpath) as f:
            out["manifest"] = json.load(f)
    fpath = os.path.join(path, FLEET_FILE)
    out["fleet"] = None
    if os.path.exists(fpath):
        with open(fpath) as f:
            out["fleet"] = json.load(f)
    out["events"] = []
    epath = os.path.join(path, EVENTS_FILE)
    archives = sorted(glob.glob(os.path.join(path, "*.jsonl.gz")))
    out["archives"] = archives
    for seg in archives:  # archived (pre-rollover) events first: oldest
        with gzip.open(seg, "rt") as f:
            for line in f:
                line = line.strip()
                if line:
                    out["events"].append(json.loads(line))
    if os.path.exists(epath):
        with open(epath) as f:
            for line in f:
                line = line.strip()
                if line:
                    out["events"].append(json.loads(line))
    tpath = os.path.join(path, TRACE_FILE)
    out["trace"] = None
    if os.path.exists(tpath):
        from fl4health_tpu_torch.observability.spans import load_trace

        out["trace"] = load_trace(tpath)
    ppath = os.path.join(path, METRICS_FILE)
    out["metrics_prom"] = None
    if os.path.exists(ppath):
        with open(ppath) as f:
            out["metrics_prom"] = f.read()
    return out
