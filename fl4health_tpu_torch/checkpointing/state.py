"""State checkpointing (counterpart of ``fl4health_tpu/checkpointing/state.py``):
crash-consistent resume of a federated run.

Every piece of training state (the stacked client ``TrainState``, the
strategy's server state, the async ``pending`` buffer, a cohort run's
registry rows) is a tree, so one frame holds them as one msgpack blob
(``checkpointing/serialization.py``, byte for byte flax's) beside a small
JSON header of host values (the round, the history, typed by
``Snapshotter``s).

Crash consistency, as in JAX:

- **Versioned, CRC-footed frames.** One checkpoint is one file,
  ``[magic][version][header-length][header JSON][msgpack blob][CRC32]``,
  written to a temp sibling and published with one ``os.replace``
  (``core.io.atomic_write``), so a SIGKILL mid-write never tears the
  published path; the CRC32 footer covers every byte before it, so a torn
  or corrupted file is detected at restore.
- **Retention ring.** The last ``keep`` generations stay as
  ``<name>.g<NNNNNNNN>.ckpt``; restore walks newest to oldest, and a corrupt
  newest generation falls back to the previous good one.
- **Config binding.** The header carries the run's ``config_hash``
  (``observability/manifest.py``); a simulation whose resume-relevant
  config hashes differently raises :class:`CheckpointConfigMismatchError`.
- **Typed corruption errors** name the file (:class:`CheckpointCorruptError`).

Legacy (pre-ring) ``<name>.ckpt`` files, with no magic and no CRC, still
load as format version 0. A frame written by either package reads in the
other (``tests/test_torch_state_format.py``). A record class stored in a
frame resolves only under ``fl4health_tpu_torch.*``: a frame written by JAX
names JAX's ``RoundRecord``, which the port never imports, so its history
restores through the port's template instead. The port's frames carry no
fleet ledger (no ``"fleet"`` key), as JAX's do with the ledger off.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import os
import re
import time
import zlib
from abc import ABC, abstractmethod
from typing import Any, Callable, Mapping

from fl4health_tpu_torch.checkpointing import serialization
from fl4health_tpu_torch.core.io import atomic_write

logger = logging.getLogger(__name__)

# Frame layout v1: MAGIC (8B) | version u32 BE | header length u64 BE |
# header JSON (utf-8) | msgpack blob | CRC32 u32 BE over all prior bytes.
_MAGIC = b"FL4HCKPT"
FORMAT_VERSION = 1
# magic + version + header length + (empty header) + (empty blob) + crc
_MIN_FRAME = len(_MAGIC) + 4 + 8 + 4


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed structural validation (truncated frame,
    CRC mismatch, unparseable header, unknown format version). The message
    names the file so the ring fallback / operator knows which generation
    died."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint {path}: {reason}")
        self.path = path
        self.reason = reason


class CheckpointConfigMismatchError(ValueError):
    """The checkpoint was written by a run whose resume-relevant config
    hashes differently — restoring it would silently continue a different
    experiment."""

    def __init__(self, path: str, stored: str, current: str):
        super().__init__(
            f"checkpoint {path} was written under config_hash {stored} but "
            f"this run's resume-relevant config hashes to {current}; a "
            "checkpoint resumes only the experiment that wrote it (rebuild "
            "the simulation with the original configuration, or clear() the "
            "checkpoint directory to start fresh)"
        )
        self.path = path
        self.stored = stored
        self.current = current


# -- frame primitives --------------------------------------------------------

def write_frame(path: str, trees: Mapping[str, Any],
                host_header: Mapping[str, Any] | None = None,
                meta: Mapping[str, Any] | None = None) -> dict:
    """Serialize + atomically publish ONE versioned frame at ``path``:
    ``[magic][version][header-length][header JSON][msgpack blob][CRC32]``.
    ``trees`` is any bag of trees ``serialization`` takes (the msgpack blob);
    ``host_header``/``meta`` land in the JSON header. Returns
    ``{path, bytes, write_s}``."""
    t0 = time.perf_counter()
    header_bytes = json.dumps(
        {"host": dict(host_header or {}), "meta": {
            "format_version": FORMAT_VERSION,
            "saved_unix": time.time(),
            **dict(meta or {}),
        }}
    ).encode("utf-8")
    blob = serialization.to_bytes(dict(trees))
    body = b"".join((
        _MAGIC,
        FORMAT_VERSION.to_bytes(4, "big"),
        len(header_bytes).to_bytes(8, "big"),
        header_bytes,
        blob,
    ))
    crc = zlib.crc32(body) & 0xFFFFFFFF
    with atomic_write(path, "wb") as f:  # single atomic publish
        f.write(body)
        f.write(crc.to_bytes(4, "big"))
    return {"path": path, "bytes": len(body) + 4,
            "write_s": time.perf_counter() - t0}


def read_frame(path: str) -> tuple[dict, dict, bytes]:
    """Parse + CRC-verify one frame -> (host_header, meta, msgpack blob).
    Raises :class:`CheckpointCorruptError` naming the file on any
    structural failure; legacy (pre-magic) v0 files still load."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_MAGIC):
        # legacy v0: [8B header length][header JSON][blob], no CRC
        if len(data) < 8:
            raise CheckpointCorruptError(path, "truncated legacy frame")
        n = int.from_bytes(data[:8], "big")
        if 8 + n > len(data):
            raise CheckpointCorruptError(
                path, "truncated legacy header (torn write?)"
            )
        try:
            header = json.loads(data[8:8 + n].decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                path, f"unparseable legacy header ({e})"
            ) from e
        return header, {"format_version": 0}, data[8 + n:]
    if len(data) < _MIN_FRAME:
        raise CheckpointCorruptError(
            path, f"truncated frame ({len(data)} bytes)"
        )
    body, crc_stored = data[:-4], int.from_bytes(data[-4:], "big")
    if (zlib.crc32(body) & 0xFFFFFFFF) != crc_stored:
        raise CheckpointCorruptError(
            path, "CRC32 mismatch (torn or corrupt write)"
        )
    version = int.from_bytes(data[8:12], "big")
    if version > FORMAT_VERSION:
        raise CheckpointCorruptError(
            path,
            f"format version {version} is newer than this build's "
            f"{FORMAT_VERSION}",
        )
    hlen = int.from_bytes(data[12:20], "big")
    if 20 + hlen > len(body):
        raise CheckpointCorruptError(path, "truncated header")
    try:
        header = json.loads(body[20:20 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            path, f"unparseable header ({e})"
        ) from e
    return (header.get("host", {}), header.get("meta", {}),
            body[20 + hlen:])


@dataclasses.dataclass
class RestoreInfo:
    """Facts about one successful restore — which file/generation won, and
    which newer generations were skipped as corrupt (the ring fallback)."""

    path: str
    generation: int  # 0 for a legacy (pre-ring) file
    nbytes: int
    meta: dict
    fallback_skipped: list[str] = dataclasses.field(default_factory=list)


class Snapshotter(ABC):
    """Typed converter to/from a JSON-safe header value
    (utils/snapshotter.py:46 equivalent for host-side state)."""

    @abstractmethod
    def save(self, value: Any) -> Any:
        ...

    @abstractmethod
    def load(self, payload: Any, template: Any) -> Any:
        ...


class SerializableSnapshotter(Snapshotter):
    """ints / floats / strings / bools / lists / dicts — stored verbatim."""

    def save(self, value):
        return value

    def load(self, payload, template):
        return payload


def _resolve_dataclass(spec: str):
    """``module:QualName`` -> class, or None when unresolvable (the caller
    degrades to raw dicts rather than failing the whole restore). Only the
    port's own modules are imported: a name from another package (JAX's
    ``fl4health_tpu.server.simulation:RoundRecord``) is unresolvable."""
    mod_name, _, qual = spec.partition(":")
    if mod_name != "fl4health_tpu_torch" and not mod_name.startswith("fl4health_tpu_torch."):
        logger.warning("checkpoint record class %r is not the port's; using the "
                       "template", spec)
        return None
    try:
        obj: Any = importlib.import_module(mod_name)
        for part in qual.split("."):
            obj = getattr(obj, part)
        return obj if dataclasses.is_dataclass(obj) else None
    except Exception:
        logger.warning("cannot resolve checkpoint record class %r", spec)
        return None


class DataclassListSnapshotter(Snapshotter):
    """A list of dataclass records (e.g. RoundRecord history).

    The header stores the record class name alongside the rows, so a
    NON-empty payload restores real dataclass instances even when the
    caller's template list is empty (the natural resume template — the
    fresh run has no history yet). Legacy headers (a bare row list, no
    class name) still load; without a template *or* a stored class name
    they degrade to raw dicts, the old behavior."""

    def save(self, value):
        payload: dict[str, Any] = {
            "rows": [dataclasses.asdict(v) for v in value]
        }
        if value:
            cls = type(value[0])
            payload["record_class"] = f"{cls.__module__}:{cls.__qualname__}"
        return payload

    def load(self, payload, template):
        if payload is None:
            return []
        if isinstance(payload, list):  # legacy header: bare row list
            rows, record_class = payload, None
        else:
            rows = payload.get("rows", [])
            record_class = payload.get("record_class")
        if not rows:
            return []
        cls = type(template[0]) if template else None
        if cls is None and record_class:
            cls = _resolve_dataclass(record_class)
        if cls is None:
            return rows
        return [cls(**row) for row in rows]


class StateCheckpointer:
    """Save/load a named bag of state: array pytrees go into one msgpack
    blob, host-side values into a JSON header. Loading requires templates
    with the same structure (the caller always has them — it constructs the
    run first, then restores into it).

    ``keep`` sizes the retention ring (≥1; 2 by default so a corrupt newest
    generation still has a good predecessor). ``checkpoint_every`` is the
    save cadence the simulation honors — on the chunked execution path it
    also sets ``rounds_per_dispatch``, so each snapshot rides the existing
    chunk-boundary host touch instead of forcing per-round dispatch.
    ``config_hash`` binds every frame to the writing run's resume-relevant
    config (``FederatedSimulation`` fills it in at ``fit()`` when left
    None). ``on_save`` is an optional callback receiving a stats dict
    ``{path, generation, bytes, write_s, ...extra_meta}`` after each
    publish (the simulation keeps the stats in ``round_metrics``); it may
    run on the async writer thread.
    """

    def __init__(self, directory: str, name: str = "state", *,
                 keep: int = 2, checkpoint_every: int = 1,
                 config_hash: str | None = None,
                 on_save: Callable[[dict], None] | None = None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1; got {keep}")
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1; got {checkpoint_every}"
            )
        self.directory = directory
        self.name = name
        self.keep = int(keep)
        self.checkpoint_every = int(checkpoint_every)
        self.config_hash = config_hash
        self.on_save = on_save
        self.last_save_stats: dict | None = None
        self.last_restore_info: RestoreInfo | None = None

    # -- paths -----------------------------------------------------------
    @property
    def _legacy_path(self) -> str:
        return os.path.join(self.directory, f"{self.name}.ckpt")

    # kept for callers/tests that reference the pre-ring single path
    _path = _legacy_path

    def _generation_path(self, gen: int) -> str:
        return os.path.join(self.directory, f"{self.name}.g{gen:08d}.ckpt")

    def generations(self) -> list[tuple[int, str]]:
        """(generation, path) pairs present on disk, oldest first."""
        pat = re.compile(re.escape(self.name) + r"\.g(\d{8})\.ckpt$")
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for fname in names:
            m = pat.fullmatch(fname)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, fname)))
        return sorted(out)

    def candidate_paths(self) -> list[tuple[int, str]]:
        """Restore candidates newest-first: ring generations, then the
        legacy single file (generation 0) if present."""
        cands = list(reversed(self.generations()))
        if os.path.exists(self._legacy_path):
            cands.append((0, self._legacy_path))
        return cands

    def exists(self) -> bool:
        return bool(self.candidate_paths())

    def _orphan_tmp_paths(self) -> list[str]:
        """Temp siblings (``<frame>.tmp.<pid>``) a SIGKILL mid-write left
        behind — ``atomic_write`` unlinks them on a Python exception, but
        a hard kill can't. A preemptible job would otherwise leak one
        full-frame file per eviction, forever."""
        pat = re.compile(
            re.escape(self.name) + r"\.(g\d{8}\.)?ckpt\.tmp\.\d+$"
        )
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return [os.path.join(self.directory, n) for n in names
                if pat.fullmatch(n)]

    def _prune_orphan_tmp(self) -> None:
        # called right after an atomic publish: our own temp file has been
        # renamed away by then, so everything still matching is litter
        # from a killed writer (single-writer-per-directory contract)
        for path in self._orphan_tmp_paths():
            try:
                os.remove(path)
            except OSError:
                pass

    def clear(self) -> None:
        for _gen, path in self.candidate_paths():
            try:
                os.remove(path)
            except OSError:
                pass
        self._prune_orphan_tmp()

    def prune_generations_from_round(self, round_idx: int) -> list[str]:
        """Rollback support (JAX's ``resilience/supervisor.py``): delete ring
        generations whose frame ``meta["round"]`` is at or past
        ``round_idx`` — after an abnormal end at round *r* the newest
        durable generations may already hold the poisoned state, so a
        resume must restore a generation that PREDATES the failure.
        Corrupt frames are pruned too (they are rollback fodder either
        way); legacy frames with no recorded round are kept — deleting
        state of unknown vintage is an operator call, not a supervisor's.
        Returns the deleted paths."""
        removed: list[str] = []
        for _gen, path in self.candidate_paths():
            try:
                _host, meta, _blob = read_frame(path)
            except CheckpointCorruptError:
                meta = {"round": round_idx}  # corrupt: treat as at-fault
            r = meta.get("round")
            if r is None or int(r) < int(round_idx):
                continue
            try:
                os.remove(path)
                removed.append(path)
            except OSError:
                logger.warning("could not prune checkpoint generation at "
                               "%s during rollback", path)
        return removed

    # -- save ------------------------------------------------------------
    def save(self, trees: Mapping[str, Any], host: Mapping[str, Any] | None = None,
             snapshotters: Mapping[str, Snapshotter] | None = None,
             extra_meta: Mapping[str, Any] | None = None) -> dict:
        """Serialize + atomically publish one new generation, prune the
        ring to ``keep``, and return the save stats dict."""
        t0 = time.perf_counter()
        os.makedirs(self.directory, exist_ok=True)
        snapshotters = snapshotters or {}
        host_header: dict[str, Any] = {}
        for k, v in (host or {}).items():
            snap = snapshotters.get(k, SerializableSnapshotter())
            host_header[k] = snap.save(v)
        gens = self.generations()
        gen = (gens[-1][0] + 1) if gens else 1
        path = self._generation_path(gen)
        frame_stats = write_frame(
            path, trees, host_header=host_header,
            meta={"config_hash": self.config_hash, **dict(extra_meta or {})},
        )
        # rotation: prune only AFTER the new generation is durable, so a
        # kill anywhere in save() leaves at least the previous good ring
        for old_gen, old_path in gens[:max(len(gens) + 1 - self.keep, 0)]:
            try:
                os.remove(old_path)
            except OSError:
                logger.warning("could not prune checkpoint generation %d "
                               "(%s)", old_gen, old_path)
        # ...and sweep up temp litter a previous process's mid-write kill
        # left behind (our own temp was just renamed into place)
        self._prune_orphan_tmp()
        stats = {
            "path": path,
            "generation": gen,
            "bytes": frame_stats["bytes"],
            "write_s": time.perf_counter() - t0,
            **dict(extra_meta or {}),
        }
        self.last_save_stats = stats
        if self.on_save is not None:
            try:
                self.on_save(dict(stats))
            except Exception:
                # metrics and reporting hooks must never take down a save (it
                # may be the last durable state before a preemption)
                logger.warning("checkpoint on_save hook failed",
                               exc_info=True)
        return stats

    # -- read / verify ---------------------------------------------------
    def _read_file(self, path: str) -> tuple[dict, dict, bytes]:
        """Parse + verify ONE checkpoint file -> (host_header, meta, blob).
        Raises :class:`CheckpointCorruptError` naming the file on any
        structural failure. Thin wrapper over :func:`read_frame` (the
        shared frame primitive)."""
        return read_frame(path)

    def _read(self) -> tuple[dict, dict, bytes, RestoreInfo]:
        """Newest-good read with ring fallback: walk candidates newest to
        oldest, skipping (and logging) corrupt generations. Raises the
        newest file's :class:`CheckpointCorruptError` when every candidate
        is bad, and ``FileNotFoundError`` when none exists."""
        cands = self.candidate_paths()
        if not cands:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory!r} "
                f"(name={self.name!r})"
            )
        skipped: list[str] = []
        first_err: CheckpointCorruptError | None = None
        for gen, path in cands:
            try:
                host, meta, blob = self._read_file(path)
            except CheckpointCorruptError as e:
                logger.warning(
                    "checkpoint generation %d is corrupt (%s); falling "
                    "back to the previous generation", gen, e,
                )
                skipped.append(path)
                first_err = first_err or e
                continue
            info = RestoreInfo(
                path=path, generation=gen,
                nbytes=os.path.getsize(path), meta=meta,
                fallback_skipped=skipped,
            )
            return host, meta, blob, info
        assert first_err is not None
        raise first_err

    # -- load ------------------------------------------------------------
    def load_with_info(
        self, tree_templates: Mapping[str, Any],
        host_templates: Mapping[str, Any] | None = None,
        snapshotters: Mapping[str, Snapshotter] | None = None,
        expected_config_hash: str | None = None,
    ) -> tuple[dict, dict, RestoreInfo]:
        snapshotters = snapshotters or {}
        header, meta, blob, info = self._read()
        stored = meta.get("config_hash")
        if (expected_config_hash is not None and stored is not None
                and stored != expected_config_hash):
            raise CheckpointConfigMismatchError(
                info.path, stored, expected_config_hash
            )
        trees = serialization.from_bytes(dict(tree_templates), blob)
        host = {}
        for k, template in (host_templates or {}).items():
            snap = snapshotters.get(k, SerializableSnapshotter())
            host[k] = snap.load(header.get(k), template)
        self.last_restore_info = info
        return trees, host, info

    def load(self, tree_templates: Mapping[str, Any],
             host_templates: Mapping[str, Any] | None = None,
             snapshotters: Mapping[str, Snapshotter] | None = None,
             expected_config_hash: str | None = None,
             ) -> tuple[dict, dict]:
        trees, host, _info = self.load_with_info(
            tree_templates, host_templates, snapshotters,
            expected_config_hash=expected_config_hash,
        )
        return trees, host


class SimulationStateCheckpointer(StateCheckpointer):
    """The simulation's state: the server's (model, current round, history)
    and every client's (model, optimizer, key), since the stacked client
    ``TrainState`` carries them all in one tree.

    Beyond the synchronous roles it also snapshots buffered-async runs
    (``save_async_snapshot``/``load_async_simulation``): the FedBuff
    ``pending`` update buffer, the event cursor, and the virtual clock —
    plus a fingerprint of the consumed prefix of the static event plan, so
    a resume can PROVE it is continuing the same arrival schedule before
    splicing restored state into it."""

    TREES = ("server_state", "client_states")

    def save_simulation(self, sim, current_round: int) -> None:
        self.save_simulation_snapshot(
            trees={
                "server_state": sim.server_state,
                "client_states": sim.client_states,
            },
            current_round=current_round,
            n_clients=sim.n_clients,
            history=list(sim.history),
        )

    def save_simulation_snapshot(
        self, trees, current_round: int, n_clients: int, history,
        writer=None,
    ) -> None:
        """Persist an explicit state snapshot, the round loops' entry point.
        ``trees`` must be copies the next round cannot overwrite (host numpy
        from the round's pull). With ``writer`` (an
        ``AsyncCheckpointWriter``) the serialize and write happen
        off-thread; saves stay ordered because the writer is single-worker."""
        host = {
            "kind": "sync",
            "current_round": current_round,
            "n_clients": n_clients,
            "history": list(history),
        }
        kwargs = dict(
            trees=dict(trees),
            host=host,
            snapshotters={"history": DataclassListSnapshotter()},
            extra_meta={"round": current_round, "kind": "sync"},
        )
        if writer is not None:
            writer.submit(self.save, **kwargs)
        else:
            self.save(**kwargs)

    def save_async_snapshot(
        self, trees, event: int, n_clients: int, history,
        plan_fingerprint: str, virtual_time_s: float, writer=None,
    ) -> None:
        """Persist a buffered-async snapshot: server state, client stack
        AND the in-flight ``pending`` update buffer, with the event cursor,
        virtual clock, and the fingerprint of the event plan's consumed
        prefix (``server.async_schedule.plan_fingerprint``)."""
        host = {
            "kind": "async",
            "current_event": event,
            "n_clients": n_clients,
            "history": list(history),
            "plan_fingerprint": plan_fingerprint,
            "virtual_time_s": float(virtual_time_s),
        }
        kwargs = dict(
            trees=dict(trees),
            host=host,
            snapshotters={"history": DataclassListSnapshotter()},
            extra_meta={"round": event, "kind": "async"},
        )
        if writer is not None:
            writer.submit(self.save, **kwargs)
        else:
            self.save(**kwargs)

    def save_cohort_snapshot(
        self, trees, current_round: int, slots: int, registry_size: int,
        registry_rows: dict, history, writer=None,
    ) -> None:
        """Persist a cohort-slot snapshot: the [slots]-shaped server/client
        state trees PLUS the registry's dirty rows (``ClientRegistry.
        export_rows``) — every participated client's persistent
        ``TrainState`` and strategy rows, keyed by the registry ids stored
        in the frame header. ``n_clients`` in the header is the SLOT count
        (the restore template's shape); ``registry_size`` binds the frame
        to its client population.

        Both cohort dispatch routes write this same frame: the pipelined
        path at its per-round cadence, the chunked path at chunk
        boundaries (the chunk length IS ``checkpoint_every``, so every
        due round is a boundary and the window has already been scattered
        back into the registry when the snapshot is taken). A frame is
        therefore route-agnostic — a run saved pipelined may resume
        chunked and vice versa, and the resumed trajectory stays
        bit-identical because both routes draw round ``r``'s cohort from
        the same ``fold_in(seed, 2000+r)`` stream."""
        trees = dict(trees)
        c_ids = registry_rows.get("client_ids")
        s_ids = registry_rows.get("strategy_ids")
        if registry_rows.get("client_rows") is not None:
            trees["registry_client_rows"] = registry_rows["client_rows"]
        if registry_rows.get("strategy_rows") is not None:
            trees["registry_strategy_rows"] = registry_rows["strategy_rows"]
        host = {
            "kind": "cohort",
            "current_round": current_round,
            "n_clients": slots,
            "registry_size": registry_size,
            "registry_client_ids": [
                int(i) for i in (c_ids if c_ids is not None else ())
            ],
            "registry_strategy_ids": [
                int(i) for i in (s_ids if s_ids is not None else ())
            ],
            "history": list(history),
        }
        kwargs = dict(
            trees=trees,
            host=host,
            snapshotters={"history": DataclassListSnapshotter()},
            extra_meta={"round": current_round, "kind": "cohort"},
        )
        if writer is not None:
            writer.submit(self.save, **kwargs)
        else:
            self.save(**kwargs)

    def load_cohort_simulation(self, sim) -> int:
        """Restore a cohort-slot run: slot states adopt onto the live
        simulation (onto its device, like the sync path) and the registry's
        dirty rows — sized from the header's id lists — reload into the
        sparse stores, so every participated client resumes from its last
        persisted row. Returns the next round to run (1-based)."""
        header, _meta, blob, info = self._read()
        kind = header.get("kind") or "sync"
        if kind != "cohort":
            raise ValueError(
                f"checkpoint {info.path} was written by a {kind} run; a "
                "cohort-slot simulation can only resume cohort frames "
                "(they carry the registry's dirty rows)"
            )
        if header["n_clients"] != sim.n_clients:
            raise ValueError(
                f"checkpoint has {header['n_clients']} cohort slots, run "
                f"has {sim.n_clients}"
            )
        if header.get("registry_size") != sim.registry_size:
            raise ValueError(
                f"checkpoint registry holds {header.get('registry_size')} "
                f"clients, run's registry holds {sim.registry_size}"
            )
        self._check_config(info, sim)
        c_ids = header.get("registry_client_ids") or []
        s_ids = header.get("registry_strategy_ids") or []
        templates = {
            "server_state": sim.server_state,
            "client_states": sim.client_states,
        }
        row_templates = sim.registry.row_templates(len(c_ids), len(s_ids))
        if "client_rows" in row_templates:
            templates["registry_client_rows"] = row_templates["client_rows"]
        if "strategy_rows" in row_templates:
            templates["registry_strategy_rows"] = (
                row_templates["strategy_rows"]
            )
        trees = serialization.from_bytes(templates, blob)
        sim.adopt_restored_state(trees["server_state"],
                                 trees["client_states"])
        sim.registry.load_rows(
            c_ids, trees.get("registry_client_rows"),
            s_ids, trees.get("registry_strategy_rows"),
        )
        sim.history = DataclassListSnapshotter().load(
            header.get("history"), self._history_template()
        )
        self.last_restore_info = info
        return int(header["current_round"]) + 1

    def _history_template(self):
        from fl4health_tpu_torch.server.simulation import RoundRecord

        # one template record keeps LEGACY payloads (bare row lists with no
        # stored class name) restoring real RoundRecords
        return [RoundRecord(0, {}, {}, {}, {}, 0.0, 0.0)]

    def load_simulation(self, sim) -> int:
        """Restore in place; returns the next round to run (1-based).
        Header facts (kind/cohort/config binding) are validated BEFORE the
        array blob deserializes, so a wrong-experiment restore fails with
        its real reason, never a tree-structure error. The restored host
        arrays go onto the simulation's device (``sim.adopt_restored_state``)."""
        header, _meta, blob, info = self._read()
        kind = header.get("kind") or "sync"
        if kind == "async":
            raise ValueError(
                f"checkpoint {info.path} was written by a buffered-async "
                "run (it carries a pending update buffer); resume it with "
                "the same async_config instead"
            )
        if kind != "sync":
            raise ValueError(
                f"checkpoint {info.path} was written by a {kind} run (its "
                "frame carries extra state — registry rows); resume it "
                "with the matching cohort configuration instead"
            )
        if header["n_clients"] != sim.n_clients:
            raise ValueError(
                f"checkpoint has {header['n_clients']} clients, run has "
                f"{sim.n_clients}"
            )
        self._check_config(info, sim)
        trees = serialization.from_bytes(
            {"server_state": sim.server_state,
             "client_states": sim.client_states},
            blob,
        )
        sim.adopt_restored_state(trees["server_state"],
                                 trees["client_states"])
        sim.history = DataclassListSnapshotter().load(
            header.get("history"), self._history_template()
        )
        self.last_restore_info = info
        return int(header["current_round"]) + 1

    def load_async_simulation(self, sim, pending_template, plan) -> int:
        """Restore a buffered-async run mid-plan; returns the next EVENT to
        run (1-based). Verifies the stored plan-prefix fingerprint against
        the (re-derived) static event plan, so splicing restored state into
        a *different* arrival schedule fails loudly instead of silently
        de-synchronizing staleness accounting."""
        from fl4health_tpu_torch.server.async_schedule import plan_fingerprint

        header, _meta, blob, info = self._read()
        if (header.get("kind") or "sync") != "async":
            raise ValueError(
                f"checkpoint {info.path} was written by a synchronous run "
                "(no pending update buffer); resume it without async_config"
            )
        if header["n_clients"] != sim.n_clients:
            raise ValueError(
                f"checkpoint has {header['n_clients']} clients, run has "
                f"{sim.n_clients}"
            )
        self._check_config(info, sim)
        event = int(header["current_event"])
        if event > plan.n_events:
            raise ValueError(
                f"checkpoint is at event {event} but the resumed plan has "
                f"only {plan.n_events} events; fit() at least {event} rounds"
            )
        expected_fp = plan_fingerprint(plan, event)
        if (header.get("plan_fingerprint")
                and header["plan_fingerprint"] != expected_fp):
            raise ValueError(
                f"checkpoint {info.path} was written under a different "
                "async event plan (fingerprint mismatch over the first "
                f"{event} events) — the AsyncConfig seed, FaultPlan, cohort "
                "and buffer_size must match the interrupted run for the "
                "buffered updates to resume bit-identically"
            )
        trees = serialization.from_bytes(
            {"server_state": sim.server_state,
             "client_states": sim.client_states,
             "pending": pending_template},
            blob,
        )
        sim.adopt_restored_state(
            trees["server_state"], trees["client_states"],
            pending=trees["pending"],
        )
        sim.history = DataclassListSnapshotter().load(
            header.get("history"), self._history_template()
        )
        self.last_restore_info = info
        return event + 1

    def _check_config(self, info: RestoreInfo, sim) -> None:
        stored = info.meta.get("config_hash")
        current = self.config_hash
        if current is None:
            current = sim._resume_config_hash()
        if stored is not None and current is not None and stored != current:
            raise CheckpointConfigMismatchError(info.path, stored, current)
