"""The crash drill (counterpart of ``fl4health_tpu/resilience/recovery.py``):
a killed and resumed run must reproduce the uninterrupted one.

1. ``run_child`` runs ``fit`` in a real subprocess (its own CUDA context,
   its own file handles: nothing shared with the caller);
2. a :class:`KillPoint` arms a deterministic kill inside the child: after
   round ``r``'s checkpoint publishes (``phase="post_save"``), ``byte_offset``
   bytes into that checkpoint's write (``phase="mid_write"``, the torn
   write), or as round ``r``'s cohort rows would go into the registry
   (``phase="registry_scatter"``). ``os.kill(getpid(), SIGKILL)`` is a true
   SIGKILL: no atexit, no flushing, as a preempted machine dies;
3. a second child resumes from the surviving directory and writes its final
   params (the serializer's bytes) and its loss history;
4. the caller compares those byte for byte against an uninterrupted child's.

``corrupt_newest_generation`` damages the newest ring generation between
kill and resume (truncation or a flipped byte), driving the CRC check and
the fall back to the previous generation.

Child protocol: ``python -m fl4health_tpu_torch.resilience.recovery
spec.json``, the spec naming a factory ``factory_file``/``factory_name``,
``factory(ckpt_dir)`` (or ``factory(ckpt_dir, device=...)`` where the spec
has a ``"device"``) returning a ``FederatedSimulation``. Without the flight
recorder, a ``SIGTERM`` kill point simply ends the child (JAX traps it and
exits 143).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import signal
import subprocess
import sys
from typing import Any

_DONE = "done.json"
_PARAMS = "final_params.msgpack"
_HISTORY = "history.json"


@dataclasses.dataclass(frozen=True)
class KillPoint:
    """Where (and how) the child kills itself: ``round`` is the checkpoint
    save (by its ``round`` or event meta) that arms the kill;
    ``phase="post_save"`` kills right after that save's atomic publish,
    ``phase="mid_write"`` ``byte_offset`` bytes into its file write (the
    previously published generation must survive), and
    ``phase="registry_scatter"`` at the ``round``-th registry scatter of a
    cohort run, before that round's rows and checkpoint persist.
    ``signal_name`` is ``"SIGKILL"`` or ``"SIGTERM"`` (``post_save`` only)."""

    round: int
    phase: str = "post_save"
    byte_offset: int = 64
    signal_name: str = "SIGKILL"

    def __post_init__(self):
        if self.phase not in ("post_save", "mid_write", "registry_scatter"):
            raise ValueError(
                "phase must be 'post_save', 'mid_write' or "
                f"'registry_scatter'; got {self.phase!r}")
        if self.round < 1:
            raise ValueError(f"round must be >= 1; got {self.round}")
        if self.byte_offset < 1:
            raise ValueError(f"byte_offset must be >= 1; got {self.byte_offset}")
        if self.signal_name not in ("SIGKILL", "SIGTERM"):
            raise ValueError(
                f"signal_name must be 'SIGKILL' or 'SIGTERM'; got {self.signal_name!r}")
        if self.phase in ("mid_write", "registry_scatter") and self.signal_name != "SIGKILL":
            raise ValueError(f"{self.phase} drills are SIGKILL-only")

    @property
    def signum(self) -> int:
        return getattr(signal, self.signal_name)


@dataclasses.dataclass
class DrillResult:
    """One child run's artifacts (present only when it exited cleanly);
    ``done`` is its ``done.json``, with the restore's facts (``resume``)."""

    returncode: int
    params_bytes: bytes | None
    history: list[dict] | None
    stdout: str
    stderr: str
    done: dict | None = None

    @property
    def sigkilled(self) -> bool:
        return self.returncode == -signal.SIGKILL


# -- child side --------------------------------------------------------------

class _KillingFile:
    """File proxy that SIGKILLs the process after ``byte_offset`` bytes,
    flushed and synced first, so the torn prefix really is on disk."""

    def __init__(self, f, byte_offset: int):
        self._f = f
        self._remaining = byte_offset

    def write(self, data):
        if len(data) >= self._remaining:
            self._f.write(data[:self._remaining])
            self._f.flush()
            os.fsync(self._f.fileno())
            os.kill(os.getpid(), signal.SIGKILL)
        self._remaining -= len(data)
        return self._f.write(data)

    def __getattr__(self, name):
        return getattr(self._f, name)


def install_kill_hook(checkpointer, kill: KillPoint) -> None:
    """Wrap ``checkpointer.save`` so the configured save dies at the
    configured point, on whichever thread it runs (a SIGKILL takes the
    whole process)."""
    import contextlib

    from fl4health_tpu_torch.checkpointing import state as state_mod

    orig_save = checkpointer.save
    orig_atomic_write = state_mod.atomic_write

    @contextlib.contextmanager
    def killing_atomic_write(path, mode="w"):
        with orig_atomic_write(path, mode) as f:
            yield _KillingFile(f, kill.byte_offset)

    def save(trees, host=None, snapshotters=None, extra_meta=None):
        rnd = (extra_meta or {}).get("round")
        if rnd != kill.round:
            return orig_save(trees, host=host, snapshotters=snapshotters,
                             extra_meta=extra_meta)
        if kill.phase == "mid_write":
            state_mod.atomic_write = killing_atomic_write
            try:
                return orig_save(trees, host=host, snapshotters=snapshotters,
                                 extra_meta=extra_meta)
            finally:  # reached only when the frame is shorter than the offset
                state_mod.atomic_write = orig_atomic_write
        out = orig_save(trees, host=host, snapshotters=snapshotters, extra_meta=extra_meta)
        os.kill(os.getpid(), kill.signum)
        return out

    checkpointer.save = save


def install_scatter_kill_hook(sim, kill: KillPoint) -> None:
    """Arm a ``phase="registry_scatter"`` kill: the ``kill.round``-th
    registry scatter of the run SIGKILLs the process on entry, before that
    round's rows persist and before its checkpoint publishes."""
    if kill.phase != "registry_scatter":
        raise ValueError(
            f"install_scatter_kill_hook needs phase='registry_scatter'; got {kill.phase!r}")
    registry = getattr(sim, "registry", None)
    if registry is None:
        raise RuntimeError(
            "a registry_scatter KillPoint needs cohort-slot execution "
            "(FederatedSimulation(cohort=CohortConfig(...)))")
    orig_scatter = registry.scatter
    calls = {"n": 0}

    def scatter(idx, valid, client_rows, strategy_rows=None):
        calls["n"] += 1
        if calls["n"] == kill.round:
            os.kill(os.getpid(), signal.SIGKILL)
        return orig_scatter(idx, valid, client_rows, strategy_rows)

    registry.scatter = scatter


def _load_factory(factory_file: str, factory_name: str):
    spec = importlib.util.spec_from_file_location("_fl4h_drill_factory", factory_file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, factory_name)


def child_main(spec_path: str) -> int:
    """The drill subprocess: build the sim from the spec's factory, arm the
    kill point, fit, write the artifacts."""
    from fl4health_tpu_torch.checkpointing import serialization
    from fl4health_tpu_torch.checkpointing.checkpointer import nest_params
    from fl4health_tpu_torch.core.io import atomic_write

    with open(spec_path) as f:
        spec = json.load(f)
    factory = _load_factory(spec["factory_file"], spec["factory_name"])
    kwargs = {"device": spec["device"]} if spec.get("device") else {}
    sim = factory(spec.get("ckpt_dir"), **kwargs)
    kill = spec.get("kill")
    if kill:
        kp = KillPoint(**kill)
        if kp.phase == "registry_scatter":
            install_scatter_kill_hook(sim, kp)
        else:
            if sim.state_checkpointer is None:
                raise RuntimeError("a KillPoint needs a state_checkpointer")
            install_kill_hook(sim.state_checkpointer, kp)
    history = sim.fit(int(spec["n_rounds"]))

    out_dir = spec["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    with atomic_write(os.path.join(out_dir, _PARAMS), "wb") as f:
        f.write(serialization.to_bytes(nest_params(sim.global_params)))
    rows = [{"round": rec.round, "fit_loss": rec.fit_losses.get("backward"),
             "eval_loss": rec.eval_losses.get("checkpoint")} for rec in history]
    with atomic_write(os.path.join(out_dir, _HISTORY)) as f:
        json.dump(rows, f)
    with atomic_write(os.path.join(out_dir, _DONE)) as f:
        json.dump({"rounds": len(history), "resume": sim._resume_info}, f)
    return 0


# -- parent side -------------------------------------------------------------

def run_child(spec: dict[str, Any], spec_path: str, timeout_s: float = 600.0) -> DrillResult:
    """Write the spec and run one drill child; returns its artifacts (None
    where the child died before writing them: the killed arm)."""
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    proc = subprocess.run(
        [sys.executable, "-m", "fl4health_tpu_torch.resilience.recovery", spec_path],
        capture_output=True, text=True, timeout=timeout_s, env=dict(os.environ),
        cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    out_dir = spec["out_dir"]
    params = history = done = None
    if os.path.exists(os.path.join(out_dir, _DONE)):
        with open(os.path.join(out_dir, _PARAMS), "rb") as f:
            params = f.read()
        with open(os.path.join(out_dir, _HISTORY)) as f:
            history = json.load(f)
        with open(os.path.join(out_dir, _DONE)) as f:
            done = json.load(f)
    return DrillResult(returncode=proc.returncode, params_bytes=params, history=history,
                       stdout=proc.stdout, stderr=proc.stderr, done=done)


def corrupt_newest_generation(ckpt_dir: str, name: str = "state", *, mode: str = "truncate",
                              keep_bytes: int = 128) -> str:
    """Damage the newest ring generation on disk: ``mode="truncate"`` keeps
    its first ``keep_bytes`` (a torn tail), ``mode="flip"`` flips one
    payload byte (corruption at rest the CRC must catch). Returns the
    damaged path."""
    from fl4health_tpu_torch.checkpointing.state import StateCheckpointer

    cands = StateCheckpointer(ckpt_dir, name).candidate_paths()
    if not cands:
        raise FileNotFoundError(f"no checkpoint generations in {ckpt_dir!r}")
    _gen, path = cands[0]
    with open(path, "rb") as f:
        data = f.read()
    if mode == "truncate":
        damaged = data[:keep_bytes]
    elif mode == "flip":
        i = len(data) // 2
        damaged = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
    else:
        raise ValueError(f"mode must be 'truncate' or 'flip'; got {mode!r}")
    with open(path, "wb") as f:
        f.write(damaged)
    return path


if __name__ == "__main__":
    sys.exit(child_main(sys.argv[1]))
