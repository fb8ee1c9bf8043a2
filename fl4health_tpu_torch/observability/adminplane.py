"""Admin plane (counterpart of ``fl4health_tpu/observability/adminplane.py``,
the same code over the port's ``sweep/hoisting.py``) — live, journaled
retunes of the hoisted scalar registry.

Role: ROADMAP item 3's "operators retune hoisted scalars … through an admin
endpoint next to /metrics//healthz". ``sweep/hoisting.SCALAR_BINDINGS``
names the scalar hyperparameters that live outside the round functions;
this module lets a live run rebind them at the next round boundary with
**no extension build** — the same mechanism the sweep uses per cell, now
driven by an authenticated ``POST /admin/scalars``.

Honesty about what is live-rebindable (``hoisting.live_rebind_kind``):

- state-kind scalars (``server_lr``, ``proximal_weight``) are server-state
  leaves — always rebindable via ``apply_state_scalars``;
- ``staleness_exponent`` is a live dispatch input on async runs — a plain
  ``setattr`` lands at the next event dispatch;
- the remaining attr-kind scalars (trim fraction, top-k endpoints, …) are
  constants of a standalone run's round functions, as JAX bakes them into
  its traces. Those submits are rejected with JAX's structured
  ``static_scalar`` error, so one request gets one answer from both
  packages.

Threading contract: the HTTP handler thread only validates and enqueues
(``submit``); the producer thread drains at each round/event boundary
(``drain``) and applies to the producer-owned server state. Applied retunes
are journaled three ways — an ``admin`` JSONL event, ``fl_admin_*``
instruments, and a manifest descriptor — and ``schedule()`` replays a
journal programmatically so a retuned run stays bit-reproducible from
scratch (the acceptance drill pins this).

No torch at import time; ``sweep.hoisting`` loads lazily on first use.
"""

from __future__ import annotations

import hmac
import threading
import time
from typing import Any, Callable, Mapping

__all__ = ["AdminPlane", "AdminRejection"]

# ``server.simulation.EXEC_CHUNKED``, the chunked route's mode name (a copy:
# the simulation imports this package)
EXEC_CHUNKED = "chunked_scan"


class AdminRejection(Exception):
    """A structured admin-plane refusal, rendered as JSON by the endpoint.

    ``status`` is the HTTP status the handler answers; ``error`` a stable
    machine-readable tag; ``detail`` the operator-facing explanation.
    """

    def __init__(self, status: int, error: str, detail: str):
        super().__init__(detail)
        self.status = int(status)
        self.error = error
        self.detail = detail

    def doc(self) -> dict[str, Any]:
        return {"error": self.error, "detail": self.detail}


def _hoisting():
    from fl4health_tpu_torch.sweep import hoisting
    return hoisting


class AdminPlane:
    """Pending-retune queue between the admin endpoint and the round loop.

    Built only when ``Observability(admin_token=...)`` arms it (off by
    default). ``bind_run`` is called by ``fit()`` once the execution mode is
    chosen; until then every submit is refused with ``no_active_run``.
    """

    AUTH_HEADER = "X-Admin-Token"

    def __init__(self, token: str, registry=None,
                 clock: Callable[[], float] = time.time):
        if not token or not isinstance(token, str):
            raise ValueError(
                "admin_token must be a non-empty shared secret; the admin "
                "plane refuses to start unauthenticated")
        self._token = token
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._pending: dict[str, float] = {}
        self._schedule: dict[int, dict[str, float]] = {}
        self._journal: list[dict[str, Any]] = []
        self._strategy: Any = None
        self._mode: str | None = None
        self._async_active = False

    # ------------------------------------------------------------- lifecycle
    def bind_run(self, strategy, execution_mode: str,
                 async_active: bool = False) -> None:
        """Arm validation against the live run. Clears pending submits from
        any earlier fit (a fresh run must not inherit stale retunes); the
        programmatic ``schedule()`` survives — it IS the replay input."""
        with self._lock:
            self._strategy = strategy
            self._mode = execution_mode
            self._async_active = bool(async_active)
            self._pending.clear()

    # ----------------------------------------------------------------- auth
    def authorize(self, provided: str | None) -> None:
        """Constant-time shared-secret check; raises 401 on mismatch."""
        if provided is None or not hmac.compare_digest(
                provided.encode(), self._token.encode()):
            raise AdminRejection(
                401, "unauthorized",
                f"missing or wrong {self.AUTH_HEADER} header")

    # --------------------------------------------------------------- submits
    def _validate(self, scalars: Mapping[str, Any]) -> dict[str, float]:
        """All-or-nothing validation against the bound run. Returns the
        coerced float dict; raises AdminRejection with a structured error."""
        if not isinstance(scalars, Mapping) or not scalars:
            raise AdminRejection(
                400, "bad_request",
                'body must be a non-empty JSON object of {"scalar": value}')
        if self._strategy is None or self._mode is None:
            raise AdminRejection(
                409, "no_active_run",
                "no fit() is bound to the admin plane yet; retunes apply "
                "only to a live run")
        h = _hoisting()
        if self._mode == EXEC_CHUNKED:
            # chunked_scan dispatches many rounds per call; there is no
            # per-round boundary on the host to apply at.
            raise AdminRejection(
                409, "mid_chunk",
                "this run executes chunked_scan — rounds inside a chunk "
                "have no host-side boundary to retune at; run with "
                "execution_mode='pipelined' for live retunes")
        out: dict[str, float] = {}
        for name, raw in scalars.items():
            try:
                value = float(raw)
            except (TypeError, ValueError):
                raise AdminRejection(
                    400, "bad_request",
                    f"scalar {name!r} value {raw!r} is not a number") from None
            try:
                kind = h.live_rebind_kind(self._strategy, name,
                                          async_active=self._async_active)
            except KeyError:
                raise AdminRejection(
                    400, "unknown_scalar",
                    f"{name!r} is not a registered hoisted scalar; "
                    f"registered: {sorted(h.SCALAR_BINDINGS)}") from None
            if kind == "inapplicable":
                raise AdminRejection(
                    409, "inapplicable_scalar",
                    f"{name!r} has no owner in this run's strategy chain")
            if kind == "static":
                raise AdminRejection(
                    409, "static_scalar",
                    f"{name!r} is an attr-kind scalar baked into the "
                    "compiled round program as a constant on this run; a "
                    "live rebind would silently not take effect — restart "
                    "the run, or explore it through sweep/ (which hoists "
                    "it as a program input)")
            try:
                h.binding(name).check(self._strategy, value)
            except ValueError as e:
                raise AdminRejection(400, "invalid_value", str(e)) from None
            out[name] = value
        return out

    def submit(self, scalars: Mapping[str, Any]) -> dict[str, Any]:
        """Validate and enqueue a retune (HTTP handler thread). Applies at
        the next round boundary the producer reaches."""
        with self._lock:
            values = self._validate(scalars)
            self._pending.update(values)
            accepted = dict(self._pending)
        if self._registry is not None:
            self._registry.counter(
                "fl_admin_requests",
                help="accepted POST /admin/scalars submissions").inc()
        return {"accepted": values, "pending": accepted,
                "applies": "next_round_boundary"}

    def schedule(self, round_idx: int, scalars: Mapping[str, float]) -> None:
        """Programmatic retune at a specific round — the replay mechanism.
        A from-scratch run fed an applied journal via ``schedule()``
        reproduces a live-retuned run bit-exactly."""
        with self._lock:
            slot = self._schedule.setdefault(int(round_idx), {})
            slot.update({str(k): float(v) for k, v in scalars.items()})

    # ------------------------------------------------------------- round loop
    def drain(self, round_idx: int) -> dict[str, float]:
        """Take everything due at this round boundary (producer thread):
        scheduled retunes for this round, overridden by live submits."""
        with self._lock:
            due = dict(self._schedule.pop(int(round_idx), {}))
            due.update(self._pending)
            self._pending.clear()
            return due

    def note_applied(self, round_idx: int, values: Mapping[str, float],
                     source: str = "live") -> dict[str, Any]:
        """Journal an applied retune; returns the journal entry."""
        entry = {"round": int(round_idx),
                 "scalars": {k: float(v) for k, v in values.items()},
                 "source": source, "ts": self._clock()}
        with self._lock:
            self._journal.append(entry)
        reg = self._registry
        if reg is not None:
            reg.log_event("admin", round=entry["round"],
                          scalars=entry["scalars"], source=source)
            reg.counter("fl_admin_retunes",
                        help="scalar retunes applied at round boundaries"
                        ).inc()
            for name, value in entry["scalars"].items():
                reg.gauge("fl_admin_scalar",
                          help="last admin-applied value per hoisted scalar",
                          labels={"scalar": name}).set(value)
        return entry

    # ----------------------------------------------------------------- reads
    def journal(self) -> list[dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._journal]

    def descriptor(self) -> dict[str, Any]:
        """The manifest block disclosing the plane + every applied retune —
        what makes a retuned run replayable from its artifacts."""
        with self._lock:
            return {
                "enabled": True,
                "retunes": [
                    {"round": e["round"], "scalars": dict(e["scalars"]),
                     "source": e["source"]}
                    for e in self._journal
                ],
            }
