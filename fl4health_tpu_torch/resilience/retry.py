"""Retry, backoff and circuit-breaking for the cross-silo wire path
(counterpart of ``fl4health_tpu/resilience/retry.py``, a copy of its host
code), which ``transport/coordinator.py`` composes:

- :func:`classify_failure`: map an exception to the ``reason`` label of
  ``transport_rpc_failures_total`` (``timeout`` / ``connection`` /
  ``decode`` / ``circuit_open`` / ``deadline`` / ``other``);
- :class:`RetryPolicy`: bounded attempts with jittered exponential
  backoff plus an optional overall per-silo ``deadline_s`` budget
  (injectable rng/sleep/clock so tests run in microseconds);
- :class:`CircuitBreaker`: per-silo closed/open/half-open gate: after
  ``failure_threshold`` consecutive failures the silo is skipped outright
  until ``reset_after_s`` elapses, then a single probe decides re-close
  vs re-open;
- :func:`call_with_retry`: the attempt loop tying the three together.

Everything here is transport-agnostic host code; the simulation's in-graph
resilience lives in ``resilience/aggregators.py`` and ``quarantine.py``.
"""

from __future__ import annotations

import dataclasses
import random as _pyrandom
import threading
import time
from typing import Any, Callable

REASON_TIMEOUT = "timeout"
REASON_CONNECTION = "connection"
REASON_DECODE = "decode"
REASON_CIRCUIT_OPEN = "circuit_open"
REASON_DEADLINE = "deadline"
REASON_OTHER = "other"


class CircuitOpenError(ConnectionError):
    """Raised instead of dialing when a silo's circuit breaker is open."""


class RetryDeadlineError(TimeoutError):
    """The per-silo retry budget (``RetryPolicy.deadline_s``) ran out
    before the attempts did — further backoff would push the silo past
    the round deadline. Carries the last attempt's failure as
    ``__cause__``; classified as its own ``"deadline"`` reason so a
    metrics page separates "silo kept failing until the budget died"
    from a single hung RPC's ``"timeout"``."""


def classify_failure(exc: BaseException) -> str:
    """Failure-reason label for ``transport_rpc_failures_total``.

    Order matters: ``RetryDeadlineError`` IS a ``TimeoutError`` (and
    ``socket.timeout`` IS ``TimeoutError``/``OSError`` since 3.10), and
    the codec's ``FrameError`` is a ``ValueError`` (checked by family here
    — importing it would cycle resilience <-> transport) — the most
    specific family wins."""
    if isinstance(exc, CircuitOpenError):
        return REASON_CIRCUIT_OPEN
    if isinstance(exc, RetryDeadlineError):
        return REASON_DEADLINE
    if isinstance(exc, TimeoutError):
        return REASON_TIMEOUT
    if isinstance(exc, (ValueError, KeyError, TypeError)):
        # unframe/CRC FrameErrors and template-mismatch decode errors
        return REASON_DECODE
    if isinstance(exc, (ConnectionError, OSError)):
        return REASON_CONNECTION
    return REASON_OTHER


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff over a bounded attempt budget.

    ``timeout_s`` is the per-attempt RPC timeout the coordinator passes to
    the transport ``call`` (a retry policy without a per-attempt timeout
    would let one hung silo eat the whole budget on attempt 1).

    ``deadline_s`` (optional) is the OVERALL per-silo budget across every
    attempt AND backoff sleep: jittered-exponential retries must not push
    a silo past the round deadline, so once the budget is spent — or the
    next backoff would overshoot it — the attempt loop stops and raises
    :class:`RetryDeadlineError` (reason label ``"deadline"``) chaining the
    last real failure. ``None`` (the default) keeps the unbounded legacy
    behavior."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    backoff_factor: float = 2.0
    jitter: float = 0.5
    timeout_s: float = 10.0
    deadline_s: float | None = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        if self.base_delay_s < 0 or self.max_delay_s < self.base_delay_s:
            raise ValueError("need 0 <= base_delay_s <= max_delay_s")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")

    def backoff_s(self, attempt: int, rng: Any = _pyrandom) -> float:
        """Delay before retry ``attempt+1`` (attempt is 0-based). Jitter
        subtracts up to ``jitter`` of the raw delay so a cohort of silos
        failing together doesn't retry in lockstep."""
        raw = min(
            self.base_delay_s * self.backoff_factor ** attempt,
            self.max_delay_s,
        )
        if self.jitter <= 0:
            return raw
        return raw * (1.0 - self.jitter * rng.random())


class CircuitBreaker:
    """Per-silo closed/open/half-open breaker (thread-safe).

    ``failure_threshold`` consecutive failures open the circuit;
    ``allow()`` then refuses until ``reset_after_s`` has elapsed, after
    which ONE caller is admitted as a half-open probe — its success
    re-closes the circuit, its failure re-opens it for another cooldown.
    ``clock`` is injectable so tests never sleep."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_after_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_after_s = reset_after_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probe_out = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at < self.reset_after_s:
                    return False
                self._state = self.HALF_OPEN
                self._probe_out = True
                return True
            # HALF_OPEN: exactly one probe in flight at a time
            if self._probe_out:
                return False
            self._probe_out = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._failures = 0
            self._probe_out = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if (self._state == self.HALF_OPEN
                    or self._failures >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._probe_out = False


def call_with_retry(
    do_call: Callable[[], Any],
    policy: RetryPolicy | None = None,
    breaker: CircuitBreaker | None = None,
    on_failure: Callable[[BaseException, int, bool], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: Any = _pyrandom,
    clock: Callable[[], float] = time.monotonic,
) -> Any:
    """Run ``do_call`` under the retry policy and breaker.

    ``on_failure(exc, attempt, will_retry)`` fires per failed attempt —
    the coordinator uses it to bump the reason-labeled failure counter and
    the retry counter. ``policy=None`` means exactly one attempt (the
    legacy coordinator behavior). A breaker that refuses admission raises
    :class:`CircuitOpenError` without consuming an attempt's wire time.

    With ``policy.deadline_s`` set, the overall budget is enforced across
    attempts and backoff sleeps: when the next backoff would overshoot it
    (or it is already spent), the loop stops and raises
    :class:`RetryDeadlineError` chaining the last real failure —
    ``on_failure`` sees ``will_retry=False`` for that attempt, never a
    retry promise the deadline then breaks. ``clock`` is injectable so
    tests never sleep."""
    attempts = policy.max_attempts if policy is not None else 1
    deadline = policy.deadline_s if policy is not None else None
    t0 = clock() if deadline is not None else 0.0
    last: BaseException | None = None
    for attempt in range(attempts):
        if breaker is not None and not breaker.allow():
            exc: BaseException = CircuitOpenError(
                "circuit breaker open: silo skipped"
            )
            if on_failure is not None:
                on_failure(exc, attempt, False)
            raise exc
        try:
            out = do_call()
        except Exception as e:  # noqa: BLE001 — every wire failure retries
            last = e
            if breaker is not None:
                breaker.record_failure()
            will_retry = attempt + 1 < attempts
            delay = (policy.backoff_s(attempt, rng)
                     if will_retry and policy is not None else 0.0)
            over_deadline = (
                deadline is not None and will_retry
                and clock() - t0 + delay > deadline
            )
            if over_deadline:
                will_retry = False
            if on_failure is not None:
                on_failure(e, attempt, will_retry)
            if over_deadline:
                raise RetryDeadlineError(
                    f"retry deadline_s={deadline} exhausted after "
                    f"{attempt + 1} attempt(s) "
                    f"(last failure: {type(e).__name__}: {e})"
                ) from e
            if will_retry and delay > 0:
                sleep(delay)
            continue
        if breaker is not None:
            breaker.record_success()
        return out
    assert last is not None
    raise last
