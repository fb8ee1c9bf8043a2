"""Cross-silo trace context (counterpart of
``fl4health_tpu/observability/tracectx.py``): correlate coordinator and
silo spans.

The coordinator (``transport/coordinator.py``) and each silo run in
separate processes with separate tracers (``observability/spans.py``), so
their traces are disjoint timelines. A small context rides inside the RPC
frame header (``transport/codec.py`` adds a ``"trace"`` key beside
``"leaves"``), so a silo's handler spans carry the coordinator's trace id
and round, and both sides emit Chrome flow events under one deterministic
id (``flow_id``: a BLAKE2b hash of the trace id and round, equal in both
packages). ``tools/trace_merge.py`` puts the per-process traces on one
clock and Perfetto draws the arrows broadcast -> silo handler -> reply.

- Byte-stable when unused: ``encode(tree)`` without a trace emits the
  frames it always did.
- Deterministic flow ids: the broadcast frame is encoded once for every
  silo, so the id is per round, not per silo.
- Stdlib only: ids come from ``os.urandom`` (no seeded stream is touched).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Mapping

from fl4health_tpu_torch.observability.spans import get_tracer

__all__ = [
    "TraceContext",
    "flow_id",
    "new_trace_id",
    "traced_handler",
]


def new_trace_id() -> str:
    """A fresh 64-bit trace id as 16 hex chars. ``os.urandom`` keeps the
    simulation's seeded RNG streams untouched."""
    return os.urandom(8).hex()


@dataclass(frozen=True)
class TraceContext:
    """What travels in the frame header: enough to correlate, nothing
    more. ``trace_id`` names the run (one per coordinator process),
    ``span_id`` names the emitting operation, ``round`` the FL round the
    frame belongs to."""

    trace_id: str
    span_id: str
    round: int

    @classmethod
    def fresh(cls, round: int, trace_id: str | None = None) -> "TraceContext":
        return cls(
            trace_id=trace_id if trace_id is not None else new_trace_id(),
            span_id=new_trace_id(),
            round=int(round),
        )

    def child(self) -> "TraceContext":
        """Same trace, new span id — what a handler stamps on its reply."""
        return TraceContext(self.trace_id, new_trace_id(), self.round)

    # -- wire form (JSON-safe dict inside the codec header) --------------
    def to_header(self) -> dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "round": self.round}

    @classmethod
    def from_header(cls, doc: Mapping[str, Any] | None) -> "TraceContext | None":
        """Parse the header dict; tolerant of absent/malformed input
        (an untraced or foreign frame simply yields no context)."""
        if not isinstance(doc, Mapping):
            return None
        try:
            return cls(str(doc["trace_id"]), str(doc["span_id"]),
                       int(doc["round"]))
        except (KeyError, TypeError, ValueError):
            return None


def flow_id(trace_id: str, round: int) -> int:
    """Deterministic Chrome flow-event id for one round of one trace.
    Both sides of the RPC derive the same id from header fields alone, so
    no extra bytes travel on the wire. 63-bit to stay a positive JSON
    int."""
    digest = hashlib.blake2b(
        f"{trace_id}:{round}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") & 0x7FFFFFFFFFFFFFFF


def traced_handler(
    handler: Callable[[bytes], bytes], name: str = "silo_handle"
) -> Callable[[bytes], bytes]:
    """Wrap a silo-side ``bytes -> bytes`` RPC handler (the callable a
    ``LoopbackServer`` serves) so each request runs inside a tracer span
    stamped with the coordinator's trace context, emitting the flow-step
    (``"t"``) event that links the coordinator's broadcast arrow into
    this process's timeline.

    Frames without a trace header (tracer disabled coordinator-side, or
    a non-codec payload) run the handler untraced — the wrapper never
    changes the reply bytes either way."""
    from fl4health_tpu_torch.transport.codec import frame_trace

    def wrapped(data: bytes) -> bytes:
        ctx = TraceContext.from_header(frame_trace(data))
        tracer = get_tracer()
        if ctx is None or not tracer.enabled:
            return handler(data)
        with tracer.span(
            name, cat="transport", trace_id=ctx.trace_id,
            parent_span=ctx.span_id, round=ctx.round,
            request_bytes=len(data),
        ) as sp:
            tracer.flow("t", "rpc_flow", flow_id(ctx.trace_id, ctx.round),
                        round=ctx.round)
            reply = handler(data)
            sp.set(reply_bytes=len(reply))
            return reply

    return wrapped
