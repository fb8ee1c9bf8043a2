"""Stage naming for the aggregation spine (counterpart of
``fl4health_tpu/observability/stages.py``) — ``fl_stage::<name>`` scopes.

ROADMAP item 5 gates every fused-kernel investment on profiles showing
*which* stage of the clip -> quantize -> top-k -> robust-aggregate ->
server-update spine leaves work on the table. A whole-program count cannot
answer that; this module gives each spine stage a name, so the op counter of
``observability/hloscan.py`` can charge each op's flops and bytes to it.

Mechanism: :func:`stage` opens ``torch.profiler.record_function("fl_stage::
<name>")`` (the range a ``torch.profiler`` trace shows, JAX's named scope
in XProf) and pushes the name on its thread's stack, which the counter
reads as each op runs. The counter reads the stack of the thread that
entered it, wherever an op runs: on a card, autograd runs a backward on
its device thread while the dispatching thread waits in the gradient call,
and those ops belong to the stage the waiting thread has open. Both are **metadata only**: they change neither the
math nor what runs, so attribution-on trajectories stay bit-identical to
attribution-off on every route. The scopes are opened on the thread that
dispatches (the producer); they hold inside ``torch.func.vmap`` and
``torch.func.grad``, whose ops run on that thread. Eager autograd runs a
backward where the gradient is asked for, so a scope around the gradient
call holds the backward too (``local_train`` takes every step's gradient
inside it); a scope inside a differentiated function holds its forward
alone, where JAX's name stack would carry it into the backward.

The canonical spine stages (:data:`SPINE_STAGES`), JAX's:

- ``local_train``   — the engine's local steps (clients/engine.py)
- ``dp_clip``       — fused per-example clip+reduce (kernels/dp_clip.py)
- ``rotation``      — randomized-Hadamard encode/decode (compression/codecs.py)
- ``topk``          — global magnitude top-k selection (compression/codecs.py)
- ``quantize``      — stochastic uniform quantization (compression/codecs.py)
- ``robust_aggregate`` — Byzantine-robust combinators (resilience/aggregators.py)
- ``server_update`` — the strategy's aggregate/server step
- ``cohort_exchange`` — the cohort chunk's window gather/scatter
  (server/simulation.py)

Toggle: attribution defaults ON. Set ``FL4HEALTH_STAGE_ATTRIBUTION=0`` in
the environment, call :func:`set_enabled`, or use the :func:`disabled`
context manager to turn the scopes (and the per-stage reports) off.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
from typing import Iterator

# The marker of a stage's profiler range; "::" cannot appear in a module or
# function name the way "/" separators do, so it never collides.
STAGE_PREFIX = "fl_stage::"

# Canonical spine stage names, in pipeline order (the order the roofline
# ledger lists them when headrooms tie).
SPINE_STAGES = (
    "local_train",
    "dp_clip",
    "rotation",
    "topk",
    "quantize",
    "robust_aggregate",
    "server_update",
    "cohort_exchange",
)

# Ops outside any fl_stage scope are charged here (still real work — the
# conservation check needs them on the ledger, never silently dropped).
UNATTRIBUTED = "_unattributed"

_STAGE_RE = re.compile(re.escape(STAGE_PREFIX) + r"([A-Za-z0-9_.\-]+)")

_enabled = os.environ.get("FL4HEALTH_STAGE_ATTRIBUTION", "1") != "0"
# each thread's open stages, by thread id (a thread changes only its own)
_stacks: dict[int, list[str]] = {}


def enabled() -> bool:
    """True when stage scopes are being applied (process-wide toggle)."""
    return _enabled


def set_enabled(on: bool) -> None:
    """Flip stage attribution process-wide, for the scopes opened after the
    call."""
    global _enabled
    _enabled = bool(on)


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Temporarily run without stage scopes (the bit-identity tests' off
    arm)."""
    global _enabled
    prev = _enabled
    _enabled = False
    try:
        yield
    finally:
        _enabled = prev


def current(thread: int | None = None) -> str | None:
    """The innermost stage open on ``thread`` (a ``threading.get_ident()``;
    this thread by default), or None."""
    stack = _stacks.get(threading.get_ident() if thread is None else thread)
    return stack[-1] if stack else None


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Scope a code region as spine stage ``name``: a ``record_function``
    range and an entry on this thread's stage stack. A no-op when
    attribution is disabled. ``torch`` is imported lazily, so tools can
    import this module's parsing helpers without it."""
    if not _enabled:
        yield
        return
    import torch

    ident = threading.get_ident()
    stack = _stacks.setdefault(ident, [])
    stack.append(name)
    try:
        with torch.profiler.record_function(STAGE_PREFIX + name):
            yield
    finally:
        stack.pop()
        if not stack:
            _stacks.pop(ident, None)


def stage_of(op_name: str | None) -> str | None:
    """The spine stage a profiler range or op path belongs to, or None.

    Takes the LAST ``fl_stage::`` component on the path — scopes nest
    (``server_update`` wraps ``robust_aggregate``), and the innermost name
    is the most specific attribution."""
    if not op_name:
        return None
    hits = _STAGE_RE.findall(op_name)
    return hits[-1] if hits else None
