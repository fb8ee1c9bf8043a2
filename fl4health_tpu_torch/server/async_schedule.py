"""Buffered-async scheduling (counterpart of
``fl4health_tpu/server/async_schedule.py``, a copy of that pure-numpy
module): the round cadence is set by the arrival rate, not by the slowest
client.

FedBuff (Nguyen et al., arXiv:2106.06639): clients draw deterministic,
seeded compute times on a VIRTUAL clock, the server aggregates as soon as
a buffer of ``K`` updates has arrived, and each update is discounted by
its staleness, the server versions elapsed since its client pulled.

The schedule is resolved to a STATIC EVENT PLAN before any dispatch:
arrival order, staleness and cadence are a pure function of
``(AsyncConfig.seed, FaultPlan, cohort, K)``, a priority-queue simulation
over the virtual clock with no sleeps and no threads. The ``[events,
clients]`` arrival and staleness arrays are plain inputs of the async
event programs (``server/simulation.py``), so the same plan replays bit
for bit on the pipelined and the chunked route. Plans, seatings and
fingerprints equal the JAX package's array for array (the same PCG64
seeds, the same heap tie-break).

Process semantics (one client = one row of the stacked cohort):

- At virtual t=0 every client pulls server version 0 and starts training;
  client ``c``'s attempt on data-plan ``p`` takes
  ``base_compute_s * jitter(seed, c, p) * slow_factor(fault_plan, c, p)``
  virtual seconds (``kind="slow"`` faults, ``resilience/faults.py``).
- Finished updates queue in the server buffer; when the ``K``-th arrives
  the server aggregates those ``K`` (event ``e``, producing version
  ``e``), each discounted by ``1/(1+staleness)^exponent``.
- Consumed clients immediately pull the fresh version and restart; clients
  still training run straight through the event (no barrier).

With ``K = cohort`` and no slow faults every event consumes the whole
cohort at staleness 0: the plan is the synchronous schedule, which is how
the simulation pins ``async == sync`` bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq

import numpy as np
import torch

__all__ = [
    "AsyncConfig",
    "AsyncEventPlan",
    "RegistryEventPlan",
    "build_event_plan",
    "build_registry_event_plan",
    "plan_fingerprint",
    "plan_prefix_fingerprints",
    "staleness_discount",
    "sync_round_times",
]


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Static recipe for the buffered-async mode.

    buffer_size:        K — updates the server buffers before aggregating.
    staleness_exponent: discount ``1/(1+s)^exponent`` (0.5 = the FedBuff
                        paper's ``1/sqrt(1+s)``; 0.0 disables discounting).
    max_staleness:      updates staler than this aggregate with weight 0
                        (still counted/arrived — their client restarts);
                        None = no cap.
    base_compute_s:     nominal virtual compute time of one local-training
                        attempt (the unit every cadence number is in).
    compute_jitter:     per-(client, attempt) multiplicative jitter drawn
                        uniformly from ``[1-j, 1+j]`` — breaks arrival
                        ties so buffer fills are not degenerate lockstep;
                        0.0 keeps every honest client identical.
    seed:               stream for the jitter draws (independent of the
                        FaultPlan seed).
    """

    buffer_size: int
    staleness_exponent: float = 0.5
    max_staleness: int | None = None
    base_compute_s: float = 1.0
    compute_jitter: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.buffer_size < 1:
            raise ValueError(
                f"buffer_size must be >= 1; got {self.buffer_size}"
            )
        if self.staleness_exponent < 0:
            raise ValueError("staleness_exponent must be >= 0")
        if self.max_staleness is not None and self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0 (or None)")
        if not self.base_compute_s > 0:
            raise ValueError("base_compute_s must be > 0")
        if not 0.0 <= self.compute_jitter < 1.0:
            raise ValueError("compute_jitter must be in [0, 1)")

    def describe(self) -> dict:
        """JSON-able identity for the run manifest's config hash."""
        return {
            "buffer_size": self.buffer_size,
            "staleness_exponent": self.staleness_exponent,
            "max_staleness": self.max_staleness,
            "base_compute_s": self.base_compute_s,
            "compute_jitter": self.compute_jitter,
            "seed": self.seed,
        }


@dataclasses.dataclass(frozen=True)
class AsyncEventPlan:
    """The resolved static schedule of one buffered-async run.

    arrivals:    [E, C] float32 — 1.0 where client c's update is consumed
                 at event e (exactly ``buffer_size`` ones per row).
    staleness:   [E, C] float32 — server versions elapsed since the
                 arriving client pulled (0 where not arriving).
    event_times: [E] float64 — virtual wall time of each aggregation; the
                 successive differences ARE the async round cadence.
    """

    arrivals: np.ndarray
    staleness: np.ndarray
    event_times: np.ndarray

    @property
    def n_events(self) -> int:
        return int(self.arrivals.shape[0])

    @property
    def n_clients(self) -> int:
        return int(self.arrivals.shape[1])

    def cadences(self) -> np.ndarray:
        """[E] virtual seconds between consecutive aggregations (event 0
        measured from t=0)."""
        return np.diff(self.event_times, prepend=0.0)

    def summarize_event(self, e: int) -> dict:
        """Host facts about one event for the ``round`` JSONL record."""
        arr = self.arrivals[e] > 0
        stal = self.staleness[e][arr]
        return {
            "async_buffer": int(arr.sum()),
            "staleness_mean": float(stal.mean()) if stal.size else 0.0,
            "staleness_max": float(stal.max()) if stal.size else 0.0,
            "async_virtual_time_s": float(self.event_times[e]),
            "async_cadence_vs": float(self.cadences()[e]),
        }


@dataclasses.dataclass(frozen=True)
class RegistryEventPlan(AsyncEventPlan):
    """An :class:`AsyncEventPlan` whose ``C`` axis is COHORT SLOTS over a
    client registry rather than a fixed dense cohort (server/registry.py).

    The virtual-clock process is identical — slots draw compute times,
    fill the buffer, restart on consume — but each slot is OCCUPIED by a
    registry client, and a consumed slot hands its seat to a fresh client
    drawn deterministically from the currently-unseated pool. ``slot_ids``
    row ``e`` is the occupancy the restart wave of event ``e`` trains
    under (row 0 = the initial occupancy the prologue trains under), so
    the host stages event ``e``'s restart batches for ``slot_ids[e]`` and
    scatters the evicted occupants' rows back to the registry.

    With ``slots == registry_size`` the unseated pool is empty, occupancy
    is the identity forever, and the plan degenerates to the plain
    :class:`AsyncEventPlan` over the full registry — which is how the
    async-over-registry vs sync parity smoke pins the composition.

    slot_ids: [E+1, K] int64 — registry id seated in each slot per wave.
    """

    slot_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), np.int64)
    )


def plan_prefix_fingerprints(plan: AsyncEventPlan) -> list[str]:
    """Per-event prefix digests of a static event plan: entry ``e-1`` is a
    short hash over events ``1..e``'s arrivals, staleness and virtual
    times. A checkpoint written after event ``e`` stores entry ``e-1``, so
    a resume can verify it is splicing state into the SAME arrival
    schedule (AsyncConfig seed / FaultPlan / cohort / buffer_size all feed
    the plan, so any drift changes the digest). Incremental sha256 — one
    pass over the plan for all E prefixes."""
    h = hashlib.sha256()
    out: list[str] = []
    arrivals = np.ascontiguousarray(plan.arrivals, np.float32)
    staleness = np.ascontiguousarray(plan.staleness, np.float32)
    times = np.ascontiguousarray(plan.event_times, np.float64)
    slot_ids = getattr(plan, "slot_ids", None)
    if slot_ids is not None and slot_ids.size:
        slot_ids = np.ascontiguousarray(slot_ids, np.int64)
    else:
        slot_ids = None
    for e in range(plan.n_events):
        h.update(arrivals[e].tobytes())
        h.update(staleness[e].tobytes())
        h.update(times[e].tobytes())
        if slot_ids is not None:
            # registry plans fold the post-event occupancy too: a resume
            # must splice into the same SEATING, not just the same cadence
            h.update(slot_ids[e + 1].tobytes())
        out.append(h.copy().hexdigest()[:16])
    return out


def plan_fingerprint(plan: AsyncEventPlan, n_events: int) -> str:
    """The prefix digest over the first ``n_events`` events (see
    :func:`plan_prefix_fingerprints`); empty-prefix digest for 0."""
    if n_events < 0 or n_events > plan.n_events:
        raise ValueError(
            f"n_events must be in [0, {plan.n_events}]; got {n_events}"
        )
    if n_events == 0:
        return hashlib.sha256().hexdigest()[:16]
    return plan_prefix_fingerprints(plan)[n_events - 1]


def staleness_discount(staleness, exponent=0.5,
                       max_staleness: int | None = None):
    """Aggregation weight for an update ``staleness`` versions old:
    ``1/(1+s)^exponent``, hard-zeroed past ``max_staleness``. Works on
    numpy arrays and on tensors; ``exponent`` may be a tensor scalar (the
    async event programs read it from the live strategy at each dispatch).

    On a tensor it is the f32 rounding of the f64 power, which equals the
    f32 ``pow`` XLA compiles for JAX's ``(1+s)**(-exponent)`` on every
    staleness 0..64 at exponents 0, 0.3, 0.5 and 1, and lies within 1 ulp
    of it elsewhere; ``torch.pow`` in f32 parts from it by 1 ulp even on
    that grid (``tests/test_torch_async_schedule.py``). At ``s = 0`` the
    weight is exactly 1, which keeps a staleness-0 event equal to a
    synchronous round."""
    if isinstance(staleness, torch.Tensor):
        exp = torch.as_tensor(exponent, dtype=torch.float32)
        if exp.ndim:
            exp = exp.to(staleness.device)
        # else a 0-d tensor, which torch reads as a scalar on any device:
        # no copy to the card
        s = staleness.to(torch.float32)
        w = torch.pow(1.0 + s.double(), -exp.double()).to(torch.float32)
        if max_staleness is not None:
            w = w * (s <= max_staleness).to(torch.float32)
        return w
    if isinstance(exponent, (int, float)):
        exponent = float(exponent)
    w = (1.0 + staleness) ** (-exponent)
    if max_staleness is not None:
        w = w * (staleness <= max_staleness)
    return w


def _attempt_times(config: AsyncConfig, n_clients: int, n_plans: int,
                   fault_plan=None) -> np.ndarray:
    """[n_plans, C] virtual compute time of each (data-plan, client)
    training attempt — base x jitter x slow-fault factor. Plan indices are
    1-based (plan p is row p-1), matching the simulation's round plans."""
    times = np.full((n_plans, n_clients), float(config.base_compute_s))
    if config.compute_jitter > 0:
        j = config.compute_jitter
        for p in range(1, n_plans + 1):
            # seeded per (seed, plan), one [C] vector per plan:
            # deterministic across runs/platforms (PCG64) and O(plans)
            # generator constructions — a per-(client, plan) generator
            # would cost seconds of host time at thousands of clients
            rng = np.random.default_rng([config.seed, p])
            times[p - 1] *= rng.uniform(1.0 - j, 1.0 + j, size=n_clients)
    if fault_plan is not None and getattr(fault_plan, "slow_faults", ()):
        for p in range(1, n_plans + 1):
            times[p - 1] *= fault_plan.compute_time_factors(p, n_clients)
    return times


def build_event_plan(
    config: AsyncConfig,
    n_events: int,
    n_clients: int,
    fault_plan=None,
) -> AsyncEventPlan:
    """Simulate the buffered-async process on the virtual clock and return
    the static event plan the async event programs consume.

    Priority-queue over (finish_time, client_id) — ties resolve by client
    id, so the plan is exactly reproducible. Clients consumed at event
    ``e`` restart at the event's time on data plan ``e+1`` (the plan their
    NEXT update trains on), which is what makes the ``K = cohort`` plan
    collapse to the synchronous round schedule."""
    if n_events < 1:
        raise ValueError(f"n_events must be >= 1; got {n_events}")
    if n_clients < 1:
        raise ValueError(f"n_clients must be >= 1; got {n_clients}")
    k = config.buffer_size
    if k > n_clients:
        raise ValueError(
            f"buffer_size={k} exceeds the cohort ({n_clients} clients): "
            "the buffer could never fill"
        )
    # plan indices in play: the prologue trains on plan 1; a restart at
    # event e trains on plan e+1 — so at most n_events+1 plans are drawn
    times = _attempt_times(config, n_clients, n_events + 1, fault_plan)

    arrivals = np.zeros((n_events, n_clients), np.float32)
    staleness = np.zeros((n_events, n_clients), np.float32)
    event_times = np.zeros((n_events,), np.float64)
    pulled = np.zeros((n_clients,), np.int64)  # server version each holds
    heap: list[tuple[float, int]] = [
        (times[0, c], c) for c in range(n_clients)
    ]
    heapq.heapify(heap)
    for e in range(n_events):
        batch = [heapq.heappop(heap) for _ in range(k)]
        t_event = max(t for t, _ in batch)
        event_times[e] = t_event
        for _, c in batch:
            arrivals[e, c] = 1.0
            staleness[e, c] = float(e - pulled[c])
            pulled[c] = e + 1
            heapq.heappush(heap, (t_event + times[e + 1, c], c))
    return AsyncEventPlan(
        arrivals=arrivals, staleness=staleness, event_times=event_times
    )


def build_registry_event_plan(
    config: AsyncConfig,
    n_events: int,
    slots: int,
    registry_size: int,
    fault_plan=None,
) -> RegistryEventPlan:
    """Resolve the buffered-async process over a client REGISTRY: the
    slot-level schedule is exactly :func:`build_event_plan` (same seeds,
    same heap, same cadence — a slot is the unit that draws compute time
    and fills the buffer), plus a deterministic occupancy ledger mapping
    each slot to the registry client seated in it per restart wave.

    Seating rule: slots start occupied by registry ids ``0..K-1``; when a
    slot's update is consumed at event ``e`` it hands the seat to the
    lowest-index draw from the unseated pool (seeded per event by
    ``default_rng([seed, 104729, e])``, without replacement across that
    event's consumed slots, in ascending slot order). When the pool is
    empty (``slots == registry_size``) every occupant keeps its seat and
    the plan degenerates to the dense one. Staleness bookkeeping is
    per-SLOT: the new occupant pulls the fresh server version at the swap,
    so discounting semantics are unchanged."""
    if slots > registry_size:
        raise ValueError(
            f"cohort slots ({slots}) exceed the registry "
            f"({registry_size} clients): every seat needs an occupant"
        )
    base = build_event_plan(config, n_events, slots, fault_plan)
    slot_ids = np.zeros((n_events + 1, slots), np.int64)
    occ = np.arange(slots, dtype=np.int64)
    seated = np.zeros((registry_size,), bool)
    seated[occ] = True
    slot_ids[0] = occ
    for e in range(n_events):
        consumed = np.nonzero(base.arrivals[e] > 0)[0]
        pool = np.nonzero(~seated)[0]
        if pool.size:
            rng = np.random.default_rng([config.seed, 104729, e])
            take = min(pool.size, consumed.size)
            drawn = rng.choice(pool, size=take, replace=False)
            for s, new_id in zip(consumed[:take], drawn):
                seated[occ[s]] = False
                seated[new_id] = True
                occ[s] = new_id
        slot_ids[e + 1] = occ
    return RegistryEventPlan(
        arrivals=base.arrivals, staleness=base.staleness,
        event_times=base.event_times, slot_ids=slot_ids,
    )


def sync_round_times(
    config: AsyncConfig,
    n_rounds: int,
    n_clients: int,
    fault_plan=None,
) -> np.ndarray:
    """[n_rounds] virtual wall time of each SYNCHRONOUS round under the
    same compute-time model — ``max_c T_c(round)``, the barrier cost. The
    bench's sync-vs-async cadence comparison reads both sides from one
    model, so the headline ratio is apples-to-apples by construction."""
    if n_rounds < 1:
        raise ValueError(f"n_rounds must be >= 1; got {n_rounds}")
    times = _attempt_times(config, n_clients, n_rounds, fault_plan)
    return times.max(axis=1)
