"""In-graph client quarantine (counterpart of
``fl4health_tpu/resilience/quarantine.py``): strike and probation state
carried in server state and updated inside ``Strategy.aggregate``, so it
works the same on the pipelined and the chunked routes.

A watchdog on the host sees round ``r``'s telemetry only after the chunked
route has already aggregated round ``r + 1``; so quarantine lives where
aggregation lives, as a ``[clients]`` mask in server state. Masking an
offender changes no shape.

- :class:`QuarantineState` rides in the strategy's server state: the
  ``quarantined`` mask, per-client ``strikes``, the probation countdown
  (``release_in``) and a dead-update streak, all ``[C]`` f32;
- :func:`quarantine_step` folds one round's signals (per-client
  non-finite counts, update norms) into that state under a
  :class:`QuarantinePolicy`: an offense is a strike, enough strikes
  quarantine, ``quarantine_rounds`` of probation release; tensor ops only
  (no ``.item()``, no host sync);
- :class:`QuarantiningStrategy` wraps any strategy: it zeroes quarantined
  clients out of the aggregation mask (the inner strategy sees them as
  unsampled), derives the signals from the round's own packets and
  losses, and steps the state.

``FederatedSimulation`` brings the mask to the host (a copy riding the
round's pull on the pipelined route, stacked a round at a time on the
chunked one) for the ``fl_quarantine_*`` metrics, the ``quarantine``
JSONL events, the fleet ledger and the flight recorder's entry.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.observability import telemetry as telem
from fl4health_tpu_torch.parallel.compat import client_all
from fl4health_tpu_torch.strategies.base import FitResults, Strategy


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class QuarantineState:
    """Per-client quarantine bookkeeping, every field ``[clients]`` f32."""

    quarantined: torch.Tensor  # 1.0 = masked out of aggregation
    strikes: torch.Tensor      # consecutive offense count while healthy
    release_in: torch.Tensor   # probation rounds remaining while quarantined
    dead_streak: torch.Tensor  # consecutive near-zero-update participations


def init_quarantine(n_clients: int, device: torch.device | str | None = None) -> QuarantineState:
    def z():
        return torch.zeros((n_clients,), dtype=torch.float32, device=device)

    return QuarantineState(quarantined=z(), strikes=z(), release_in=z(), dead_streak=z())


@dataclasses.dataclass(frozen=True)
class QuarantinePolicy:
    """Static thresholds of the quarantine step.

    - ``on_nonfinite``: a participating client whose packet or losses
      contain NaN/Inf commits an offense (the poisoned-update signal);
    - ``norm_outlier_ratio`` > 0 enables: an update norm beyond that
      multiple of the healthy cohort's median is an offense (the scaled or
      sign-flipped update proxy; needs param-shaped packets);
    - ``dead_norm`` >= 0 enables: an update norm at or below it for
      ``dead_rounds`` consecutive participations is an offense (a client
      pushing the pulled model straight back);
    - ``strikes_to_quarantine`` consecutive offenses trigger quarantine;
      an offense-free participation clears the strike count;
    - ``quarantine_rounds`` of probation later the client is released with
      a clean record; re-offending re-quarantines it.
    """

    on_nonfinite: bool = True
    norm_outlier_ratio: float = 0.0
    dead_norm: float = -1.0
    dead_rounds: int = 3
    strikes_to_quarantine: int = 1
    quarantine_rounds: int = 5

    def __post_init__(self):
        if self.strikes_to_quarantine < 1:
            raise ValueError("strikes_to_quarantine must be >= 1")
        if self.quarantine_rounds < 1:
            raise ValueError("quarantine_rounds must be >= 1")
        if self.dead_rounds < 1:
            raise ValueError("dead_rounds must be >= 1")


def _masked_median(values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Median of ``values`` where ``keep``: the mean of the order statistics
    at ``(k-1)//2`` and ``k//2`` of the kept values, the rest padded with
    +inf past them (``torch.median`` would return the lower middle value).
    ``k = 0`` gives +inf. No host sync: ``k`` stays on the device."""
    v = torch.where(keep, values, torch.full_like(values, float("inf")))
    s = torch.sort(v).values
    k = keep.sum()
    lo = torch.clamp(torch.div(k - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(k, 2, rounding_mode="floor"), min=0)
    return 0.5 * (s[lo] + s[hi])


def quarantine_step(
    q: QuarantineState,
    policy: QuarantinePolicy,
    *,
    mask: torch.Tensor,
    nonfinite: torch.Tensor,
    update_norm: torch.Tensor,
) -> QuarantineState:
    """One round of strike, quarantine and probation bookkeeping.

    ``mask`` is the round's sampled participation (before quarantine):
    only healthy sampled clients are judged, quarantined ones only serve
    probation. ``update_norm`` may be all NaN when the packets give no norm
    signal; the norm-driven checks then never fire."""
    part = (mask > 0) & (q.quarantined < 0.5)
    finite_norm = torch.isfinite(update_norm)

    offense = torch.zeros_like(part)
    if policy.on_nonfinite:
        offense = offense | (part & (nonfinite > 0))
    if policy.norm_outlier_ratio > 0:
        healthy = part & finite_norm
        # the median over every client (under a mesh, the gathered [C] rows)
        all_healthy = client_all(healthy)
        med = _masked_median(client_all(update_norm), all_healthy)
        outlier = (part & finite_norm
                   & (update_norm > policy.norm_outlier_ratio * torch.clamp(med, min=1e-12)))
        # a median needs a cohort: with < 3 healthy norms "outlier" is noise
        offense = offense | (outlier & (all_healthy.sum() >= 3) & torch.isfinite(med))

    zero = torch.zeros_like(q.strikes)
    dead_streak = q.dead_streak
    if policy.dead_norm >= 0:
        is_dead = part & finite_norm & (update_norm <= policy.dead_norm)
        dead_streak = torch.where(part, torch.where(is_dead, dead_streak + 1.0, zero),
                                  dead_streak)
        tripped = dead_streak >= policy.dead_rounds
        offense = offense | (part & tripped)
        dead_streak = torch.where(tripped, zero, dead_streak)

    strikes = torch.where(part, torch.where(offense, q.strikes + 1.0, zero), q.strikes)

    # probation countdown first, then release, then (re-)entries: a client
    # released this round can re-enter on a fresh offense next round, never
    # this one (its strikes were cleared on entry)
    release_in = torch.where(q.quarantined > 0, torch.clamp(q.release_in - 1.0, min=0.0),
                             q.release_in)
    released = (q.quarantined > 0) & (release_in <= 0)
    quarantined = torch.where(released, zero, q.quarantined)
    strikes = torch.where(released, zero, strikes)
    dead_streak = torch.where(released, zero, dead_streak)

    entering = strikes >= policy.strikes_to_quarantine
    quarantined = torch.where(entering, torch.ones_like(quarantined), quarantined)
    release_in = torch.where(entering, torch.full_like(release_in,
                                                       float(policy.quarantine_rounds)),
                             release_in)
    strikes = torch.where(entering, zero, strikes)

    return QuarantineState(quarantined=quarantined, strikes=strikes,
                           release_in=release_in, dead_streak=dead_streak)


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class QuarantineServerState:
    """The wrapper's server state: the inner strategy's state and the
    quarantine bookkeeping."""

    inner: Any
    quarantine: QuarantineState


def _same_structure(a: Any, b: Any) -> bool:
    """Whether two trees have the same containers and keys (JAX's
    ``tree_structure`` equality for the port's trees)."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and list(a) == list(b)
                and all(_same_structure(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    if dataclasses.is_dataclass(a) or dataclasses.is_dataclass(b):
        return (type(a) is type(b)
                and all(_same_structure(getattr(a, f.name), getattr(b, f.name))
                        for f in dataclasses.fields(a)))
    return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)


class QuarantiningStrategy(Strategy):
    """Wrap any strategy with in-graph quarantine.

    Quarantined clients leave the aggregation mask before the inner
    ``aggregate`` runs (the inner strategy treats them as unsampled), and
    the quarantine state steps from signals the round already computes:

    - per-client non-finite counts over the packet stack and train losses;
    - per-client update norm ``||packet - previous_global||`` when the
      packet tree is param-shaped (other packet layouts disable the
      norm-driven checks).

    ``n_clients`` normally comes from ``bind_client_manager`` (the
    simulation calls it before ``init``); pass it for direct use.
    ``quarantine_mask(server_state)`` is the live mask, which the
    simulation brings to the host every round on both routes.
    """

    def __init__(self, inner: Strategy, policy: QuarantinePolicy | None = None,
                 n_clients: int | None = None):
        self.inner = inner
        self.policy = policy or QuarantinePolicy()
        self._n_clients = n_clients
        self.weighted_aggregation = getattr(inner, "weighted_aggregation", True)
        self.weighted_eval_aggregation = getattr(inner, "weighted_eval_aggregation", True)
        # the chunked route's eligibility reads this: only a host-consuming
        # inner update_after_eval keeps a run pipelined
        inner_overrides = getattr(inner, "overrides_update_after_eval", None)
        if inner_overrides is None:
            inner_overrides = (type(inner).update_after_eval
                               is not Strategy.update_after_eval)
        self.overrides_update_after_eval = inner_overrides

    @property
    def evaluate_after_fit(self) -> bool:
        return bool(getattr(self.inner, "evaluate_after_fit", False))

    def bind_client_manager(self, client_manager: Any) -> None:
        self._n_clients = client_manager.n_clients
        self.inner.bind_client_manager(client_manager)

    def init(self, params) -> QuarantineServerState:
        if self._n_clients is None:
            raise ValueError(
                "QuarantiningStrategy needs n_clients: pass it to the "
                "constructor or let FederatedSimulation bind its client "
                "manager first")
        device = next(iter(params.values())).device if params else None
        return QuarantineServerState(inner=self.inner.init(params),
                                     quarantine=init_quarantine(self._n_clients, device))

    def state_sharding_spec(self, server_state: QuarantineServerState,
                            clients_axis: str):
        """The quarantine bookkeeping is all ``[clients]``-shaped: it shards
        over the clients mesh axis; the inner strategy's state follows its
        own spec."""
        from fl4health_tpu_torch.parallel.mesh import P
        from fl4health_tpu_torch.strategies.base import inner_state_sharding_spec

        return QuarantineServerState(
            inner=inner_state_sharding_spec(self.inner, server_state.inner, clients_axis),
            quarantine=P(clients_axis))

    def global_params(self, server_state: QuarantineServerState):
        return self.inner.global_params(server_state.inner)

    def state_rows(self, server_state: QuarantineServerState):
        """The per-client quarantine bookkeeping (all ``[C]``) and the inner
        strategy's rows, for the cohort's registry gather and scatter. Under
        a sampled cohort, probation (``release_in``) counts a client's
        participating rounds, its row stepping only when gathered, not wall
        rounds as on the dense routes."""
        return {"quarantine": server_state.quarantine,
                "inner": self.inner.state_rows(server_state.inner)}

    def scatter_state_rows(self, server_state: QuarantineServerState, rows):
        return QuarantineServerState(
            inner=self.inner.scatter_state_rows(server_state.inner, rows["inner"]),
            quarantine=rows["quarantine"])

    def divergence_reference(self, server_state: QuarantineServerState):
        return self.inner.divergence_reference(server_state.inner)

    def client_payload(self, server_state: QuarantineServerState, round_idx):
        return self.inner.client_payload(server_state.inner, round_idx)

    def quarantine_mask(self, server_state: QuarantineServerState) -> torch.Tensor:
        """[clients] 1.0 = currently quarantined."""
        return server_state.quarantine.quarantined

    def _signals(self, results: FitResults, prev_global):
        """(nonfinite [C], update_norm [C]) from the round's own outputs."""
        mask = results.mask.to(torch.float32)
        try:
            nonfinite = telem.per_client_nonfinite(results.packets)
        except ValueError:  # no float leaves in the packet stack
            nonfinite = torch.zeros_like(mask)
        nonfinite = nonfinite + telem.nonfinite_in_losses(results.train_losses).to(mask.device)
        # packets that are not param-shaped give no norm signal (NaN
        # disables the norm-driven checks)
        if _same_structure(results.packets, prev_global):
            n2 = None
            for leaf, ref in zip(telem._ordered_leaves(results.packets),
                                 telem._ordered_leaves(prev_global)):
                d = leaf.to(torch.float32) - ref.to(torch.float32)[None]
                d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
                s = torch.square(d).reshape(d.shape[0], -1).sum(dim=1)
                n2 = s if n2 is None else n2 + s
            update_norm = torch.sqrt(n2)
        else:
            update_norm = torch.full_like(nonfinite, float("nan"))
        return nonfinite, update_norm

    def aggregate(self, server_state: QuarantineServerState, results: FitResults,
                  round_idx) -> QuarantineServerState:
        prev_global = self.inner.global_params(server_state.inner)
        nonfinite, update_norm = self._signals(results, prev_global)
        healthy_mask = results.mask * (1.0 - server_state.quarantine.quarantined)
        if self.policy.on_nonfinite:
            # a NaN/Inf packet leaves this round's aggregate, not only later
            # ones: caught after the poison lands would be a round late
            healthy_mask = healthy_mask * (1.0 - (nonfinite > 0).to(healthy_mask.dtype))
        new_inner = self.inner.aggregate(
            server_state.inner, dataclasses.replace(results, mask=healthy_mask), round_idx)
        new_q = quarantine_step(server_state.quarantine, self.policy, mask=results.mask,
                                nonfinite=nonfinite, update_norm=update_norm)
        return QuarantineServerState(inner=new_inner, quarantine=new_q)

    def update_after_eval(self, server_state: QuarantineServerState, eval_losses,
                          eval_metrics, mask) -> QuarantineServerState:
        return dataclasses.replace(server_state, inner=self.inner.update_after_eval(
            server_state.inner, eval_losses, eval_metrics, mask))
