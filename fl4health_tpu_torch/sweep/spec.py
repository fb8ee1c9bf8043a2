"""SweepSpec, the declarative scenario grid (counterpart of
``fl4health_tpu/sweep/spec.py``; no JAX is imported).

One dataclass names every axis of a {strategy x client algorithm x non-IID
partitioner x cohort size x fault plan x sampling manager x seed x scalar
hyperparameter} grid, as FACTORIES: strategies and logics are stateful
objects, so each program group builds its own. ``expand_cells``
materialises the cartesian product into :class:`SweepCell` rows; a scalar
axis applies only to cells whose strategy chain can rebind it
(``sweep/hoisting.py``) and collapses to one cell where it cannot, so the
grid never sweeps a knob that cannot take effect.

The rules, the cells, their order, their labels and the validation
messages are JAX's:

- ``local_steps`` only: a per-epoch plan takes its step count from each
  partition's size, so the partitioner would shape the round.
- sampling managers are sweepable (``client_managers``): masks are drawn
  from the standalone run's own key stream, so a manager cell reproduces
  ``FederatedSimulation(client_manager=...)``. Probability < 1 Poisson
  managers under a padded bucket are refused
  (``bucketing._require_padding_safe_manager``).
- test splits are not swept (the val split only).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Mapping, Sequence

from fl4health_tpu_torch.sweep.hoisting import SCALAR_BINDINGS, applicable_scalars, binding


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One grid cell — everything needed to reproduce it standalone."""

    index: int
    strategy: str
    client: str
    partitioner: str
    cohort: int
    fault: str
    seed: int
    scalars: tuple[tuple[str, float], ...] = ()
    manager: str = "full"

    @property
    def scalar_dict(self) -> dict[str, float]:
        return dict(self.scalars)

    def label(self) -> str:
        parts = [self.strategy, self.client, self.partitioner,
                 f"c{self.cohort}"]
        if self.fault != "none":
            parts.append(self.fault)
        if self.manager != "full":
            # absent for the default axis value, so pre-manager-axis
            # grids keep their exact labels (and thus ledger fingerprints)
            parts.append(f"m:{self.manager}")
        parts.append(f"s{self.seed}")
        parts += [f"{k}={v:g}" for k, v in self.scalars]
        return "/".join(parts)


@dataclasses.dataclass
class SweepSpec:
    """Declarative grid over the scenario axes.

    ``strategies`` / ``clients``: name -> zero-arg factory returning a
    fresh ``Strategy`` / ``ClientLogic``.
    ``partitioners``: name -> ``f(cohort_size) -> [ClientDataset, ...]``;
    must be deterministic per (name, cohort) — the standalone-reproduction
    contract depends on it.
    ``tx``: zero-arg factory for the client optimizer.
    ``metrics``: zero-arg factory for the ``MetricManager`` (default: no
    metrics).
    ``scalars``: hoisted-scalar axes by registered name
    (``sweep.hoisting.SCALAR_BINDINGS``) -> values; cells whose strategy
    chain lacks the knob collapse to one cell per remaining combo.
    ``client_managers``: sampling-manager axis — name ->
    ``f(cohort_size) -> ClientManager | None`` (None = full
    participation, the default). Masks are drawn host-side from the SAME
    PRNG stream a standalone run with that manager would use
    (``fold_in(rng, 2000 + round)``), so manager cells keep the
    standalone-reproduction contract; the manager never changes program
    shapes, so it composes with bucketing — EXCEPT probability<1 Poisson
    managers under a padded bucket, which are rejected loudly (the
    fault-plan padding policy applied to sampling draws; rationale in
    ``bucketing._require_padding_safe_manager``). The name ``"full"`` is
    reserved for full participation (factory returning None): cell labels
    omit it, keeping pre-axis ledger fingerprints valid.
    ``cohort_buckets``: optional ascending shape buckets; each cell runs
    padded to the smallest bucket >= its cohort (phantom clients are
    zero-weight — pure perf, never semantics). Default: one bucket per
    distinct cohort size (no padding).
    ``pack``: dispatch the cells of a group in packs of up to
    ``max_pack``, back to back from one call with one pull at the pack's
    end (the port's counterpart of JAX's batched scan over cells);
    ``max_pack`` bounds the device memory a pack's inputs hold.
    ``target_eval_loss``: optional leaderboard target for the
    rounds-to-target column.
    """

    strategies: Mapping[str, Callable[[], Any]]
    clients: Mapping[str, Callable[[], Any]]
    partitioners: Mapping[str, Callable[[int], Sequence[Any]]]
    rounds: int
    batch_size: int
    local_steps: int
    tx: Callable[[], Any]
    metrics: Callable[[], Any] | None = None
    seeds: Sequence[int] = (42,)
    cohort_sizes: Sequence[int] = ()
    fault_plans: Mapping[str, Any] = dataclasses.field(
        default_factory=lambda: {"none": None}
    )
    scalars: Mapping[str, Sequence[float]] = dataclasses.field(
        default_factory=dict
    )
    client_managers: Mapping[str, Callable[[int], Any]] = dataclasses.field(
        default_factory=lambda: {"full": lambda cohort: None}
    )
    cohort_buckets: Sequence[int] | None = None
    pack: bool = True
    max_pack: int = 8
    target_eval_loss: float | None = None

    def __post_init__(self):
        for name, m in (("strategies", self.strategies),
                        ("clients", self.clients),
                        ("partitioners", self.partitioners)):
            if not m:
                raise ValueError(f"SweepSpec.{name} must be non-empty")
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1; got {self.rounds}")
        if self.local_steps < 1:
            raise ValueError(
                f"local_steps must be >= 1; got {self.local_steps} "
                "(per-epoch plans are not sweepable: the scan length "
                "would depend on the partition sizes)"
            )
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1; got {self.batch_size}")
        if not self.seeds:
            raise ValueError("SweepSpec.seeds must be non-empty")
        if not self.cohort_sizes:
            raise ValueError(
                "SweepSpec.cohort_sizes must name at least one cohort size"
            )
        if self.max_pack < 1:
            raise ValueError(f"max_pack must be >= 1; got {self.max_pack}")
        if not self.client_managers:
            raise ValueError(
                "SweepSpec.client_managers must be non-empty (use the "
                "default {'full': lambda cohort: None} for full "
                "participation)"
            )
        if "full" in self.client_managers:
            # The NAME "full" is reserved: cell labels omit it (so
            # pre-manager-axis grids keep their exact labels and thus
            # ledger fingerprints), which means a sampling manager hiding
            # behind it would fingerprint-collide with a genuine
            # full-participation grid and restore the wrong trajectories
            # on resume. Probe the factory once to enforce the contract.
            probe = self.client_managers["full"](2)
            if probe is not None:
                raise ValueError(
                    "client_managers name 'full' is reserved for full "
                    "participation (its factory must return None — cell "
                    f"labels omit it); got {type(probe).__name__} — "
                    "register the sampling manager under another name"
                )
        for name in self.scalars:
            binding(name)  # raises with the registered-name list
        if self.cohort_buckets is not None:
            buckets = sorted(self.cohort_buckets)
            if not buckets:
                raise ValueError("cohort_buckets, when given, must be "
                                 "non-empty")
            too_big = [c for c in self.cohort_sizes if c > buckets[-1]]
            if too_big:
                raise ValueError(
                    f"cohort sizes {too_big} exceed the largest bucket "
                    f"{buckets[-1]}; add a bucket that fits them"
                )

    # ------------------------------------------------------------------
    def bucket_for(self, cohort: int) -> int:
        if self.cohort_buckets is None:
            return cohort
        for b in sorted(self.cohort_buckets):
            if b >= cohort:
                return b
        raise AssertionError("validated in __post_init__")

    def applicable_scalar_axes(self) -> dict[str, list[str]]:
        """strategy name -> swept scalar axes its chain can rebind
        (probed on one throwaway instance per strategy factory)."""
        out = {}
        for name, factory in self.strategies.items():
            probe = factory()
            applicable = set(applicable_scalars(probe))
            out[name] = [a for a in SCALAR_BINDINGS if a in self.scalars
                         and a in applicable]
        return out

    def expand_cells(self) -> list[SweepCell]:
        """The grid, deterministic order (strategy-major, seed-minor)."""
        by_strategy = self.applicable_scalar_axes()
        cells: list[SweepCell] = []
        idx = 0
        for strat, client, part, cohort, fault, manager in itertools.product(
            self.strategies, self.clients, self.partitioners,
            self.cohort_sizes, self.fault_plans, self.client_managers,
        ):
            axes = by_strategy[strat]
            combos: list[tuple[tuple[str, float], ...]] = [()]
            if axes:
                combos = [
                    tuple(zip(axes, values))
                    for values in itertools.product(
                        *[self.scalars[a] for a in axes]
                    )
                ]
            for combo, seed in itertools.product(combos, self.seeds):
                cells.append(SweepCell(
                    index=idx, strategy=strat, client=client,
                    partitioner=part, cohort=int(cohort), fault=fault,
                    seed=int(seed), scalars=combo, manager=manager,
                ))
                idx += 1
        return cells
