"""Shape bucketing (counterpart of ``fl4health_tpu/sweep/bucketing.py``):
the cells that can share one group's round functions, and the padding that
makes them share it.

A group is the cells with the same strategy, client algorithm, fault plan
and cohort BUCKET (the smallest configured bucket >= the cohort). A cell
pads to its bucket with phantom clients, copies of client 0 with zero
weight in the aggregate, in the sample counts and in eval; the group's
banks pad to its ROW BUDGET (the most padded rows of any of its cells),
and padding rows are never indexed by a valid plan. Everything else
(seeds, partitions, sample counts, hoisted scalars) enters the group's
round functions as inputs.

Fault plans with probabilistic faults draw a ``[n_clients]`` uniform
vector, so padding the cohort would change the draws of real clients:
padded buckets refuse probability < 1 fault plans, and probability < 1
Poisson managers by the same rule. The groups, buckets, budgets and
errors are JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from fl4health_tpu_torch.clients import engine
from fl4health_tpu_torch.core.pytree import tree_map
from fl4health_tpu_torch.sweep.spec import SweepCell, SweepSpec


@dataclasses.dataclass(frozen=True)
class GroupKey:
    """Identity of one shared executable (one program group)."""

    strategy: str
    client: str
    fault: str
    bucket: int

    def label(self) -> str:
        parts = [self.strategy, self.client]
        if self.fault != "none":
            parts.append(self.fault)
        parts.append(f"b{self.bucket}")
        return "/".join(parts)


@dataclasses.dataclass
class SweepGroup:
    key: GroupKey
    cells: list[SweepCell]
    train_row_budget: int = 0
    val_row_budget: int = 0


@dataclasses.dataclass
class SweepPlan:
    """The up-front bucket plan — reported before any compile happens."""

    groups: list[SweepGroup]
    n_cells: int

    @property
    def buckets(self) -> list[int]:
        return sorted({g.key.bucket for g in self.groups})

    def describe(self) -> dict:
        return {
            "cells": self.n_cells,
            "groups": len(self.groups),
            "buckets": self.buckets,
            "group_cells": {g.key.label(): len(g.cells) for g in self.groups},
        }


def _require_padding_safe_fault(fault_plan, fault_name: str,
                                cohort: int, bucket: int) -> None:
    if fault_plan is None or bucket == cohort:
        return
    bad = [
        f for f in getattr(fault_plan, "client_faults", ())
        if getattr(f, "probability", 1.0) < 1.0
    ]
    if bad:
        raise ValueError(
            f"fault plan {fault_name!r} has probabilistic faults "
            f"(probability < 1), whose per-round uniform draw is shaped "
            f"[n_clients] — padding cohort {cohort} to bucket {bucket} "
            "would change the draws for REAL clients and break the "
            "standalone-reproduction contract. Use probability-1 faults "
            "with padded buckets, or give this cohort its own bucket."
        )


def _require_padding_safe_manager(spec: SweepSpec, cell: SweepCell,
                                  bucket: int) -> None:
    """Probability<1 Poisson managers are rejected under padded buckets —
    the fault-plan padding POLICY applied to sampling draws.

    Today the runner draws masks host-side from a manager built over the
    REAL cohort and only zero-pads the result, so padding does not
    actually shift the draws. The rule exists as a contract, not a
    present-day hazard: probabilistic per-client draws are the one
    manager family whose realization is coupled to the population shape,
    and any future in-graph or bucket-shaped sampling (the natural next
    optimization: folding the mask draw into the cell program, exactly
    where the fault plans already live) would silently change REAL
    clients' draws under padding. Rejecting now keeps the axis's
    composability promise identical to the fault plans' and makes that
    refactor non-breaking."""
    if bucket == cell.cohort:
        return
    from fl4health_tpu_torch.server.client_manager import PoissonSamplingManager

    manager = spec.client_managers[cell.manager](cell.cohort)
    if (isinstance(manager, PoissonSamplingManager)
            and manager.fraction < 1.0):
        raise ValueError(
            f"client manager {cell.manager!r} is Poisson with "
            f"probability {manager.fraction} < 1: probabilistic "
            "per-client draws are shape-coupled to the population, and "
            f"padding cohort {cell.cohort} to bucket {bucket} is "
            "excluded by the same rule as probabilistic fault plans "
            "(see bucketing._require_padding_safe_manager). Give this "
            "cohort its own bucket, or use a fixed-fraction manager."
        )


def plan_groups(spec: SweepSpec, cells: list[SweepCell],
                data_for) -> SweepPlan:
    """Group cells into shared-executable buckets and size each group's
    bank row budgets. ``data_for(partitioner, cohort)`` returns the cell's
    (unpadded) datasets — memoized by the caller so each partition is
    materialized once."""
    groups: dict[GroupKey, SweepGroup] = {}
    for cell in cells:
        bucket = spec.bucket_for(cell.cohort)
        _require_padding_safe_fault(
            spec.fault_plans[cell.fault], cell.fault, cell.cohort, bucket
        )
        _require_padding_safe_manager(spec, cell, bucket)
        key = GroupKey(strategy=cell.strategy, client=cell.client,
                       fault=cell.fault, bucket=bucket)
        groups.setdefault(key, SweepGroup(key=key, cells=[])).cells.append(
            cell
        )
    for g in groups.values():
        for cell in g.cells:
            datasets = data_for(cell.partitioner, cell.cohort)
            g.train_row_budget = max(
                g.train_row_budget,
                max(engine.data_rows(d.x_train) for d in datasets),
            )
            g.val_row_budget = max(
                g.val_row_budget,
                max(engine.data_rows(d.x_val) for d in datasets),
            )
    return SweepPlan(groups=list(groups.values()), n_cells=len(cells))


# -- padding helpers --------------------------------------------------------

def pad_datasets(datasets: list, bucket: int) -> list:
    """Pad a cohort to ``bucket`` clients with copies of client 0: phantom
    clients train on real-shaped data (their packets stay finite) but the
    runner gives them zero aggregation weight, zero sample count and zero
    eval count, so they move no real client and not the server state."""
    if len(datasets) >= bucket:
        return list(datasets)
    return list(datasets) + [datasets[0]] * (bucket - len(datasets))


def pad_stack_rows(stack, rows: int):
    """Zero-pad a ``[C, n, ...]`` client-stacked bank (a tensor or a tree of
    them) along the row axis up to the group's row budget. No valid index
    plan selects a padding row, so the gathered batches are the unpadded
    bank's bit for bit."""
    def pad(leaf: torch.Tensor) -> torch.Tensor:
        n = leaf.shape[1]
        if n >= rows:
            return leaf
        return F.pad(leaf, [0, 0] * (leaf.ndim - 2) + [0, rows - n])

    return tree_map(pad, stack)


def padded_mask(mask, bucket: int):
    """Extend a ``[C]`` participation mask (numpy, or a tensor, padded on
    its device) with zeros for phantom clients."""
    c = mask.shape[-1]
    if c >= bucket:
        return mask
    if isinstance(mask, torch.Tensor):
        return F.pad(mask, (0, bucket - c))
    pad = [(0, 0)] * (mask.ndim - 1) + [(0, bucket - c)]
    return np.pad(mask, pad)
