"""SweepRunner: execute a scenario grid through one set of round functions
per program group (counterpart of ``fl4health_tpu/sweep/runner.py``).

1. ``SweepSpec.expand_cells`` materialises the grid and
   ``bucketing.plan_groups`` partitions it into program groups: the cells
   that share one strategy, client algorithm, fault plan and cohort
   bucket, with one row budget for their banks.
2. Each group builds one template :class:`FederatedSimulation` and takes
   its chunked route (``_make_chunked_fit_with_eval``: ``fit_round`` then
   ``eval_round``, round after round, each round's batches gathered from
   the cell's banks by its plan) as the *cell program*, with one host pull
   at the cell's end. What varies between the cells
   (seeds, partitions, sample counts, masks, hoisted scalars) enters as
   inputs; the attr-kind scalars ride one f32 tensor ``hvec`` on the
   simulation's device.
3. Cells run one at a time (``pack=False``) or in packs of up to
   ``max_pack``, dispatched back to back from one call with one pull at the
   pack's end. Eager torch has no compile to amortise, so a pack's inputs
   are not stacked and the remainder pack is not padded (ROADMAP.md C);
   packed and sequential runs are equal bit for bit.

Each cell's trajectory is the port's standalone chunked ``fit`` of the same
configuration, bit for bit up to 32 clients a bucket; above, a padded
cell's aggregate groups its rows in XLA's windows of 32 as JAX's does, so
it parts by ulps (ROADMAP.md C, R11). ``programs_compiled`` counts the port's run-time
compiles around each dispatch, ``kernels/build.py``'s extension builds
(``observability/cudamon.py``): 0 once the extensions are built. The
groups, buckets, cells, labels, ledger, events and metrics are JAX's.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any

import numpy as np
import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.clients import engine
from fl4health_tpu_torch.device import resolve_device
from fl4health_tpu_torch.metrics.base import MetricManager
from fl4health_tpu_torch.observability.cudamon import CompileMonitor
from fl4health_tpu_torch.observability.registry import MetricsRegistry
from fl4health_tpu_torch.server.client_manager import FullParticipationManager
from fl4health_tpu_torch.server.pipeline import HostPull
from fl4health_tpu_torch.server.simulation import (
    ClientDataset,
    FederatedSimulation,
    base_entropy,
)
from fl4health_tpu_torch.sweep import bucketing
from fl4health_tpu_torch.sweep.bucketing import SweepGroup, SweepPlan
from fl4health_tpu_torch.sweep.hoisting import (
    SCALAR_BINDINGS,
    apply_state_scalars,
    bind_traced_scalars,
    binding,
)
from fl4health_tpu_torch.sweep.spec import SweepCell, SweepSpec

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class CellResult:
    """One cell's leaderboard row."""

    cell: SweepCell
    bucket: int
    group: str
    fit_losses: list[float]
    eval_losses: list[float]
    final_fit_loss: float
    final_eval_loss: float
    best_eval_loss: float
    rounds_to_target: int | None
    steps_per_s: float
    wall_s: float
    compiles_attributed: float

    def row(self) -> dict:
        """JSON-able leaderboard row (the ``sweep`` JSONL event body)."""
        return {
            "cell": self.cell.index,
            "label": self.cell.label(),
            "strategy": self.cell.strategy,
            "client": self.cell.client,
            "partitioner": self.cell.partitioner,
            "cohort": self.cell.cohort,
            "bucket": self.bucket,
            "fault": self.cell.fault,
            "manager": self.cell.manager,
            "seed": self.cell.seed,
            "scalars": dict(self.cell.scalars),
            "final_fit_loss": self.final_fit_loss,
            "final_eval_loss": self.final_eval_loss,
            "best_eval_loss": self.best_eval_loss,
            "rounds_to_target": self.rounds_to_target,
            "steps_per_s": self.steps_per_s,
            "wall_s": self.wall_s,
            "compiles_attributed": self.compiles_attributed,
        }


@dataclasses.dataclass
class SweepResult:
    """Everything a leaderboard or a bench block needs.

    ``programs_compiled`` counts the compiles made while the cell programs
    ran (the port's: kernel-extension builds); ``setup_compiles`` those made
    while their inputs were staged, so neither number hides the other."""

    cells: list[CellResult]
    plan: SweepPlan
    programs_compiled: int
    compile_s_total: float
    setup_compiles: int
    setup_compile_s: float
    wall_s: float
    pack: bool
    # cells restored from a completion ledger instead of re-run (resume)
    resumed_cells: int = 0

    @property
    def cells_per_compile(self) -> float | None:
        if self.programs_compiled <= 0:
            return None
        return len(self.cells) / self.programs_compiled

    def leaderboard(self) -> list[CellResult]:
        """Cells sorted best final eval loss first (NaNs last)."""
        def sort_key(r: CellResult):
            v = r.final_eval_loss
            return (not np.isfinite(v), v)
        return sorted(self.cells, key=sort_key)

    def bench_block(self) -> dict:
        """JAX's bench ``sweep`` block: the grid's shape and its compile
        accounting as measured numbers."""
        block = {
            "cells": len(self.cells),
            "buckets": self.plan.buckets,
            "groups": len(self.plan.groups),
            "programs_compiled": self.programs_compiled,
            "compile_s_total": self.compile_s_total,
            "cells_per_compile": self.cells_per_compile,
            "setup_compiles": self.setup_compiles,
            "setup_compile_s": self.setup_compile_s,
            "wall_s": self.wall_s,
            "packed": self.pack,
        }
        if self.resumed_cells:
            # resumed grids only: fresh runs keep the block's old shape
            block["resumed_cells"] = self.resumed_cells
        return block


def _spec_fingerprint(spec: SweepSpec, cells: list[SweepCell]) -> str:
    """The grid identity a completion ledger binds to: the expanded cell
    labels and the per-cell run shape (factories are opaque, so the labels
    are the checkable identity). Equal to JAX's for the same grid."""
    from fl4health_tpu_torch.observability.manifest import config_hash

    return config_hash({
        "cells": [c.label() for c in cells],
        "rounds": spec.rounds,
        "batch_size": spec.batch_size,
        "local_steps": spec.local_steps,
    })


class SweepLedger:
    """Crash-consistent per-cell completion ledger (append-only JSONL), in
    JAX's format: a ``header`` line binds the file to a grid fingerprint,
    then one ``cell`` line per completed cell with its leaderboard row and
    loss trajectories. Each append is flushed and fsynced, so a kill tears
    at most the line being written, and ``load_completed`` skips a torn
    line: a crash costs at most the pack in flight."""

    def __init__(self, path: str, fingerprint: str):
        self.path = path
        self.fingerprint = fingerprint
        self._fh = None

    def load_completed(self) -> dict[int, dict]:
        """{cell index: ledger row} of completed cells. Raises ValueError
        when the ledger belongs to another grid (fingerprint mismatch) or
        carries cell rows with no header to verify them."""
        if not os.path.exists(self.path):
            return {}
        rows: dict[int, dict] = {}
        saw_header = False
        with open(self.path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    # a torn tail from the killed run: its pack runs again
                    logger.warning("%s:%d: skipping torn ledger line", self.path, lineno)
                    continue
                kind = rec.get("kind")
                if kind == "header":
                    if rec.get("spec_hash") != self.fingerprint:
                        raise ValueError(
                            f"sweep ledger {self.path} was written for a "
                            f"different grid (spec_hash "
                            f"{rec.get('spec_hash')} != "
                            f"{self.fingerprint}); point ledger_path at a "
                            "fresh file or delete the stale ledger"
                        )
                    saw_header = True
                elif kind == "cell":
                    rows[int(rec["cell"])] = rec
        if rows and not saw_header:
            raise ValueError(
                f"sweep ledger {self.path} has cell rows but no header — "
                "not a ledger this grid can verify; delete or move it"
            )
        return rows

    def open_for_append(self) -> None:
        write_header = not os.path.exists(self.path) or os.path.getsize(self.path) == 0
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        self._fh = open(self.path, "a")
        if write_header:
            self._write({"kind": "header", "spec_hash": self.fingerprint, "version": 1})

    def append(self, result: CellResult) -> None:
        self._write({"kind": "cell", **result.row(), "fit_losses": result.fit_losses,
                     "eval_losses": result.eval_losses})

    def _write(self, rec: dict) -> None:
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class SweepRunner:
    """Execute a :class:`SweepSpec`; see the module docstring.

    ``observability``: an armed ``Observability``; when enabled the runner
    logs one ``sweep_plan`` event up front, one ``sweep`` event per cell
    and one ``sweep_summary`` event, and sets the ``fl_sweep_*`` metrics.
    The compile accounting uses the runner's own registry and
    ``CompileMonitor`` either way.

    ``ledger_path``: a :class:`SweepLedger` file. Completed cells append to
    it after each pack, and a rerun of the same grid restores them instead
    of running them again.

    ``device``: where the cells run (``"cuda"`` by default; ``"cpu"`` runs
    the plain versions of the kernels).
    """

    def __init__(self, spec: SweepSpec, observability: Any = None,
                 ledger_path: str | None = None, device: str | torch.device = "cuda"):
        self.spec = spec
        self.obs = observability
        self.ledger_path = ledger_path
        self.device = resolve_device(device)
        self._data_cache: dict[tuple[str, int], list[ClientDataset]] = {}
        # staged device banks and eval batches, keyed by everything that
        # shapes them: cells that differ only in seeds or scalars share them
        self._bank_cache: dict[tuple, tuple] = {}

    # -- data ----------------------------------------------------------
    def _data_for(self, partitioner: str, cohort: int) -> list[ClientDataset]:
        key = (partitioner, cohort)
        if key not in self._data_cache:
            datasets = list(self.spec.partitioners[partitioner](cohort))
            if len(datasets) != cohort:
                raise ValueError(
                    f"partitioner {partitioner!r} returned {len(datasets)} "
                    f"datasets for cohort {cohort}"
                )
            self._data_cache[key] = datasets
        return self._data_cache[key]

    # -- group machinery ------------------------------------------------
    def _template_sim(self, group: SweepGroup) -> FederatedSimulation:
        spec, key = self.spec, group.key
        cell0 = group.cells[0]
        datasets = bucketing.pad_datasets(
            self._data_for(cell0.partitioner, cell0.cohort), key.bucket)
        metrics = spec.metrics() if spec.metrics is not None else MetricManager(())
        # no exchanger: the default FullExchanger, as in JAX (ROADMAP.md
        # C, R10: an MR-MTL cell does not keep its personal model)
        return FederatedSimulation(
            logic=spec.clients[key.client](),
            tx=spec.tx(),
            strategy=spec.strategies[key.strategy](),
            datasets=datasets,
            batch_size=spec.batch_size,
            metrics=metrics,
            local_steps=spec.local_steps,
            seed=cell0.seed,
            fault_plan=spec.fault_plans[key.fault],
            device=self.device,
        )

    def _group_hoisted_axes(self, sim: FederatedSimulation) -> list[str]:
        """The attr-kind scalars the group's cell program takes in ``hvec``:
        every applicable one, swept or not (un-swept ones ride at their
        defaults), so the layout belongs to the group."""
        return [name for name, b in SCALAR_BINDINGS.items()
                if b.kind == "attr" and b.applies(sim.strategy)]

    def _build_cell_program(self, sim: FederatedSimulation, hoisted: list[str]):
        """The group's cell program: the template sim's chunked route
        (``_make_chunked_fit_with_eval``) over one cell's inputs, the sample
        counts among them, under the cell's hoisted scalars; so a cell is the
        standalone chunked ``fit``'s rounds by construction."""
        chunk = sim._make_chunked_fit_with_eval()
        strategy = sim.strategy

        def cell_body(cell: dict) -> dict:
            overrides = {name: cell["hvec"][i] for i, name in enumerate(hoisted)}
            with bind_traced_scalars(strategy, overrides):
                return chunk(cell["server_state"], cell["client_states"], cell["x_bank"],
                             cell["y_bank"], cell["idx"], cell["em"], cell["sm"],
                             cell["masks"], 1, cell["val_batches"], cell["val_counts"],
                             sample_counts=cell["sample_counts"])[2]

        return cell_body

    def _staged_banks(self, cell: SweepCell, group: SweepGroup, datasets: list) -> tuple:
        """One cell's banks on the device, its eval batches and count
        vectors, memoised on everything that shapes them (partitioner,
        cohort, bucket, the group's row budgets): a seed or scalar sweep
        reuses them. The cell programs never write their inputs."""
        spec, bucket, device = self.spec, group.key.bucket, self.device
        key = (cell.partitioner, cell.cohort, bucket, group.train_row_budget,
               group.val_row_budget)
        if key in self._bank_cache:
            return self._bank_cache[key]
        stack = engine.pad_and_stack_data
        # the banks, padded to the group's row budgets
        x_bank = bucketing.pad_stack_rows(
            stack([d.x_train for d in datasets], "x_train", device), group.train_row_budget)
        y_bank = bucketing.pad_stack_rows(
            stack([d.y_train for d in datasets], "y_train", device), group.train_row_budget)
        # the val split: one fixed-order pass, padded to the group's val
        # steps with steps of mask 0 (never scored)
        ns_val = [engine.data_rows(d.x_val) for d in datasets]
        v_idx, v_em, v_sm = engine.multi_client_index_plans(
            [[0]] * bucket, ns_val, spec.batch_size, shuffle=False)
        val_steps = -(-group.val_row_budget // spec.batch_size)
        pad_steps = val_steps - v_idx.shape[1]
        if pad_steps > 0:
            v_idx = np.pad(v_idx, ((0, 0), (0, pad_steps), (0, 0)))
            v_em = np.pad(v_em, ((0, 0), (0, pad_steps), (0, 0)))
            v_sm = np.pad(v_sm, ((0, 0), (0, pad_steps)))
        x_val = bucketing.pad_stack_rows(
            stack([d.x_val for d in datasets], "x_val", device), group.val_row_budget)
        y_val = bucketing.pad_stack_rows(
            stack([d.y_val for d in datasets], "y_val", device), group.val_row_budget)
        val_batches = engine.gather_batches(x_val, y_val, v_idx, v_em, v_sm)
        val_counts = np.asarray(ns_val, np.float32)
        sample_counts = np.asarray([d.n_train for d in datasets], np.float32)
        if bucket > cell.cohort:
            # phantom clients: zero aggregation weight, zero eval weight
            val_counts[cell.cohort:] = 0.0
            sample_counts[cell.cohort:] = 0.0
        staged = (x_bank, y_bank, val_batches,
                  engine.host_to_device(val_counts, device),
                  engine.host_to_device(sample_counts, device))
        self._bank_cache[key] = staged
        return staged

    def _cell_inputs(self, sim: FederatedSimulation, group: SweepGroup,
                     cell: SweepCell, hoisted: list[str]) -> dict:
        """One cell's program inputs: the template's states reseeded as a
        standalone construction derives them, the cell's banks and plans,
        its masks and its scalars."""
        spec, bucket = self.spec, group.key.bucket
        datasets = bucketing.pad_datasets(self._data_for(cell.partitioner, cell.cohort),
                                          bucket)
        # every seed-derived field the constructor sets, then its init
        sim.datasets = datasets
        sim.seed = cell.seed
        sim.rng = rng.PRNGKey(cell.seed, sim.device)
        sim._host_rng_of = (sim.rng, sim.rng.cpu())
        sim._base_entropy = base_entropy(cell.seed)
        sim._init_states()
        server_state = apply_state_scalars(
            sim.strategy, sim.server_state,
            {k: v for k, v in cell.scalars if binding(k).kind == "state"})
        (x_bank, y_bank, val_batches, val_counts,
         sample_counts) = self._staged_banks(cell, group, datasets)
        # the train plans, from the standalone fit's entropy
        plans = [sim._round_plan(r) for r in range(1, spec.rounds + 1)]
        idx, em, sm = (engine.host_to_device(np.stack([p[j] for p in plans]).astype(dtype),
                                             sim.device)
                       for j, dtype in enumerate((np.int64, np.float32, np.float32)))
        # participation: the cell's manager (full by default) over the REAL
        # cohort from the standalone run's stream (fold_in(rng, 2000 + r)),
        # zero-padded for phantom clients
        manager = (spec.client_managers[cell.manager](cell.cohort)
                   or FullParticipationManager(cell.cohort))
        if manager.n_clients != cell.cohort:
            raise ValueError(
                f"client manager {cell.manager!r} covers "
                f"{manager.n_clients} clients but the cell's cohort is "
                f"{cell.cohort}; the factory must size the manager from "
                "its cohort argument"
            )
        masks = torch.stack([
            bucketing.padded_mask(
                torch.as_tensor(manager.sample(rng.fold_in(sim.rng, 2000 + r), r),
                                dtype=torch.float32, device=sim.device),
                bucket)
            for r in range(1, spec.rounds + 1)])
        # the hoisted attr scalars: the cell's overrides, else the defaults
        defaults = {name: SCALAR_BINDINGS[name].default(sim.strategy) for name in hoisted}
        overrides = {k: v for k, v in cell.scalars if binding(k).kind == "attr"}
        for k, v in overrides.items():
            binding(k).check(sim.strategy, v)
        hvec = torch.tensor([overrides.get(name, defaults[name]) for name in hoisted],
                            dtype=torch.float32, device=sim.device)
        return {
            "server_state": server_state,
            "client_states": sim.client_states,
            "x_bank": x_bank,
            "y_bank": y_bank,
            "idx": idx,
            "em": em,
            "sm": sm,
            "masks": masks,
            "val_batches": val_batches,
            "val_counts": val_counts,
            "sample_counts": sample_counts,
            "hvec": hvec,
        }

    # -- execution -------------------------------------------------------
    def run(self) -> SweepResult:
        spec = self.spec
        cells = spec.expand_cells()
        plan = bucketing.plan_groups(spec, cells, self._data_for)
        obs = self.obs if (self.obs is not None and getattr(self.obs, "enabled", False)) else None
        # the completion ledger: restore finished cells, run the rest
        ledger: SweepLedger | None = None
        completed: dict[int, dict] = {}
        if self.ledger_path is not None:
            ledger = SweepLedger(self.ledger_path, _spec_fingerprint(spec, cells))
            completed = ledger.load_completed()
        cell_by_index = {c.index: c for c in cells}
        resumed = [self._restore_cell_result(cell_by_index[i], row)
                   for i, row in sorted(completed.items()) if i in cell_by_index]
        if completed:
            logger.info("sweep resume: %d/%d cells restored from %s",
                        len(resumed), len(cells), self.ledger_path)
        if obs is not None:
            # restored cells log their leaderboard events too, so a resumed
            # run's log renders the whole grid
            for r in resumed:
                obs.log_event("sweep", **r.row())
        # private compile accounting: it does not depend on observability
        registry = MetricsRegistry()
        monitor = CompileMonitor(registry).install()
        logger.info("sweep: %d cells -> %d program groups (buckets %s)",
                    plan.n_cells, len(plan.groups), plan.buckets)
        if obs is not None:
            obs.log_event("sweep_plan", **plan.describe(), pack=spec.pack,
                          max_pack=spec.max_pack)
        t_start = time.perf_counter()
        compiles0 = registry.counter("jax_backend_compiles_total").value
        compile_s0 = registry.counter("jax_backend_compiles_seconds_total").value
        results: list[CellResult] = list(resumed)
        dispatch_compiles = 0.0
        dispatch_compile_s = 0.0
        try:
            if ledger is not None:
                ledger.open_for_append()
            for group in plan.groups:
                remaining = [c for c in group.cells if c.index not in completed]
                if not remaining:
                    continue  # the whole group was restored
                if len(remaining) < len(group.cells):
                    group = dataclasses.replace(group, cells=remaining)
                group_results, g_compiles, g_compile_s = self._run_group(
                    group, registry, obs, ledger=ledger)
                results.extend(group_results)
                dispatch_compiles += g_compiles
                dispatch_compile_s += g_compile_s
        finally:
            monitor.uninstall()
            if ledger is not None:
                ledger.close()
        wall_s = time.perf_counter() - t_start
        total_compiles = registry.counter("jax_backend_compiles_total").value - compiles0
        total_compile_s = (registry.counter("jax_backend_compiles_seconds_total").value
                           - compile_s0)
        results.sort(key=lambda r: r.cell.index)
        out = SweepResult(
            cells=results, plan=plan,
            programs_compiled=int(dispatch_compiles),
            compile_s_total=dispatch_compile_s,
            setup_compiles=int(total_compiles - dispatch_compiles),
            setup_compile_s=max(0.0, total_compile_s - dispatch_compile_s),
            wall_s=wall_s, pack=spec.pack,
            resumed_cells=len(resumed),
        )
        if obs is not None:
            obs.log_event("sweep_summary", **out.bench_block())
            reg = obs.registry
            reg.counter(
                "fl_sweep_cells_total",
                help="sweep grid cells executed",
            ).inc(len(results))
            reg.gauge(
                "fl_sweep_programs_compiled",
                help="XLA backend compiles the sweep's cell dispatches "
                     "paid (shared across cells via shape bucketing + "
                     "scalar hoisting)",
            ).set(float(out.programs_compiled))
            if out.cells_per_compile is not None:
                reg.gauge(
                    "fl_sweep_cells_per_compile",
                    help="grid cells amortized per compiled program",
                ).set(float(out.cells_per_compile))
            reg.counter(
                "fl_sweep_compile_seconds_total",
                help="XLA compile seconds of the sweep's cell dispatches",
            ).inc(max(0.0, float(out.compile_s_total)))
            reg.gauge(
                "fl_sweep_wall_seconds",
                help="wall seconds of the whole sweep run",
            ).set(float(out.wall_s))
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_group(self, group: SweepGroup, registry: MetricsRegistry, obs,
                   ledger: SweepLedger | None = None,
                   ) -> tuple[list[CellResult], float, float]:
        """Run one program group: (cell results, compiles and compile
        seconds around its dispatches). Staging a pack's inputs happens
        before its bracket opens; each pack's results append to the ledger
        before the next pack is staged, so a kill reruns only unfinished
        packs."""
        spec = self.spec
        sim = self._template_sim(group)
        hoisted = self._group_hoisted_axes(sim)
        cell_fn = self._build_cell_program(sim, hoisted)
        results: list[CellResult] = []
        t_group = time.perf_counter()
        compiles = registry.counter("jax_backend_compiles_total")
        compile_s = registry.counter("jax_backend_compiles_seconds_total")
        group_compiles = group_compile_s = 0.0

        def finish(cell, cell_outs, wall, attributed):
            r = self._cell_result(group, cell, cell_outs, wall, attributed)
            results.append(r)
            if ledger is not None:
                ledger.append(r)

        # a pack's inputs are staged a pack at a time, not a group at a
        # time: each holds its cell's states. Sequential runs are packs of 1
        size = min(spec.max_pack, len(group.cells)) if spec.pack else 1
        for i in range(0, len(group.cells), size):
            chunk = group.cells[i:i + size]
            inputs = [self._cell_inputs(sim, group, cell, hoisted) for cell in chunk]
            self._sync()
            c0, s0 = compiles.value, compile_s.value
            t0 = time.perf_counter()
            # the pack's cells back to back, then its one pull
            outs = HostPull([cell_fn(cell_in) for cell_in in inputs]).result()
            wall = time.perf_counter() - t0
            del inputs
            pack_compiles = compiles.value - c0
            pack_compile_s = compile_s.value - s0
            group_compiles += pack_compiles
            group_compile_s += pack_compile_s
            # the dispatch's builds go to compile_s_total, not to the walls
            per_cell_wall = max(wall - pack_compile_s, 0.0) / len(chunk)
            for cell, cell_outs in zip(chunk, outs):
                finish(cell, cell_outs, per_cell_wall, pack_compiles / len(chunk))
        if obs is not None:
            for r in results:
                obs.log_event("sweep", **r.row())
        logger.info("sweep group %s: %d cells, %d program compiles, %.2fs",
                    group.key.label(), len(group.cells), int(group_compiles),
                    time.perf_counter() - t_group)
        return results, group_compiles, group_compile_s

    def _restore_cell_result(self, cell: SweepCell, row: dict) -> CellResult:
        """A completed cell's :class:`CellResult` from its ledger row."""
        if row.get("label") != cell.label():
            # the fingerprint should make this unreachable
            raise ValueError(
                f"ledger row for cell {cell.index} is labeled "
                f"{row.get('label')!r} but the grid expands it as "
                f"{cell.label()!r}"
            )
        return CellResult(
            cell=cell,
            bucket=int(row.get("bucket", cell.cohort)),
            group=str(row.get("group", "")),
            fit_losses=[float(v) for v in row.get("fit_losses", [])],
            eval_losses=[float(v) for v in row.get("eval_losses", [])],
            final_fit_loss=float(row.get("final_fit_loss", float("nan"))),
            final_eval_loss=float(row.get("final_eval_loss", float("nan"))),
            best_eval_loss=float(row.get("best_eval_loss", float("nan"))),
            rounds_to_target=row.get("rounds_to_target"),
            steps_per_s=float(row.get("steps_per_s", 0.0)),
            wall_s=float(row.get("wall_s", 0.0)),
            compiles_attributed=float(row.get("compiles_attributed", 0.0)),
        )

    def _cell_result(self, group: SweepGroup, cell: SweepCell, outs: dict,
                     wall: float, compiles_attributed: float) -> CellResult:
        spec = self.spec
        fit_traj = [float(v) for v in np.asarray(outs["fit_losses"]["backward"])]
        eval_traj = [float(v) for v in np.asarray(outs["eval_losses"]["checkpoint"])]
        finite = [v for v in eval_traj if np.isfinite(v)]
        best = min(finite) if finite else float("nan")
        rtt = None
        if spec.target_eval_loss is not None:
            for i, v in enumerate(eval_traj):
                if np.isfinite(v) and v <= spec.target_eval_loss:
                    rtt = i + 1
                    break
        steps = spec.rounds * spec.local_steps * cell.cohort
        return CellResult(
            cell=cell,
            bucket=group.key.bucket,
            group=group.key.label(),
            fit_losses=fit_traj,
            eval_losses=eval_traj,
            final_fit_loss=fit_traj[-1],
            final_eval_loss=eval_traj[-1],
            best_eval_loss=best,
            rounds_to_target=rtt,
            steps_per_s=steps / wall if wall > 0 else 0.0,
            wall_s=wall,
            compiles_attributed=compiles_attributed,
        )


def run_sweep(spec: SweepSpec, observability: Any = None, ledger_path: str | None = None,
              device: str | torch.device = "cuda") -> SweepResult:
    """One-shot ``SweepRunner(spec, observability, ledger_path, device).run()``."""
    return SweepRunner(spec, observability, ledger_path=ledger_path, device=device).run()
