"""Hyperparameter sweep and selection, the research harness's role
(counterpart of ``fl4health_tpu/utils/hp_search.py``, a copy).

``sweep(builder, grid, n_rounds, n_seeds)`` runs every config x seed in
process and ranks the configs by the mean selection score.
``find_best_hp_dir`` keeps the file-based contract of sweeps run as
separate jobs: walk a sweep directory of hp folders, each holding
``Run*/*.json`` dumps (``JsonReporter`` or JSONL records), average the last
record's metric over runs and pick the best folder.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

import numpy as np


@dataclasses.dataclass
class HpResult:
    params: dict[str, Any]
    scores: list[float]  # one per seed

    @property
    def mean_score(self) -> float:
        return float(np.mean(self.scores))


def hp_grid(**axes: Sequence[Any]) -> list[dict[str, Any]]:
    """Cartesian product of named axes -> list of hp dicts."""
    names = sorted(axes)
    return [
        dict(zip(names, combo))
        for combo in itertools.product(*(axes[n] for n in names))
    ]


def sweep(
    builder: Callable[..., Any],
    grid: Sequence[Mapping[str, Any]],
    n_rounds: int,
    n_seeds: int = 1,
    score: Callable[[Any], float] | None = None,
    minimize: bool = True,
) -> list[HpResult]:
    """Run every hp dict (x seeds), rank by the mean selection score.

    ``builder(seed=..., **hp)`` returns a FederatedSimulation (or any object
    with ``fit(n_rounds) -> history``); ``score(history)`` defaults to the
    final round's checkpoint eval loss (the reference's weighted-loss
    selection). Results come back sorted best-first.
    """
    if score is None:
        score = lambda history: float(history[-1].eval_losses["checkpoint"])  # noqa: E731
    results = []
    for hp in grid:
        scores = []
        for seed in range(n_seeds):
            sim = builder(seed=seed, **hp)
            history = sim.fit(n_rounds)
            if isinstance(history, tuple):  # DP servers: (history, epsilon)
                history = history[0]
            scores.append(score(history))
        results.append(HpResult(params=dict(hp), scores=scores))
    return sorted(results, key=lambda r: r.mean_score if minimize else -r.mean_score)


def _lookup(record: Mapping[str, Any], dotted: str) -> float | None:
    """Resolve a dotted metric path ("eval_losses.checkpoint") in a record."""
    node: Any = record
    for part in dotted.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return None
        node = node[part]
    try:
        return float(node)
    except (TypeError, ValueError):
        return None


def _final_metric_from_doc(doc: Any, metric: str) -> float | None:
    """Last-record metric from any supported document shape:
    - JsonReporter dump: {"rounds": {"1": {...}, ...}} — last round's record,
      metric as a dotted path (e.g. "eval_losses.checkpoint");
    - a list of flat records (JSONL-style) — last record carrying the metric.
    """
    if isinstance(doc, Mapping) and isinstance(doc.get("rounds"), Mapping):
        rounds = doc["rounds"]
        # non-integer round keys (stray config/summary files swept up by the
        # *.json glob) make the file invalid, not the whole sweep
        int_keys = []
        for key in rounds:
            try:
                int_keys.append((int(key), key))
            except (TypeError, ValueError):
                continue
        for _, key in sorted(int_keys, reverse=True):
            value = _lookup(rounds[key], metric)
            if value is not None:
                return value
        return None
    records = doc if isinstance(doc, list) else [doc]
    for rec in reversed(records):
        value = _lookup(rec, metric)
        if value is not None:
            return value
    return None


def find_best_hp_dir(
    sweep_dir: str | Path,
    metric: str = "eval_losses.checkpoint",
    minimize: bool = True,
) -> tuple[Path | None, float | None]:
    """File-based selection: each hp folder
    holds per-run JSON files — JsonReporter dumps (any name, nested
    {"rounds": ...}; reporting/base.py) or JSONL metric records. The last
    record's ``metric`` (a dotted path) counts per run; the folder with the
    best mean over runs wins."""
    sweep_dir = Path(sweep_dir)
    best_folder, best_score = None, None
    for hp_folder in sorted(p for p in sweep_dir.iterdir() if p.is_dir()):
        run_scores = []
        run_dirs = sorted(hp_folder.glob("Run*")) or [hp_folder]
        for run in run_dirs:
            # ONE score per run: the newest parseable dump wins, so a stale
            # reporter file left beside a re-run's dump cannot double-count
            candidates = sorted(
                run.glob("*.json"), key=lambda f: f.stat().st_mtime,
                reverse=True,
            )
            for metrics_file in candidates:
                text = metrics_file.read_text()
                try:
                    doc = json.loads(text)
                except json.JSONDecodeError:
                    try:
                        doc = [
                            json.loads(line)
                            for line in text.splitlines()
                            if line.strip()
                        ]
                    except json.JSONDecodeError:
                        continue
                value = _final_metric_from_doc(doc, metric)
                if value is not None:
                    run_scores.append(value)
                    break
        if not run_scores:
            continue
        mean = float(np.mean(run_scores))
        better = best_score is None or (
            mean <= best_score if minimize else mean >= best_score
        )
        if better:
            best_folder, best_score = hp_folder, mean
    return best_folder, best_score
