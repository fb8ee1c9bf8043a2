"""Streaming sketches (counterpart of
``fl4health_tpu/observability/sketches.py``, the same numpy code) for
fleet-scale distributions.

The fleet ledger (``observability/fleet.py``) answers per-client
questions; the questions that need a DISTRIBUTION over the whole fleet
("what does the p99 participation gap look like?", "how skewed are the
per-client losses?") must not cost O(registry) host memory in a 1M–10M
client regime (ROADMAP items 1 and 3; FedJAX's stated scale,
arXiv:2108.02117). This module holds the two primitives that keep those
answers registry-size-invariant:

- :class:`QuantileSketch` — a deterministic KLL-style compacting sketch
  (Karnin–Lang–Liberty, arXiv:1603.05346 in spirit; simplified fixed-``k``
  levels). Every level holds at most ``k`` values; a full level sorts,
  keeps alternating survivors (offset flips per compaction — deterministic,
  no RNG so two identical streams produce bit-identical sketches) and
  promotes them one level up at double weight. Memory is
  O(k · log(n / k)); quantile error is a few percent at the default
  ``k=128``, which is diagnostic-grade, not billing-grade.
- :class:`FixedHistogram` — plain fixed-bucket counting (Prometheus
  semantics: cumulative-free bucket counts + a +Inf overflow), for
  distributions whose interesting range is known a priori (bytes,
  staleness in rounds).

Both are JSON-snapshot round-trippable (``snapshot()`` / ``restore()``)
so the fleet ledger can carry them through the checkpoint frame's
host header, and mergeable (``merge()``) so multi-process fleets can be
unioned offline. Pure host-side stdlib + numpy — nothing here touches a
device.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

DEFAULT_K = 128


class QuantileSketch:
    """Deterministic streaming quantile sketch with bounded memory.

    ``add`` is O(1) amortized; ``quantile`` is O(stored · log stored)
    where ``stored ≤ k · levels``. Two sketches fed the same value
    sequence are bit-identical (compaction survivors are chosen by a
    per-level parity counter, never by randomness), which is what lets
    the fleet ledger stay inside the simulation's ledger-on ==
    ledger-off bit-identity pin.
    """

    def __init__(self, k: int = DEFAULT_K):
        if k < 8:
            raise ValueError(f"QuantileSketch k must be >= 8; got {k}")
        self.k = int(k)
        # levels[i] holds values of weight 2**i, unsorted until compaction
        self._levels: list[list[float]] = [[]]
        # per-level compaction parity: which alternation offset survives
        self._parity: list[int] = [0]
        self.count = 0
        self._min = math.inf
        self._max = -math.inf

    def add(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return
        self.count += 1
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        self._levels[0].append(v)
        if len(self._levels[0]) >= self.k:
            self._compact(0)

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.add(v)

    def _compact(self, level: int) -> None:
        while level < len(self._levels) and len(self._levels[level]) >= self.k:
            buf = sorted(self._levels[level])
            offset = self._parity[level] & 1
            self._parity[level] += 1
            survivors = buf[offset::2]
            self._levels[level] = []
            if level + 1 == len(self._levels):
                self._levels.append([])
                self._parity.append(0)
            self._levels[level + 1].extend(survivors)
            level += 1

    def quantile(self, q: float) -> float | None:
        """Approximate ``q``-quantile of everything added so far."""
        if self.count == 0:
            return None
        q = min(1.0, max(0.0, float(q)))
        pairs: list[tuple[float, int]] = []
        for lvl, buf in enumerate(self._levels):
            w = 1 << lvl
            pairs.extend((v, w) for v in buf)
        pairs.sort(key=lambda p: p[0])
        total = sum(w for _, w in pairs)
        target = q * total
        acc = 0
        for v, w in pairs:
            acc += w
            if acc >= target:
                return v
        return pairs[-1][0]

    def quantiles(self, qs: Sequence[float]) -> list[float | None]:
        return [self.quantile(q) for q in qs]

    @property
    def min(self) -> float | None:
        return None if self.count == 0 else self._min

    @property
    def max(self) -> float | None:
        return None if self.count == 0 else self._max

    def stored(self) -> int:
        """Values held right now — the memory bound under test."""
        return sum(len(buf) for buf in self._levels)

    def nbytes(self) -> int:
        return self.stored() * 8 + len(self._levels) * 16 + 64

    def merge(self, other: "QuantileSketch") -> None:
        """Fold ``other`` into this sketch (level-wise union + recompact)."""
        for lvl, buf in enumerate(other._levels):
            while lvl >= len(self._levels):
                self._levels.append([])
                self._parity.append(0)
            self._levels[lvl].extend(buf)
            if len(self._levels[lvl]) >= self.k:
                self._compact(lvl)
        self.count += other.count
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)

    def snapshot(self) -> dict:
        return {
            "k": self.k,
            "count": self.count,
            "min": None if self.count == 0 else self._min,
            "max": None if self.count == 0 else self._max,
            "levels": [list(buf) for buf in self._levels],
            "parity": list(self._parity),
        }

    @classmethod
    def restore(cls, doc: dict) -> "QuantileSketch":
        sk = cls(k=int(doc.get("k", DEFAULT_K)))
        sk.count = int(doc.get("count", 0))
        levels = doc.get("levels") or [[]]
        sk._levels = [[float(v) for v in buf] for buf in levels]
        sk._parity = [int(p) for p in (doc.get("parity") or [0] * len(sk._levels))]
        while len(sk._parity) < len(sk._levels):
            sk._parity.append(0)
        sk._min = math.inf if doc.get("min") is None else float(doc["min"])
        sk._max = -math.inf if doc.get("max") is None else float(doc["max"])
        return sk

    def summary(self) -> dict:
        """The JSON shape the ``/fleet`` endpoint serves for a metric."""
        if self.count == 0:
            return {"count": 0}
        p50, p90, p99 = self.quantiles((0.5, 0.9, 0.99))
        return {
            "count": self.count,
            "min": self._min,
            "max": self._max,
            "p50": p50,
            "p90": p90,
            "p99": p99,
        }


class FixedHistogram:
    """Fixed-bucket histogram: O(buckets) memory, exact counts.

    ``bounds`` are upper bucket edges (ascending); values above the last
    edge land in the +Inf overflow bucket. Counts are exact (unlike the
    sketch) so it suits ranges that are known up front — wire bytes,
    staleness measured in rounds.
    """

    def __init__(self, bounds: Sequence[float]):
        b = [float(x) for x in bounds]
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"histogram bounds must be ascending; got {bounds}")
        self.bounds = b
        self.counts = [0] * (len(b) + 1)  # last = +Inf overflow
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return
        self.counts[self._bucket(v)] += 1
        self.total += 1
        self.sum += v

    def _bucket(self, v: float) -> int:
        # Prometheus "le" semantics: a value equal to an edge belongs to
        # that edge's bucket, so search with bisect_left on the edges.
        for i, edge in enumerate(self.bounds):
            if v <= edge:
                return i
        return len(self.bounds)

    def quantile(self, q: float) -> float | None:
        """Bucket-resolution quantile (upper edge of the target bucket)."""
        if self.total == 0:
            return None
        target = min(1.0, max(0.0, float(q))) * self.total
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self.bounds[i] if i < len(self.bounds) else math.inf
        return math.inf

    def nbytes(self) -> int:
        return (len(self.bounds) + len(self.counts)) * 8 + 64

    def merge(self, other: "FixedHistogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.total += other.total
        self.sum += other.sum

    def snapshot(self) -> dict:
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "total": self.total,
            "sum": self.sum,
        }

    @classmethod
    def restore(cls, doc: dict) -> "FixedHistogram":
        h = cls(doc["bounds"])
        counts = [int(c) for c in doc.get("counts", [])]
        if len(counts) == len(h.counts):
            h.counts = counts
        h.total = int(doc.get("total", 0))
        h.sum = float(doc.get("sum", 0.0))
        return h

    def summary(self) -> dict:
        if self.total == 0:
            return {"count": 0}
        return {
            "count": self.total,
            "mean": self.sum / self.total,
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
        }


def gini(counts: "Sequence[int] | np.ndarray") -> float | None:
    """Gini coefficient of a participation-count vector (0 = perfectly
    even, →1 = one client does everything). Computed over the SEEN
    clients only — never-sampled clients are reported as their own count
    by the ledger, not folded in here (that would make the coefficient
    O(registry) to even define)."""
    arr = np.asarray(counts, dtype=np.float64)
    if arr.size == 0:
        return None
    total = arr.sum()
    if total <= 0:
        return 0.0
    arr = np.sort(arr)
    n = arr.size
    # standard rank formulation: G = (2·Σ i·x_i)/(n·Σ x) − (n+1)/n
    ranks = np.arange(1, n + 1, dtype=np.float64)
    return float((2.0 * (ranks * arr).sum()) / (n * total) - (n + 1.0) / n)
