"""Cohort-slot execution's client registry (counterpart of
``fl4health_tpu/server/registry.py``): rounds run over a fixed ``[K]`` slot
axis while the client population lives on the host.

- ``CohortConfig``: ``FederatedSimulation(cohort=CohortConfig(slots=K))``
  runs every round's fit and eval over ``K`` slots, whatever the registry's
  size, so device memory and a round's work grow with K, not N.
- ``ClientRegistry``: the host store of per-client data and per-client
  persistent rows, numpy throughout: each client's whole ``TrainState``
  (params, optimizer state, key, a logic's ``extra``) and the strategy's
  per-client server rows (``Strategy.state_rows``/``scatter_state_rows``:
  error-feedback residuals). A client that never took part resolves to one
  shared prototype row, so host memory grows with the clients that took
  part, not with N.
- Data sources: ``ListDataSource`` wraps a list of ``ClientDataset``s;
  ``IndexedPoolSource`` holds one shared example pool and each client's
  row ids into it (``datasets/registry_presets.py``'s Dirichlet presets).

A round samples cohort ids on the host (``ClientManager.sample_indices``);
the registry stages those K clients' batches as ``[K, ...]`` numpy slot
tensors, which the caller copies to the device; the simulation gathers
their rows, runs the slot round, and the round's one pull brings the
updated rows back for ``scatter``. Everything here is numpy: the caller
moves rows to and from the device (``rows_to_device``, ``rows_to_host``).

Determinism, as in JAX: a client's batch plan draws from
``[*base_entropy, 1000 + round, registry_id]`` and its key starts at
``fold_in(init_rng, registry_id + 1)``, the dense path's streams, so
``slots == N`` under full participation reproduces the dense run bit for
bit. A cohort checkpoint stores the rows (``export_rows``, read back by
``row_templates`` and ``load_rows``); ``reset_rows`` drops every stored
row, the registry's half of a rollback to the initial state. Left out
here: the abstract shapes (``abstract_round_args``, ``abstract_chunk_args``,
ROADMAP.md A10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.clients import engine
from fl4health_tpu_torch.clients.engine import Batch
from fl4health_tpu_torch.core.pytree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class CohortConfig:
    """Cohort-slot execution for ``FederatedSimulation``: ``slots`` is the
    fixed slot count K every round runs over. A draw larger than K raises
    ``CohortOverflowError``; a smaller one pads with zero-weight slots.
    ``slots`` equal to the registry size under full participation equals
    the dense path bit for bit."""

    slots: int

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"CohortConfig.slots must be >= 1; got {self.slots}")


# ---------------------------------------------------------------------------
# data sources


class RegistryDataSource:
    """Host data behind a ``ClientRegistry``, addressed by client id:
    ``client_train(i)``/``client_val(i)`` return one client's ``(x, y)``
    numpy trees on demand, and the size vectors need no data. Every client
    shares one per-example shape and dtype."""

    n_clients: int = 0

    def train_sizes(self) -> np.ndarray:
        raise NotImplementedError

    def val_sizes(self) -> np.ndarray:
        raise NotImplementedError

    def client_train(self, i: int) -> tuple[Any, Any]:
        raise NotImplementedError

    def client_val(self, i: int) -> tuple[Any, Any]:
        raise NotImplementedError


class ListDataSource(RegistryDataSource):
    """A list of ``ClientDataset``s as a registry source (small registries;
    large ones use ``IndexedPoolSource``)."""

    def __init__(self, datasets: Sequence[Any]):
        if not datasets:
            raise ValueError("registry needs at least one client dataset")
        self._datasets = list(datasets)
        self.n_clients = len(self._datasets)
        for i, d in enumerate(self._datasets):
            if getattr(d, "x_test", None) is not None or getattr(d, "y_test", None) is not None:
                raise ValueError(
                    f"client {i} has a test split: cohort-slot execution "
                    "evaluates the sampled cohort's val split only (a "
                    "registry-wide test pass would be O(N) per round — "
                    "run it separately on the final global model)")
            for split in ("train", "val"):
                xs, ys = getattr(d, f"x_{split}"), getattr(d, f"y_{split}")
                nx, ny = engine.data_rows(xs), engine.data_rows(ys)
                if nx != ny:
                    raise ValueError(
                        f"client {i}: x_{split} has {nx} rows but "
                        f"y_{split} has {ny}; features and labels must "
                        "pair one-to-one")

    def train_sizes(self) -> np.ndarray:
        return np.asarray([d.n_train for d in self._datasets], np.int64)

    def val_sizes(self) -> np.ndarray:
        return np.asarray([engine.data_rows(d.x_val) for d in self._datasets], np.int64)

    def client_train(self, i: int) -> tuple[Any, Any]:
        d = self._datasets[i]
        return d.x_train, d.y_train

    def client_val(self, i: int) -> tuple[Any, Any]:
        d = self._datasets[i]
        return d.x_val, d.y_val


class IndexedPoolSource(RegistryDataSource):
    """One shared example pool and each client's row ids into it:
    ``train_pool``/``val_pool`` are ``(x, y)`` numpy trees sharing axis 0,
    ``train_indices[i]``/``val_indices[i]`` client i's rows. Memory is the
    pool once plus the index arrays; a client's shard is copied out only
    when it is sampled."""

    def __init__(self, train_pool: tuple[Any, Any], val_pool: tuple[Any, Any],
                 train_indices: Sequence[np.ndarray], val_indices: Sequence[np.ndarray]):
        if len(train_indices) != len(val_indices):
            raise ValueError(
                f"train_indices ({len(train_indices)} clients) and "
                f"val_indices ({len(val_indices)} clients) disagree")
        if not train_indices:
            raise ValueError("registry needs at least one client")
        self._train_pool, self._val_pool = train_pool, val_pool
        self._train_idx = [np.asarray(ix, np.int64) for ix in train_indices]
        self._val_idx = [np.asarray(ix, np.int64) for ix in val_indices]
        self.n_clients = len(self._train_idx)
        for name, pool, idx_list in (("train", train_pool, self._train_idx),
                                     ("val", val_pool, self._val_idx)):
            rows = engine.data_rows(pool[0])
            hi = max((int(ix.max()) for ix in idx_list if ix.size), default=-1)
            if hi >= rows:
                raise ValueError(
                    f"{name}_indices reference row {hi} but the pool has only {rows} rows")
            empty = [i for i, ix in enumerate(idx_list) if ix.size == 0]
            if empty:
                raise ValueError(
                    f"clients {empty[:5]}{'...' if len(empty) > 5 else ''} "
                    f"have empty {name} shards; every registry client "
                    "needs at least one example per split")

    def train_sizes(self) -> np.ndarray:
        return np.asarray([ix.shape[0] for ix in self._train_idx], np.int64)

    def val_sizes(self) -> np.ndarray:
        return np.asarray([ix.shape[0] for ix in self._val_idx], np.int64)

    @staticmethod
    def _take(pool, ix):
        return tree_map(lambda a: np.asarray(a)[ix], pool)

    def client_train(self, i: int) -> tuple[Any, Any]:
        ix = self._train_idx[i]
        return self._take(self._train_pool[0], ix), self._take(self._train_pool[1], ix)

    def client_val(self, i: int) -> tuple[Any, Any]:
        ix = self._val_idx[i]
        return self._take(self._val_pool[0], ix), self._take(self._val_pool[1], ix)


class _Example:
    """Shape and torch dtype of one example of a ``[n, ...]`` data leaf (a
    tree leaf, unlike a tuple)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, a):
        a = np.asarray(a)
        self.shape = tuple(a.shape[1:])
        self.dtype = torch.from_numpy(np.empty((0,), a.dtype)).dtype


def as_registry_source(datasets: Any) -> RegistryDataSource:
    """``FederatedSimulation``'s ``datasets`` under a cohort: a
    ``RegistryDataSource`` as it is, anything else as a ``ListDataSource``."""
    if isinstance(datasets, RegistryDataSource):
        return datasets
    return ListDataSource(list(datasets))


# ---------------------------------------------------------------------------
# host rows


def _unflatten(template: Any, leaves: Sequence[Any]) -> Any:
    """``template``'s tree with its leaves replaced, in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def rows_to_host(tree: Any) -> Any:
    """A tree of tensors as numpy (bf16 widened to f32, exactly)."""
    def host(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    return tree_map(host, tree)


def rows_to_device(tree: Any, dtypes: Any, device: torch.device) -> Any:
    """Numpy rows to ``device`` in the dtypes of ``dtypes`` (a tree of
    ``torch.dtype``s of the same structure); to a card without blocking."""
    return tree_map(lambda a, dt: engine.host_to_device(np.asarray(a), device).to(dt),
                    tree, dtypes)


class _SparseRowStore:
    """A sparse ``[N, ...]`` host row store: flat leaf lists keyed by
    registry id. Clients never stored resolve to the rows the caller
    provides (the prototype), so memory grows with the stored clients."""

    def __init__(self, name: str):
        self.name = name
        self._rows: dict[int, list[np.ndarray]] = {}

    @property
    def dirty(self) -> int:
        return len(self._rows)

    def gather(self, idx: np.ndarray, fresh_rows: Any) -> Any:
        """``fresh_rows`` is the default ``[K, ...]`` tree for these ids;
        stored rows overwrite their slots."""
        out = [np.array(leaf) for leaf in tree_leaves(fresh_rows)]  # writable copies
        for k, cid in enumerate(np.asarray(idx)):
            row = self._rows.get(int(cid))
            if row is not None:
                for j, leaf in enumerate(row):
                    out[j][k] = leaf
        return _unflatten(fresh_rows, out)

    def scatter(self, idx: np.ndarray, rows: Any, valid: int) -> None:
        """Store the first ``valid`` slots' rows under their ids (pad slots
        never persist), each copied out of the ``[K, ...]`` stack."""
        leaves = tree_leaves(rows)
        ids = np.asarray(idx)
        for k in range(int(valid)):
            self._rows[int(ids[k])] = [np.array(leaf[k]) for leaf in leaves]

    def export(self, proto_row: Any) -> tuple[np.ndarray, Any | None]:
        """(sorted stored ids ``[D]``, their rows stacked ``[D, ...]`` in
        ``proto_row``'s structure, or None when nothing is stored): the
        registry's half of a cohort checkpoint."""
        if not self._rows:
            return np.zeros((0,), np.int64), None
        ids = np.asarray(sorted(self._rows), np.int64)
        stacked = [np.stack([self._rows[int(c)][j] for c in ids])
                   for j in range(len(self._rows[int(ids[0])]))]
        return ids, _unflatten(proto_row, stacked)

    @staticmethod
    def stacked_template(proto_row: Any, d: int) -> Any:
        """Zero ``[d, ...]`` rows in ``proto_row``'s structure: what a
        restored frame's rows are read into."""
        return tree_map(lambda leaf: np.zeros((d, *np.shape(leaf)), np.asarray(leaf).dtype),
                        proto_row)

    def load(self, ids: np.ndarray, stacked: Any | None) -> None:
        """Replace the stored rows with ``stacked``'s, under ``ids``."""
        self._rows.clear()
        if stacked is None or len(ids) == 0:
            return
        leaves = tree_leaves(stacked)
        for k, cid in enumerate(np.asarray(ids)):
            self._rows[int(cid)] = [np.array(leaf[k]) for leaf in leaves]


# ---------------------------------------------------------------------------
# the registry


class ClientRegistry:
    """Host registry of per-client data and persistent rows: the fixed slot
    shapes (registry-wide step budgets), the per-round host staging of slot
    tensors, and the sparse row stores the gather/scatter cycle reads and
    writes. Built and driven by ``FederatedSimulation`` under a
    ``CohortConfig``."""

    def __init__(self, source: RegistryDataSource, batch_size: int,
                 local_steps: int | None, local_epochs: int | None):
        self.source = source
        self.n_clients = source.n_clients
        self.batch_size = batch_size
        self.local_steps, self.local_epochs = local_steps, local_epochs
        self.train_sizes = np.asarray(source.train_sizes(), np.int64)
        self.val_sizes = np.asarray(source.val_sizes(), np.int64)
        for name, sizes in (("train", self.train_sizes), ("val", self.val_sizes)):
            if sizes.shape != (self.n_clients,):
                raise ValueError(f"{name}_sizes must be [n_clients]; got {sizes.shape}")
            if (sizes < 1).any():
                raise ValueError(f"every registry client needs >= 1 {name} example")
        # registry-wide fixed step budgets: a round's shapes must not depend
        # on which clients it samples
        steps_per_epoch = -(-int(self.train_sizes.max()) // batch_size)
        self.train_steps = (int(local_steps) if local_steps is not None
                            else int(local_epochs) * steps_per_epoch)
        self.val_steps = -(-int(self.val_sizes.max()) // batch_size)
        self._client_store = _SparseRowStore("client_states")
        self._strategy_store = _SparseRowStore("strategy_rows")
        self._client_proto: Any = None  # one host TrainState row
        self._strategy_proto: Any = None  # one host strategy-row tree
        self.client_dtypes: Any = None  # the rows' torch dtypes, for the device
        self.strategy_dtypes: Any = None
        self._init_rng: torch.Tensor | None = None
        self._has_strategy_rows = False
        # example prototypes (shape and dtype of one example) for the
        # abstract slot arguments of introspection
        x0, y0 = source.client_train(0)
        self._x_example = tree_map(_Example, x0)
        self._y_example = tree_map(_Example, y0)

    @property
    def dirty_rows(self) -> int:
        return self._client_store.dirty

    def reset_rows(self) -> None:
        """Drop every stored per-client row (client states and strategy
        rows): every client resolves to the bound prototypes again, the
        registry's half of a rollback to the initial state
        (``FederatedSimulation._reset_to_initial``)."""
        self._client_store._rows.clear()
        self._strategy_store._rows.clear()

    # -- state rows ------------------------------------------------------
    def bind_client_states(self, proto: Any, init_rng: torch.Tensor) -> None:
        """Install the prototype ``TrainState`` row every client starts from
        (a host copy of the constructor's) and the key from which client
        ``i``'s stream is ``fold_in(init_rng, i + 1)``."""
        self.client_dtypes = tree_map(lambda t: t.dtype, proto)
        self._client_proto = rows_to_host(proto)
        self._init_rng = init_rng.cpu()

    def bind_strategy_rows(self, rows_slot: Any) -> None:
        """Install the strategy-row prototype from a fresh ``[K]`` slot
        state's rows, checking that every slot's row is the same at init
        (the client-symmetric start that lets row 0 stand for every
        client)."""
        self._has_strategy_rows = bool(tree_leaves(rows_slot))
        if not self._has_strategy_rows:
            return
        self.strategy_dtypes = tree_map(lambda t: t.dtype, rows_slot)
        host = rows_to_host(rows_slot)
        for path, leaf in engine.leaves_with_paths(host):
            if leaf is not None and leaf.shape[0] > 1 and not np.all(leaf == leaf[0]):
                raise ValueError(
                    "state_rows must initialize every client identically "
                    f"(client-symmetric start); leaf {path} differs across "
                    "slots at init — the registry cannot derive un-sampled "
                    "clients' rows from a prototype")
        self._strategy_proto = tree_map(lambda a: a[0], host)

    def _default_rng_rows(self, idx: np.ndarray) -> np.ndarray:
        ids = torch.from_numpy(np.asarray(idx, np.int64) + 1)
        return rng.fold_in_many(self._init_rng, ids).numpy()

    @staticmethod
    def _broadcast(proto: Any, k: int) -> Any:
        return tree_map(lambda leaf: np.broadcast_to(leaf, (k, *leaf.shape)), proto)

    def gather_client_states(self, idx: np.ndarray) -> Any:
        """``[K, ...]`` host ``TrainState`` rows for the ids: the prototype
        with each id's own key, overwritten by the stored rows of clients
        that took part before."""
        if self._client_proto is None:
            raise RuntimeError("bind_client_states was never called")
        fresh = dataclasses.replace(self._broadcast(self._client_proto, len(idx)),
                                    rng=self._default_rng_rows(idx))
        return self._client_store.gather(idx, fresh)

    @property
    def has_strategy_rows(self) -> bool:
        """Whether the bound strategy keeps per-client server rows, fixed at
        bind time."""
        return self._has_strategy_rows

    def gather_strategy_rows(self, idx: np.ndarray) -> Any | None:
        if not self._has_strategy_rows:
            return None
        return self._strategy_store.gather(
            idx, self._broadcast(self._strategy_proto, len(idx)))

    def scatter(self, idx: np.ndarray, valid: int, client_rows: Any,
                strategy_rows: Any | None) -> None:
        """Store the round's updated rows (the first ``valid`` slots) under
        their registry ids."""
        self._client_store.scatter(idx, client_rows, valid)
        if self._has_strategy_rows and strategy_rows is not None:
            self._strategy_store.scatter(idx, strategy_rows, valid)

    # -- checkpointing ---------------------------------------------------
    def export_rows(self) -> dict:
        """The registry's durable half of a cohort checkpoint: the stored
        ids and their stacked rows, for both stores (the ids go into the
        frame's header, the rows into its trees)."""
        c_ids, c_rows = self._client_store.export(self._client_proto)
        s_ids, s_rows = (self._strategy_store.export(self._strategy_proto)
                         if self._has_strategy_rows else (np.zeros((0,), np.int64), None))
        return {"client_ids": c_ids, "client_rows": c_rows,
                "strategy_ids": s_ids, "strategy_rows": s_rows}

    def row_templates(self, n_client: int, n_strategy: int) -> dict:
        """Read templates matching :meth:`export_rows` for the stored
        counts."""
        out = {}
        if n_client:
            out["client_rows"] = _SparseRowStore.stacked_template(self._client_proto, n_client)
        if n_strategy and self._has_strategy_rows:
            out["strategy_rows"] = _SparseRowStore.stacked_template(self._strategy_proto,
                                                                    n_strategy)
        return out

    def load_rows(self, client_ids, client_rows, strategy_ids, strategy_rows) -> None:
        """Replace the stored rows with a frame's."""
        self._client_store.load(np.asarray(client_ids, np.int64), client_rows)
        if self._has_strategy_rows:
            self._strategy_store.load(np.asarray(strategy_ids, np.int64), strategy_rows)

    # -- per-round staging -----------------------------------------------
    def train_plan(self, idx: np.ndarray, base_entropy, round_idx: int):
        """The cohort's batch plan, drawn per registry id (the dense path's
        streams) and padded to the registry-wide step budget."""
        ns = [int(self.train_sizes[int(c)]) for c in idx]
        entropies = [[*base_entropy, 1000 + round_idx, int(c)] for c in idx]
        return engine.multi_client_index_plans(
            entropies, ns, self.batch_size, n_steps=self.local_steps,
            local_epochs=self.local_epochs, pad_steps=self.train_steps)

    def _gather_rows(self, getter, idx, plan_idx):
        xs, ys = [], []
        for k, c in enumerate(np.asarray(idx)):
            x, y = getter(int(c))
            take = plan_idx[k]
            xs.append(tree_map(lambda a: np.asarray(a)[take], x))
            ys.append(tree_map(lambda a: np.asarray(a)[take], y))
        stack = lambda rows: tree_map(lambda *ls: np.stack(ls), *rows)  # noqa: E731
        return stack(xs), stack(ys)

    def stage_round(self, idx: np.ndarray, valid: int, base_entropy, round_idx: int) -> dict:
        """One round's host slot tensors: the train batches ``[K, S, B,
        ...]`` (what the dense ``gather_batches`` gathers, built here from
        the registry), the cohort's val batches and counts, the sample
        counts and the slot mask. Numpy only: the caller moves them to the
        device, so this runs on the prefetcher's thread."""
        idx = np.asarray(idx, np.int64)
        k = len(idx)
        p_idx, p_em, p_sm = self.train_plan(idx, base_entropy, round_idx)
        bx, by = self._gather_rows(self.source.client_train, idx, p_idx)
        batches = Batch(x=bx, y=by, example_mask=p_em, step_mask=p_sm)
        # val: one fixed-order pass (the dense rules), padded to the
        # registry-wide val step budget
        v_ns = [int(self.val_sizes[int(c)]) for c in idx]
        v_idx, v_em, v_sm = engine.multi_client_index_plans(
            [[0]] * k, v_ns, self.batch_size, shuffle=False, pad_steps=self.val_steps)
        vx, vy = self._gather_rows(self.source.client_val, idx, v_idx)
        val_batches = Batch(x=vx, y=vy, example_mask=v_em, step_mask=v_sm)
        mask = np.zeros((k,), np.float32)
        mask[:valid] = 1.0
        sample_counts = np.zeros((k,), np.float32)
        sample_counts[:valid] = self.train_sizes[idx[:valid]]
        val_counts = np.zeros((k,), np.float32)
        val_counts[:valid] = self.val_sizes[idx[:valid]]
        staged_bytes = sum(a.nbytes for a in tree_leaves((batches, val_batches)))
        return {"idx": idx, "valid": int(valid), "mask": mask,
                "sample_counts": sample_counts, "batches": batches,
                "val_batches": val_batches, "val_counts": val_counts,
                "staged_bytes": staged_bytes}

    # -- abstract shapes (introspection: no staging, no device work) -----
    def _abstract_batch(self, steps: int, k: int) -> Batch:
        b = self.batch_size
        meta = lambda ex: tree_map(  # noqa: E731
            lambda e: torch.empty((k, steps, b, *e.shape), dtype=e.dtype, device="meta"), ex)
        return Batch(x=meta(self._x_example), y=meta(self._y_example),
                     example_mask=torch.empty((k, steps, b), device="meta"),
                     step_mask=torch.empty((k, steps), device="meta"))

    def abstract_round_args(self, slots: int) -> dict:
        """Meta tensors shaped as one round's slot inputs — what the
        introspector runs the slot programs on. By construction these
        shapes mention only (K, step budgets, batch, example shape), never
        the registry size: the O(K) footprint the introspection tests pin."""
        f32 = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
        return {"batches": self._abstract_batch(self.train_steps, slots),
                "val_batches": self._abstract_batch(self.val_steps, slots),
                "mask": f32(slots), "sample_counts": f32(slots),
                "val_counts": f32(slots)}

    def abstract_chunk_args(self, slots: int, n_rounds: int) -> dict:
        """Stacked ``[R, ...]`` meta tensors of one chunk's per-round inputs
        plus the window ids' — what the introspector runs the cohort chunk
        on. Nothing mentions the registry size beyond the ``min(N, R * K)``
        window cap."""
        aa = self.abstract_round_args(slots)
        k = int(n_rounds)
        stack = lambda tree: tree_map(  # noqa: E731
            lambda t: torch.empty((k, *t.shape), dtype=t.dtype, device="meta"), tree)
        w = min(self.n_clients, k * int(slots))
        out = {name: stack(aa[name]) for name in
               ("batches", "val_batches", "mask", "sample_counts", "val_counts")}
        out["window_ids"] = torch.empty((w,), dtype=torch.int64, device="meta")
        return out

    # -- chunked staging (R rounds a dispatch) ---------------------------
    def chunk_window(self, idx_list: Sequence[np.ndarray], valid_list: Sequence[int],
                     slots: int, n_rounds: int) -> tuple[np.ndarray, int]:
        """The chunk's registry window: the sorted union of every round's
        valid ids, padded to ``W = min(N, n_rounds * slots)`` with the
        sentinel id ``N``. Sorted real ids first, so ``searchsorted`` finds
        every drawn id (pad slots repeat a real one) in a real row; the
        sentinel rows keep the width a function of (N, K, R) and are never
        read or written."""
        chosen = [np.asarray(ix, np.int64)[: int(v)] for ix, v in zip(idx_list, valid_list)]
        real = (np.unique(np.concatenate(chosen)) if any(c.size for c in chosen)
                else np.zeros((0,), np.int64))
        w = min(self.n_clients, int(n_rounds) * int(slots))
        if real.size > w:  # cannot happen: a union of R draws of <= K ids
            raise ValueError(f"chunk window overflow: {real.size} unique ids > {w}")
        out = np.full((w,), self.n_clients, np.int64)
        out[: real.size] = real
        return out, int(real.size)

    def gather_window(self, window_ids: np.ndarray) -> tuple[Any, Any | None]:
        """``[W, ...]`` host rows of a chunk window (client ``TrainState``
        rows, and the strategy's rows or None); the sentinel entries take
        prototype rows."""
        return self.gather_client_states(window_ids), self.gather_strategy_rows(window_ids)

    def stage_chunk(self, draws: Sequence[tuple[np.ndarray, int]], base_entropy,
                    start_round: int) -> dict:
        """R rounds' ``stage_round`` tensors stacked on a leading round axis
        (``batches [R, K, S, B, ...]``, ``mask [R, K]``, ...) for one
        chunk; numpy only, as ``stage_round``."""
        rounds = [self.stage_round(idx, valid, base_entropy, start_round + i)
                  for i, (idx, valid) in enumerate(draws)]
        stack_trees = lambda key: tree_map(  # noqa: E731
            lambda *ls: np.stack(ls), *[r[key] for r in rounds])
        return {"idx": np.stack([r["idx"] for r in rounds]),
                "valid": np.asarray([r["valid"] for r in rounds], np.int32),
                "mask": np.stack([r["mask"] for r in rounds]),
                "sample_counts": np.stack([r["sample_counts"] for r in rounds]),
                "val_counts": np.stack([r["val_counts"] for r in rounds]),
                "batches": stack_trees("batches"),
                "val_batches": stack_trees("val_batches"),
                "staged_bytes": sum(r["staged_bytes"] for r in rounds)}


class _SlotManagerView:
    """A slot-count view of the real client manager, bound to wrapper
    strategies so their per-client server rows are ``[slots]`` while the
    real manager, over the registry, samples. Every other attribute
    (``fraction``, ``min_clients``) is the real manager's, so setup-time
    checks (DP fractions) see the true scheme."""

    def __init__(self, real_manager: Any, slots: int):
        self._real = real_manager
        self.n_clients = slots

    def __getattr__(self, name):
        return getattr(self._real, name)
