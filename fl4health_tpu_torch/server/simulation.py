"""In-process federated simulation (counterpart of
``fl4health_tpu/server/simulation.py``, its pipelined per-round path).

A round: the client manager samples a participation mask from
``fold_in(PRNGKey(seed), 2000 + round)``, drawn through ``rng.py`` on the
sim's device as JAX draws it; every client pulls the global params (the
payload's ``params`` where the strategy sends more), trains ``local_steps``
(or ``local_epochs``) over its index plan (early-stopped when
``early_stopping`` is set), lets its logic finalize the round, and pushes;
clients with a non-finite training loss are masked out of the aggregate;
the strategy aggregates; then every client evaluates the new global model
on its validation split, and on its test split where every client has one.

The clients are one program, as in JAX: ``fit_round`` and ``eval_round``
call ``client_fit`` and ``client_eval`` once a round under
``torch.func.vmap`` over the ``[K]``-stacked ``TrainState``
(``vmap_clients``, JAX's ``jax.vmap(client_fit, in_axes=(0, None, 0, 0,
0))``: the last argument is the validation batches, which early stopping
and ``evaluate_after_fit`` read), with ``randomness="error"``: every draw
comes from the clients' threefry keys. The kernels inside batch over the
clients through their Functions' ``vmap`` rules. ``loop_clients`` runs the
same functions client by client: the client axis's plain version, which the
tests hold the vmap against and nothing else calls. Masks, the finite
screen and aggregation run outside the vmap.

``fit`` runs the rounds pipelined (``server/pipeline.py``): this thread, the
producer, samples the mask, takes the batches the ``RoundPrefetcher``
staged, stages the next round's, and dispatches fit, eval (and the test
eval) and ``update_after_eval`` without waiting for the device; it hands the
round's results to the ``RoundConsumer``, whose thread makes the round's
one device->host pull (``HostPull``), screens failures
(``FailurePolicy``), appends the ``RoundRecord`` and reports, in round
order, while the device runs the next round. With ``accept_failures=False``
the producer waits for each round's epilogue, so a failure stops the run
before the next dispatch. ``_finish_round`` called inline (no consumer) is
the pipeline's plain version. ``fit_elapsed_s``/``eval_elapsed_s`` are, as
in JAX, host time around the dispatches; a round's device time is read by
a synchronised wall around ``fit``.

Keys, as in JAX: client ``i`` starts from ``fold_in(fold_in(PRNGKey(seed),
0), i + 1)`` and splits its key once a local step. The index plans use the
JAX simulation's entropy, ``key_data(PRNGKey(seed))`` (``[0, seed]``):
round ``r``, client ``i`` draws from ``[0, seed, 1000 + r, i]`` — the same
batches in both packages. The initial params come from a ``torch.Generator``
seeded with ``seed`` (not the flax init); tests install converted flax
params with ``set_global_params``.

A partial ``exchanger`` (``FixedLayerExchanger``, e.g. ``lora_exchanger``)
runs its ``pull`` and ``push`` inside the client vmap, in ``client_fit``
and ``client_eval``, as in JAX. The clients' whole ``TrainState``, their
optimizer state included, carries over from round to round; nothing
re-initialises it. A stateful server optimizer (``FedOpt``) keeps its state
in ``server_state``. ``precision`` (a ``PrecisionConfig``) reaches the
clients' train steps and their initial state (``loss_scale``).

Departures: ``fit(n)`` runs ``n`` more rounds, numbered after ``history``;
a logic's ``telemetry_loss_keys`` are always averaged beside ``backward``.
Left out here: chunked, cohort and async execution (and the prefetcher's
cohort/chunk staging), observability, resilience, checkpointing (model and
state), mesh placement, FLASH early stopping and the ``WandBReporter``.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Any, Sequence

import numpy as np
import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.clients import engine
from fl4health_tpu_torch.clients.engine import Batch, ClientLogic, TrainState
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.device import resolve_device
from fl4health_tpu_torch.exchange.exchanger import FullExchanger
from fl4health_tpu_torch.metrics.aggregation import aggregate_metrics
from fl4health_tpu_torch.metrics.base import MetricManager
from fl4health_tpu_torch.optim import GradientTransformation
from fl4health_tpu_torch.precision.policy import PrecisionConfig
from fl4health_tpu_torch.server.client_manager import (ClientManager,
                                                       FullParticipationManager)
from fl4health_tpu_torch.server.pipeline import HostPull, RoundConsumer, RoundPrefetcher
from fl4health_tpu_torch.strategies.base import FitResults, Strategy


def vmap_clients(fn, in_dims):
    """The client axis: ``fn`` over the ``[K]``-stacked arguments (``in_dims``
    0) and shared ones (None) as one ``torch.func.vmap``; no random op may
    run inside it."""
    return torch.func.vmap(fn, in_dims=in_dims, randomness="error")


def loop_clients(fn, in_dims):
    """The client axis's plain version: ``fn`` client by client over the
    ``[K]``-stacked arguments (``in_dims`` 0) and shared ones (None), each
    output stacked back along the clients axis. The tests hold
    ``vmap_clients`` against it; nothing else calls it."""

    def run(*args):
        n = next(ptu.tree_leaves(a)[0].shape[0] for a, d in zip(args, in_dims) if d == 0)
        outs = [fn(*(ptu.client_slice(a, i) if d == 0 else a
                     for a, d in zip(args, in_dims))) for i in range(n)]
        return tuple(ptu.stack_clients(list(col)) for col in zip(*outs))

    return run


def base_entropy(seed: int) -> list[int]:
    """The JAX simulation's ``key_data(PRNGKey(seed))``."""
    return [int(w) for w in rng.key_data(rng.PRNGKey(seed))]


def payload_params(payload):
    """The params a client pulls: the payload's ``params`` where the
    strategy sends more than params (a ``ClippingPayload``), else the
    payload itself."""
    return payload.params if hasattr(payload, "params") else payload


EXEC_PIPELINED = "pipelined_per_round"


@dataclasses.dataclass
class ClientDataset:
    """Host-side per-client data (numpy arrays or CPU tensors); the test
    split is optional, and taken only when every client has one."""

    x_train: Any
    y_train: Any
    x_val: Any
    y_val: Any
    x_test: Any = None
    y_test: Any = None

    @property
    def n_train(self) -> int:
        return int(self.x_train.shape[0])


class ClientFailuresError(RuntimeError):
    """Raised when ``accept_failures=False`` and a client failed: carries
    the failing clients' indices and, once the round epilogue attached it,
    the ``round``."""

    def __init__(self, message: str, clients: Sequence[int] = ()):
        super().__init__(message)
        self.clients = [int(c) for c in clients]
        self.round: int | None = None


@dataclasses.dataclass
class FailurePolicy:
    """``accept_failures`` semantics: with ``accept_failures=False`` any
    failed client ends the run. A failure is a non-finite ``backward`` loss
    in a participating client's row of the round's per-client losses."""

    accept_failures: bool = True

    def check(self, per_client_losses, mask) -> list[int]:
        if "backward" not in per_client_losses:
            return []
        # numpy only: the consumer runs this on the round's host copy, and
        # the screen must launch no device work
        row = np.asarray(per_client_losses["backward"])
        bad = np.logical_and(~np.isfinite(row), np.asarray(mask) > 0)
        failed = [int(i) for i in np.nonzero(bad)[0]]
        for cid in failed:
            logging.getLogger(__name__).error(
                "Client %d failed (non-finite training loss).", cid)
        if failed and not self.accept_failures:
            raise ClientFailuresError(
                f"The server encountered failures from clients {failed} and "
                "accept_failures is set to False", clients=failed)
        return failed


@dataclasses.dataclass
class RoundRecord:
    round: int
    fit_losses: dict
    fit_metrics: dict
    eval_losses: dict
    eval_metrics: dict
    fit_elapsed_s: float
    eval_elapsed_s: float


@dataclasses.dataclass
class _RoundWork:
    """What the consumer needs to finish one round on the host: the
    round's device results, already on their way to the host, and the
    producer's dispatch times."""

    round: int
    pull: HostPull
    fit_elapsed_s: float
    eval_elapsed_s: float


class FederatedSimulation:
    """Couples logic + optimizer + strategy + data into a runnable FL job."""

    def __init__(
        self,
        logic: ClientLogic,
        tx: GradientTransformation,
        strategy: Strategy,
        datasets: Sequence[ClientDataset],
        batch_size: int,
        metrics: MetricManager,
        local_epochs: int | None = None,
        local_steps: int | None = None,
        exchanger=None,
        client_manager: ClientManager | None = None,
        seed: int = 42,
        extra_loss_keys: tuple[str, ...] = (),
        eval_loss_keys: tuple[str, ...] = (),
        reporters: Sequence[Any] = (),
        early_stopping: engine.EarlyStoppingConfig | None = None,
        failure_policy: FailurePolicy | None = None,
        train_data_provider: Any = None,
        pipeline_depth: int = 2,
        precision: PrecisionConfig | None = None,
        device: str | torch.device = "cuda",
    ):
        if (local_epochs is None) == (local_steps is None):
            raise ValueError("specify exactly one of local_epochs / local_steps")
        if precision is not None and not isinstance(precision, PrecisionConfig):
            raise TypeError(
                "precision must be a PrecisionConfig (or None); got "
                f"{type(precision).__name__}: a duck-typed config would skip its checks")
        self.precision = precision
        self.device = resolve_device(device)
        self._extra_loss_keys = tuple(extra_loss_keys)
        self._eval_loss_keys = tuple(eval_loss_keys)
        self.reporters = list(reporters)
        self.early_stopping = early_stopping
        self.failure_policy = failure_policy or FailurePolicy()
        # callable(round) -> (x_list, y_list) | None, called at the top of
        # each round: fresh train arrays of the original shapes and dtypes
        self.train_data_provider = train_data_provider
        # how many rounds of host epilogue may be in flight behind the
        # producer (the RoundConsumer's bound)
        self.pipeline_depth = pipeline_depth
        self._consumer: RoundConsumer | None = None
        self._prefetcher: RoundPrefetcher | None = None
        self._fit_last_round = 0
        self.logic, self.tx, self.strategy = logic, tx, strategy
        self.datasets = list(datasets)
        self.n_clients = len(self.datasets)
        self.batch_size, self.metrics = batch_size, metrics
        self.local_epochs, self.local_steps = local_epochs, local_steps
        self.exchanger = exchanger or FullExchanger()
        self.client_manager = client_manager or FullParticipationManager(self.n_clients)
        if self.client_manager.n_clients != self.n_clients:
            raise ValueError(
                f"client_manager covers {self.client_manager.n_clients} clients "
                f"but {self.n_clients} datasets were given")
        # setup-time strategy <-> sampling-scheme check (the DP strategy
        # derives or checks its sampling fraction against the manager's)
        self.strategy.bind_client_manager(self.client_manager)
        self.seed = seed
        self.rng = rng.PRNGKey(seed, self.device)
        self._base_entropy = base_entropy(seed)
        self.history: list[RoundRecord] = []
        for i, d in enumerate(self.datasets):
            if d.y_test is not None and d.x_test is None:
                raise ValueError(f"client {i}: y_test set but x_test is None")
        have_test = [d.x_test is not None for d in self.datasets]
        if any(have_test) and not all(have_test):
            missing = [i for i, h in enumerate(have_test) if not h]
            raise ValueError(
                f"clients {missing} have no test split while others do; "
                "provide x_test/y_test for every client or none.")
        self._has_test_split = all(have_test) and len(have_test) > 0
        for i, d in enumerate(self.datasets):
            splits = [(d.x_train, d.y_train, "train"), (d.x_val, d.y_val, "val")]
            if self._has_test_split:
                if d.y_test is None:
                    raise ValueError(f"client {i}: x_test set but y_test is None")
                splits.append((d.x_test, d.y_test, "test"))
            for xs, ys, split in splits:
                if xs.shape[0] != ys.shape[0]:
                    raise ValueError(
                        f"client {i}: x_{split} has {xs.shape[0]} rows but "
                        f"y_{split} has {ys.shape[0]}")
        self.sample_counts = torch.tensor(
            [d.n_train for d in self.datasets], dtype=torch.float32,
            device=self.device)
        stack = engine.pad_and_stack_data
        self._x_train_stack = stack([d.x_train for d in self.datasets], "x_train", self.device)
        self._y_train_stack = stack([d.y_train for d in self.datasets], "y_train", self.device)
        self._x_val_stack = stack([d.x_val for d in self.datasets], "x_val", self.device)
        self._y_val_stack = stack([d.y_val for d in self.datasets], "y_val", self.device)
        self._val_cache: tuple[Batch, torch.Tensor] | None = None
        self._test_cache: tuple[Batch, torch.Tensor] | None = None
        self._init_states()
        self._fit_round, self._eval_round = self._build_round_fns()

    # ------------------------------------------------------------------
    def _init_states(self) -> None:
        init_rng = rng.fold_in(self.rng, 0)
        proto = engine.create_train_state(
            self.logic, self.tx, init_rng, torch.Generator().manual_seed(self.seed),
            self.device, precision=self.precision)
        # every client starts from the same params; only the key differs
        keys = torch.stack([rng.fold_in(init_rng, i + 1) for i in range(self.n_clients)])
        self.client_states: TrainState = dataclasses.replace(
            ptu.stack_clients([proto] * self.n_clients), rng=keys)
        self.server_state = self.strategy.init(proto.params)

    @property
    def global_params(self):
        return self.strategy.global_params(self.server_state)

    def set_global_params(self, params) -> None:
        """Install weights (same keys and shapes as the model's) as the
        global model and as every client's."""
        ref = self.global_params
        if set(params) != set(ref):
            raise ValueError("set_global_params: keys do not match the model's "
                             f"params: {sorted(set(params) ^ set(ref))}")
        for k, v in params.items():
            if tuple(v.shape) != tuple(ref[k].shape):
                raise ValueError(f"set_global_params: {k} has shape "
                                 f"{tuple(v.shape)}, model expects {tuple(ref[k].shape)}")
        params = {k: torch.as_tensor(params[k]).to(device=self.device, dtype=r.dtype)
                  for k, r in ref.items()}
        self.server_state = dataclasses.replace(self.server_state, params=params)
        self.client_states = dataclasses.replace(
            self.client_states, params=ptu.stack_clients([params] * self.n_clients))

    def set_train_data(self, xs: Sequence[Any], ys: Sequence[Any]) -> None:
        """Swap every client's training arrays (per-round data refresh).
        The new stacks must have the original shapes and dtypes."""
        new_x = engine.pad_and_stack_data(xs, "x_train", self.device)
        new_y = engine.pad_and_stack_data(ys, "y_train", self.device)
        for name, new, old in (("x_train", new_x, self._x_train_stack),
                               ("y_train", new_y, self._y_train_stack)):
            if new.shape != old.shape or new.dtype != old.dtype:
                raise ValueError(
                    f"set_train_data: {name} stack {tuple(new.shape)}/{new.dtype} "
                    f"must match the original {tuple(old.shape)}/{old.dtype} "
                    "(per-round refresh may not change the data layout)")
        self._x_train_stack, self._y_train_stack = new_x, new_y

    # ------------------------------------------------------------------
    def _build_client_fns(self):
        """(client_fit, client_eval) of one client: pull -> local train ->
        push, and pull -> evaluate."""
        logic, tx, exchanger = self.logic, self.tx, self.exchanger
        loss_keys = ("backward", *self._extra_keys())
        # a logic's per-step statistics (DP's clip fraction) are averaged
        # into the fit losses beside "backward"
        loss_keys += tuple(k for k in getattr(logic, "telemetry_loss_keys", ())
                           if k not in loss_keys)
        if self.early_stopping is not None:
            train = engine.make_local_train_with_early_stopping(
                logic, tx, self.metrics, self.early_stopping, loss_keys,
                precision=self.precision)
        else:
            plain_train = engine.make_local_train(logic, tx, self.metrics, loss_keys,
                                                  precision=self.precision)

            def train(state, ctx, batches, val_batches):
                return plain_train(state, ctx, batches)
        evaluate = engine.make_local_eval(logic, self.metrics,
                                          ("checkpoint", *self._eval_keys()))
        evaluate_after_fit = getattr(self.strategy, "evaluate_after_fit", False)

        def client_fit(state: TrainState, payload, batches: Batch,
                       participate: torch.Tensor, val_batches: Batch):
            orig = state
            pulled = exchanger.pull(payload_params(payload), state.params)
            state = dataclasses.replace(state, params=pulled)
            ctx = logic.init_round_context(state, payload)
            new_state, losses, metrics, _ = train(state, ctx, batches, val_batches)
            if evaluate_after_fit:
                # local validation before aggregation (FedDG-GA's
                # evaluate_after_fit)
                post_fit = evaluate(new_state, ctx, val_batches)[0]
                losses = {**losses, "val_checkpoint_post_fit": post_fit["checkpoint"]}
            # non-participants neither pull nor train
            new_state = ptu.tree_map(
                lambda n, o: torch.where(participate > 0, n, o), new_state, orig)
            pushed = exchanger.push(new_state.params, pulled)
            return new_state, logic.pack(new_state, pushed, losses), losses, metrics

        def client_eval(state: TrainState, payload, batches: Batch):
            pulled = exchanger.pull(payload_params(payload), state.params)
            st = dataclasses.replace(state, params=pulled)
            ctx = logic.init_round_context(st, payload)
            losses, metrics = evaluate(st, ctx, batches)
            return st, losses, metrics

        return client_fit, client_eval

    def _build_round_fns(self, client_axis=vmap_clients):
        """(fit_round, eval_round), each running the clients through
        ``client_axis`` (``vmap_clients``; the tests pass
        ``loop_clients``)."""
        client_fit, client_eval = self._build_client_fns()
        fit_clients = client_axis(client_fit, (0, None, 0, 0, 0))
        eval_clients = client_axis(client_eval, (0, None, 0))
        strategy = self.strategy

        def fit_round(server_state, client_states, batches, mask, round_idx,
                      val_batches):
            payload = strategy.client_payload(server_state, round_idx)
            new_states, packets, losses, metrics = fit_clients(
                client_states, payload, batches, mask, val_batches)
            # failed clients (non-finite loss) are excluded from aggregation
            finite = torch.isfinite(losses["backward"])
            results = FitResults(packets=packets,
                                 sample_counts=self.sample_counts,
                                 train_losses=losses, train_metrics=metrics,
                                 mask=mask * finite.to(mask.dtype))
            new_server_state = strategy.aggregate(server_state, results, round_idx)
            w = results.mask * self.sample_counts
            agg_losses = {
                # where() not multiply: an excluded client's NaN must not leak
                k: (torch.where(results.mask > 0, v, torch.zeros_like(v)) * w).sum()
                / torch.clamp(w.sum(), min=1.0)
                for k, v in losses.items()
            }
            agg_metrics = aggregate_metrics(metrics, self.sample_counts, results.mask)
            return new_server_state, new_states, agg_losses, agg_metrics, losses

        def eval_round(server_state, client_states, batches, eval_counts):
            gp = strategy.client_payload(server_state, 0)
            new_states, losses, metrics = eval_clients(client_states, gp, batches)
            agg_losses = {k: (v * eval_counts).sum() / torch.clamp(eval_counts.sum(), min=1.0)
                          for k, v in losses.items()}
            agg_metrics = aggregate_metrics(metrics, eval_counts)
            return new_states, agg_losses, agg_metrics, losses, metrics

        return fit_round, eval_round

    def _extra_keys(self) -> tuple[str, ...]:
        # explicit constructor keys win; else the logic's declared keys
        if self._extra_loss_keys:
            return self._extra_loss_keys
        return tuple(getattr(self.logic, "extra_loss_keys", ()))

    def _eval_keys(self) -> tuple[str, ...]:
        if self._eval_loss_keys:
            return self._eval_loss_keys
        return tuple(getattr(self.logic, "eval_loss_keys", ()))

    # ------------------------------------------------------------------
    def _client_entropy(self, round_idx: int, client: int) -> list[int]:
        """Entropy of client ``client`` in round ``round_idx``, from which its
        index plan draws."""
        return [*self._base_entropy, 1000 + round_idx, client]

    def _round_plan(self, round_idx: int):
        """Host-side index plan (numpy idx/example_mask/step_mask) for one round."""
        entropies = [self._client_entropy(round_idx, i)
                     for i in range(self.n_clients)]
        return engine.multi_client_index_plans(
            entropies, [d.n_train for d in self.datasets], self.batch_size,
            n_steps=self.local_steps, local_epochs=self.local_epochs)

    def _round_batches(self, round_idx: int) -> Batch:
        return engine.gather_batches(self._x_train_stack, self._y_train_stack,
                                     *self._round_plan(round_idx))

    def _eval_split_batches(self, x_stack, y_stack, ns) -> tuple[Batch, torch.Tensor]:
        """The val and test splits' batching: one fixed-order pass, and the
        per-client row counts."""
        idx, em, sm = engine.multi_client_index_plans(
            [[0]] * self.n_clients, ns, self.batch_size, shuffle=False)
        return (engine.gather_batches(x_stack, y_stack, idx, em, sm),
                torch.tensor(ns, dtype=torch.float32, device=self.device))

    def _val_batches(self) -> tuple[Batch, torch.Tensor]:
        if self._val_cache is None:
            self._val_cache = self._eval_split_batches(
                self._x_val_stack, self._y_val_stack,
                [int(d.x_val.shape[0]) for d in self.datasets])
        return self._val_cache

    def _test_batches(self) -> tuple[Batch, torch.Tensor] | None:
        """The test split, evaluated beside the val split each round, its
        keys ``"test - "``-prefixed; None unless every client has one."""
        if not self._has_test_split:
            return None
        if self._test_cache is None:
            stack = engine.pad_and_stack_data
            self._test_cache = self._eval_split_batches(
                stack([d.x_test for d in self.datasets], "x_test", self.device),
                stack([d.y_test for d in self.datasets], "y_test", self.device),
                [int(d.x_test.shape[0]) for d in self.datasets])
        return self._test_cache

    # ------------------------------------------------------------------
    def fit(self, n_rounds: int) -> list[RoundRecord]:
        """Run ``n_rounds`` more rounds (numbered after those already in
        ``history``) through the pipelined path; returns the whole history.
        ``fit(0)`` runs nothing."""
        reason = ("n_rounds < 1 (no rounds to run)" if n_rounds < 1
                  else "the port's only execution mode")
        for rep in self.reporters:
            rep.report({"host_type": "server", "fit_start": time.time(),
                        "num_rounds": n_rounds, "execution_mode": EXEC_PIPELINED,
                        "execution_mode_reason": reason})
        if n_rounds >= 1:
            first = len(self.history) + 1
            self._fit_pipelined(first, first + n_rounds - 1)
        for rep in self.reporters:
            rep.report({"fit_end": time.time()})
            rep.shutdown()
        return self.history

    def _fit_pipelined(self, first: int, last: int) -> None:
        """Rounds ``first..last``: this thread dispatches each round and
        submits its host epilogue to a ``RoundConsumer``; a
        ``RoundPrefetcher`` stages the next round's batches meanwhile."""
        val_batches, val_counts = self._val_batches()
        self._fit_last_round = last
        consumer = self._consumer = RoundConsumer(maxsize=self.pipeline_depth)
        prefetcher = self._prefetcher = RoundPrefetcher(self)
        try:
            prefetcher.schedule(first)
            for rnd in range(first, last + 1):
                consumer.raise_pending()
                self._run_round(rnd, val_batches, val_counts)
            consumer.flush()  # barrier: every round's epilogue has run
        finally:
            consumer.close()
            prefetcher.close()
            self._consumer = self._prefetcher = None

    def _run_round(self, rnd: int, val_batches, val_counts) -> None:
        """The producer's half of a round: sample, dispatch fit, eval (and
        the test eval) and ``update_after_eval``, start the results' pull,
        and hand the round to the consumer. Nothing here waits for the
        device."""
        consumer, prefetcher = self._consumer, self._prefetcher
        t0 = time.time()
        if self.train_data_provider is not None:
            fresh = self.train_data_provider(rnd)
            if fresh is not None:
                self.set_train_data(*fresh)
        mask = self.client_manager.sample(rng.fold_in(self.rng, 2000 + rnd), rnd)
        batches = (prefetcher.take(rnd) if prefetcher is not None
                   else self._round_batches(rnd))
        if prefetcher is not None and rnd < self._fit_last_round:
            prefetcher.schedule(rnd + 1)  # stage round r+1 while round r runs
        (self.server_state, self.client_states, fit_losses, fit_metrics,
         per_client_fit_losses) = self._fit_round(
            self.server_state, self.client_states, batches, mask, rnd, val_batches)
        t1 = time.time()
        (self.client_states, eval_losses, eval_metrics, per_client_eval_losses,
         per_client_eval_metrics) = self._eval_round(
            self.server_state, self.client_states, val_batches, val_counts)
        self.server_state = self.strategy.update_after_eval(
            self.server_state, per_client_eval_losses, per_client_eval_metrics, mask)
        results = {"mask": mask, "fit_losses": fit_losses, "fit_metrics": fit_metrics,
                   "per_client_fit_losses": per_client_fit_losses,
                   "eval_losses": eval_losses, "eval_metrics": eval_metrics}
        test = self._test_batches()
        if test is not None:
            # the same aggregated model on the test split, its keys
            # "test - "-prefixed beside the val keys
            self.client_states, results["test_losses"], results["test_metrics"] = (
                self._eval_round(self.server_state, self.client_states, *test)[:3])
        work = _RoundWork(round=rnd, pull=HostPull(results), fit_elapsed_s=t1 - t0,
                          eval_elapsed_s=time.time() - t1)
        if consumer is None:  # no pipeline: the epilogue inline
            self._finish_round(work)
            return
        consumer.submit_round(rnd, functools.partial(self._finish_round, work))
        if not self.failure_policy.accept_failures:
            # the failure screen runs in the epilogue and must end the run
            # before the next round dispatches
            consumer.flush()

    def _finish_round(self, work: _RoundWork) -> None:
        """The consumer's half of a round: the round's one device->host
        pull, the failure screen, the ``RoundRecord`` and the reports, in
        round order. Launches nothing on the device."""
        host = work.pull.result()
        try:
            self.failure_policy.check(host["per_client_fit_losses"], host["mask"])
        except ClientFailuresError as cf:
            cf.round = work.round
            raise
        floats = lambda d, prefix="": {  # noqa: E731
            f"{prefix}{k}": float(v) for k, v in d.items()}
        eval_losses, eval_metrics = floats(host["eval_losses"]), floats(host["eval_metrics"])
        if "test_losses" in host:
            eval_losses.update(floats(host["test_losses"], "test - "))
            eval_metrics.update(floats(host["test_metrics"], "test - "))
        rec = RoundRecord(round=work.round, fit_losses=floats(host["fit_losses"]),
                          fit_metrics=floats(host["fit_metrics"]),
                          eval_losses=eval_losses, eval_metrics=eval_metrics,
                          fit_elapsed_s=work.fit_elapsed_s,
                          eval_elapsed_s=work.eval_elapsed_s)
        self.history.append(rec)
        for rep in self.reporters:
            rep.report({"fit_losses": rec.fit_losses, "fit_metrics": rec.fit_metrics,
                        "eval_losses": rec.eval_losses, "eval_metrics": rec.eval_metrics,
                        "fit_elapsed_s": rec.fit_elapsed_s,
                        "eval_elapsed_s": rec.eval_elapsed_s,
                        "execution_mode": EXEC_PIPELINED}, round=work.round)
