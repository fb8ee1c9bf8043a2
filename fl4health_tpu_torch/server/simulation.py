"""In-process federated simulation (counterpart of
``fl4health_tpu/server/simulation.py``, its per-round pipelined path).

A round: the client manager samples a participation mask from
``fold_in(PRNGKey(seed), 2000 + round)``, drawn through ``rng.py`` on the
sim's device as JAX draws it; every client pulls the global params (the
payload's ``params`` where the strategy sends more), trains ``local_steps``
(or ``local_epochs``) over its index plan, lets its logic finalize the
round, and pushes; clients with a non-finite training loss are masked out
of the aggregate; the strategy aggregates; then every client evaluates the
new global model on its validation split.

The clients are one program, as in JAX: ``fit_round`` and ``eval_round``
call ``client_fit`` and ``client_eval`` once a round under
``torch.func.vmap`` over the ``[K]``-stacked ``TrainState``
(``vmap_clients``, JAX's ``jax.vmap(client_fit, in_axes=(0, None, 0, 0,
0))`` less its last argument, the validation batches that only early
stopping reads, which is not ported), with ``randomness="error"``: every draw comes from the clients'
threefry keys. The kernels inside batch over the clients through their
Functions' ``vmap`` rules. ``loop_clients`` runs the same functions client
by client: the client axis's plain version, which the tests hold the vmap
against and nothing else calls. Masks, the finite screen and aggregation
run outside the vmap.

Keys, as in JAX: client ``i`` starts from ``fold_in(fold_in(PRNGKey(seed),
0), i + 1)`` and splits its key once a local step. The index plans use the
JAX simulation's entropy, ``key_data(PRNGKey(seed))`` (``[0, seed]``):
round ``r``, client ``i`` draws from ``[0, seed, 1000 + r, i]`` — the same
batches in both packages. The initial params come from a ``torch.Generator``
seeded with ``seed`` (not the flax init); tests install converted flax
params with ``set_global_params``.

Left out here: chunked, cohort and async execution, the host pipeline's
background consumer/prefetcher threads, precision configs, observability,
resilience, checkpointing, test splits and early stopping.
"""

from __future__ import annotations

import dataclasses
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
from fl4health_tpu_torch.server.client_manager import (ClientManager,
                                                       FullParticipationManager)
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


@dataclasses.dataclass
class ClientDataset:
    """Host-side per-client data (numpy arrays or CPU tensors)."""

    x_train: Any
    y_train: Any
    x_val: Any
    y_val: Any

    @property
    def n_train(self) -> int:
        return int(self.x_train.shape[0])


@dataclasses.dataclass
class RoundRecord:
    round: int
    fit_losses: dict
    fit_metrics: dict
    eval_losses: dict
    eval_metrics: dict
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
        device: str | torch.device = "cuda",
    ):
        if (local_epochs is None) == (local_steps is None):
            raise ValueError("specify exactly one of local_epochs / local_steps")
        self.device = resolve_device(device)
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
            for xs, ys, split in ((d.x_train, d.y_train, "train"),
                                  (d.x_val, d.y_val, "val")):
                if xs.shape[0] != ys.shape[0]:
                    raise ValueError(
                        f"client {i}: x_{split} has {xs.shape[0]} rows but "
                        f"y_{split} has {ys.shape[0]}")
        self.sample_counts = torch.tensor(
            [d.n_train for d in self.datasets], dtype=torch.float32,
            device=self.device)
        stack = lambda arrs, name: engine.pad_and_stack_data(  # noqa: E731
            [np.asarray(a) for a in arrs], name, self.device)
        self._x_train_stack = stack([d.x_train for d in self.datasets], "x_train")
        self._y_train_stack = stack([d.y_train for d in self.datasets], "y_train")
        self._x_val_stack = stack([d.x_val for d in self.datasets], "x_val")
        self._y_val_stack = stack([d.y_val for d in self.datasets], "y_val")
        self._val_cache: tuple[Batch, torch.Tensor] | None = None
        self._init_states()
        self._fit_round, self._eval_round = self._build_round_fns()

    # ------------------------------------------------------------------
    def _init_states(self) -> None:
        init_rng = rng.fold_in(self.rng, 0)
        proto = engine.create_train_state(
            self.logic, self.tx, init_rng, torch.Generator().manual_seed(self.seed),
            self.device)
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

    # ------------------------------------------------------------------
    def _build_client_fns(self):
        """(client_fit, client_eval) of one client: pull -> local train ->
        push, and pull -> evaluate."""
        logic, tx, exchanger = self.logic, self.tx, self.exchanger
        # a logic's per-step statistics (DP's clip fraction) are averaged
        # into the fit losses beside "backward"
        train = engine.make_local_train(
            logic, tx, self.metrics,
            ("backward", *getattr(logic, "telemetry_loss_keys", ())))
        evaluate = engine.make_local_eval(logic, self.metrics, ("checkpoint",))

        def client_fit(state: TrainState, payload, batches: Batch,
                       participate: torch.Tensor):
            orig = state
            pulled = exchanger.pull(payload_params(payload), state.params)
            state = dataclasses.replace(state, params=pulled)
            ctx = logic.init_round_context(state, payload)
            new_state, losses, metrics, _ = train(state, ctx, batches)
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
        fit_clients = client_axis(client_fit, (0, None, 0, 0))
        eval_clients = client_axis(client_eval, (0, None, 0))
        strategy = self.strategy

        def fit_round(server_state, client_states, batches, mask, round_idx):
            payload = strategy.client_payload(server_state, round_idx)
            new_states, packets, losses, metrics = fit_clients(
                client_states, payload, batches, mask)
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

    def _val_batches(self) -> tuple[Batch, torch.Tensor]:
        if self._val_cache is None:
            ns = [int(d.x_val.shape[0]) for d in self.datasets]
            idx, em, sm = engine.multi_client_index_plans(
                [[0]] * self.n_clients, ns, self.batch_size, shuffle=False)
            batches = engine.gather_batches(self._x_val_stack, self._y_val_stack,
                                            idx, em, sm)
            self._val_cache = (batches, torch.tensor(ns, dtype=torch.float32,
                                                     device=self.device))
        return self._val_cache

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, n_rounds: int) -> list[RoundRecord]:
        """Run ``n_rounds`` more rounds (numbered after those already in
        ``history``); returns the whole history."""
        val_batches, val_counts = self._val_batches()
        start = len(self.history) + 1
        for rnd in range(start, start + n_rounds):
            t0 = time.time()
            mask = self.client_manager.sample(rng.fold_in(self.rng, 2000 + rnd), rnd)
            batches = self._round_batches(rnd)
            (self.server_state, self.client_states, fit_losses, fit_metrics,
             _) = self._fit_round(self.server_state, self.client_states,
                                  batches, mask, rnd)
            self._sync()
            t1 = time.time()
            (self.client_states, eval_losses, eval_metrics, per_client_eval_losses,
             per_client_eval_metrics) = self._eval_round(
                self.server_state, self.client_states, val_batches, val_counts)
            self.server_state = self.strategy.update_after_eval(
                self.server_state, per_client_eval_losses, per_client_eval_metrics,
                mask)
            self._sync()
            t2 = time.time()
            host = lambda d: {k: float(v) for k, v in d.items()}  # noqa: E731
            self.history.append(RoundRecord(
                round=rnd, fit_losses=host(fit_losses),
                fit_metrics=host(fit_metrics), eval_losses=host(eval_losses),
                eval_metrics=host(eval_metrics), fit_elapsed_s=t1 - t0,
                eval_elapsed_s=t2 - t1))
        return self.history
