"""In-process federated simulation (counterpart of
``fl4health_tpu/server/simulation.py``, its per-round pipelined path).

A round: the client manager samples a participation mask; every client pulls
the global params, trains ``local_steps`` (or ``local_epochs``) over its
index plan and pushes its params; clients with a non-finite training loss
are masked out of the aggregate; the strategy aggregates; then every client
evaluates the new global model on its validation split. Clients run as a
Python loop over a ``[K]``-stacked ``TrainState`` on one device.

The index plans use the JAX simulation's entropy: ``key_data(PRNGKey(seed))``
is ``[0, seed]`` for JAX's default threefry key, so ``base_entropy`` is
hard-coded and round ``r``, client ``i`` draws from ``[0, seed, 1000 + r, i]``
— the same batches in both packages. The initial params come from a
``torch.Generator`` seeded with ``seed`` (not the flax init); tests install
converted flax params with ``set_global_params``.

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


def base_entropy(seed: int) -> list[int]:
    """The JAX simulation's ``key_data(PRNGKey(seed))`` for the default
    threefry key: ``[0, seed]`` (seed as an unsigned 32-bit word)."""
    return [0, int(seed) & 0xFFFFFFFF]


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
        self.seed = seed
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
        generator = torch.Generator().manual_seed(self.seed)
        proto = engine.create_train_state(self.logic, self.tx, generator, self.device)
        self.client_states: TrainState = ptu.stack_clients([proto] * self.n_clients)
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
        """(client_fit, client_eval): pull -> local train -> push, and
        pull -> evaluate."""
        logic, tx, exchanger = self.logic, self.tx, self.exchanger
        # a logic's per-step statistics (DP's clip fraction) are averaged
        # into the fit losses beside "backward"
        train = engine.make_local_train(
            logic, tx, self.metrics,
            ("backward", *getattr(logic, "telemetry_loss_keys", ())))
        evaluate = engine.make_local_eval(logic, self.metrics, ("checkpoint",))

        def client_fit(state: TrainState, payload, batches: Batch,
                       participate: torch.Tensor, entropy: list[int]):
            orig = state
            pulled = exchanger.pull(payload, state.params)
            state = dataclasses.replace(state, params=pulled)
            ctx = logic.init_round_context(state, payload)
            new_state, losses, metrics, _ = train(state, ctx, batches, entropy)
            # non-participants neither pull nor train
            new_state = ptu.tree_map(
                lambda n, o: torch.where(participate > 0, n, o), new_state, orig)
            pushed = exchanger.push(new_state.params, pulled)
            return new_state, logic.pack(new_state, pushed, losses), losses, metrics

        def client_eval(state: TrainState, payload, batches: Batch):
            pulled = exchanger.pull(payload, state.params)
            st = dataclasses.replace(state, params=pulled)
            ctx = logic.init_round_context(st, payload)
            losses, metrics = evaluate(st, ctx, batches)
            return st, losses, metrics

        return client_fit, client_eval

    def _build_round_fns(self):
        client_fit, client_eval = self._build_client_fns()
        strategy = self.strategy

        def over_clients(fn, client_states, *per_client):
            """Run ``fn(i, state_i, *per_client_i)`` client by client over the
            [K]-stacked state; stack each output back along the clients axis."""
            outs = [fn(i, ptu.client_slice(client_states, i),
                       *(ptu.client_slice(a, i) for a in per_client))
                    for i in range(self.n_clients)]
            return tuple(ptu.stack_clients(list(col)) for col in zip(*outs))

        def fit_round(server_state, client_states, batches, mask, round_idx):
            payload = strategy.client_payload(server_state, round_idx)
            new_states, packets, losses, metrics = over_clients(
                lambda i, st, b, m: client_fit(st, payload, b, m,
                                               self._client_entropy(round_idx, i)),
                client_states, batches, mask)
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
            new_states, losses, metrics = over_clients(
                lambda i, st, b: client_eval(st, gp, b), client_states, batches)
            agg_losses = {k: (v * eval_counts).sum() / torch.clamp(eval_counts.sum(), min=1.0)
                          for k, v in losses.items()}
            agg_metrics = aggregate_metrics(metrics, eval_counts)
            return new_states, agg_losses, agg_metrics, losses, metrics

        return fit_round, eval_round

    # ------------------------------------------------------------------
    def _client_entropy(self, round_idx: int, client: int) -> list[int]:
        """Entropy of client ``client`` in round ``round_idx``: its index plan
        and its per-step generators draw from it."""
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
            mask = self.client_manager.sample(rnd, self.device)
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
