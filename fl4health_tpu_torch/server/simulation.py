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

``fit`` takes one of two routes (``execution_mode``, ``"auto"`` by default,
as in JAX: ``_select_execution_mode`` gives the route and its reason).

The chunked route (``chunked_scan``), which ``"auto"`` takes unless
something needs the host between rounds (``_chunk_ineligibility``: a
``train_data_provider``, ``accept_failures=False``, a strategy that
overrides ``update_after_eval``): the masks and index plans of every round
are drawn up front from the same streams, and the rounds (fit, eval, the
test eval) are dispatched back to back from this thread over the resident
stacks, JAX's ``lax.scan`` over rounds; their outputs stack on the device,
one ``HostPull`` brings them over, and the epilogue screens failures and
records each round, its ``fit_elapsed_s`` the chunk's wall amortised and
its ``eval_elapsed_s`` 0. It equals the pipelined route bit for bit.

The pipelined route (``server/pipeline.py``): this thread, the
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

Cohort-slot execution (``cohort=CohortConfig(slots=K)``, JAX's
``_fit_cohort``/``_fit_cohort_chunked``): the population lives in a host
``ClientRegistry`` (``server/registry.py``) and every round runs over ``K``
slots, so device memory and a round's work grow with K, not with the
registry. The manager samples over the registry (``sample_indices``, drawn
from a CPU copy of the simulation's key, so the host view never waits for
the card). Pipelined: the prefetcher stages round r+1's slot data while
round r runs; the producer waits for the consumer to have stored round r's
rows in the registry (``_await_registry_scatter``), gathers the sampled
clients' rows (and the strategy's, ``state_rows``), dispatches fit and
eval, and the round's one pull brings the updated rows back for the
consumer's ``registry.scatter``. Chunked (a manager with ``draw_cohort``):
a chunk's draws, slot tensors and registry window (``chunk_window``) are
staged up front; each round draws its cohort on the device, finds its rows
in the window (``searchsorted``), gathers, fits, evaluates and writes the
rows back into the window, pad slots dropped; one pull at the chunk's end,
where the device draws must equal the host's or ``RuntimeError`` is raised,
then the window's rows go back into the registry. Both routes give the same
history and rows bit for bit; ``slots == N`` under full participation gives
the dense run's.

``compression=CompressionConfig(...)`` wraps the strategy in a
``CompressingStrategy`` (``compression/``), whose error-feedback residuals
are per-client server rows.

``fault_plan=FaultPlan(...)`` (``resilience/faults.py``) injects seeded
client faults into every round program: dropout multiplies the mask before
the client vmap, corruption rewrites the packets after it, drawn from
``(plan seed, fault, round)`` on the sim's device, so both routes (and both
packages) inject the same faults; an empty plan changes nothing.

Buffered async (``async_config=AsyncConfig(...)``, FedBuff, JAX's
``_build_async_fns``/``_fit_async``): ``fit(n)`` resolves ``n``
buffer-fill events to a static plan (``server/async_schedule.py``: seeded
virtual compute times, the plan's ``kind="slow"`` stragglers) and runs a
prologue (every client trains on data plan 1 into the ``pending`` buffer),
then one program an event: the ``K`` arrived updates aggregate under the
staleness-discounted mask (``FedBuff.async_aggregation_mask``, the strategy
wrapped as the outermost wrapper), the fresh global is evaluated, and the
arrived clients restart on data plan ``e+1`` from their post-eval states,
their new packets merged into ``pending``. Each event is one
``RoundRecord``; its plan facts go to ``round_metrics``. Three routes: the
pipelined one (producer, consumer, the prefetcher staging plan ``e+1``),
the chunked one (every event dispatched back to back over the resident
stacks, ``pending`` carried on the device, one pull), bit-equal to each
other; and over a client registry (pipelined only): a consumed seat whose
occupant changes (``RegistryEventPlan.slot_ids``) has its rows pulled and
stored under its old id, then the new occupant's rows gathered in, before
the event dispatches. With ``K`` = the cohort and no stragglers every
event is a synchronous round, bit for bit. As in JAX each ``fit`` call
builds a fresh plan over its own events and a new prologue from event 1
(the programs see JAX's event indices); its records are numbered after
``history``.

Departures: ``fit(n)`` runs ``n`` more rounds, numbered after ``history``;
a logic's ``telemetry_loss_keys`` are always averaged beside ``backward``;
a round's facts (a cohort round's ``cohort_info``, an async event's plan
facts, the fault plan's ``summarize_round`` under ``"fault"``) land in
``round_metrics``, where the observability records would read them. Left
out here: observability, the rest of resilience (quarantine, recovery),
checkpointing (model and state, cohort rows and the async snapshot
included), mesh placement, FLASH early stopping and the ``WandBReporter``;
so of JAX's reasons for the pipelined route, only those of the features
above apply.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import logging
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.clients import engine
from fl4health_tpu_torch.clients.engine import Batch, ClientLogic, TrainState
from fl4health_tpu_torch.compression.config import CompressionConfig
from fl4health_tpu_torch.compression.strategy import CompressingStrategy
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.device import resolve_device
from fl4health_tpu_torch.exchange.exchanger import FixedLayerExchanger, FullExchanger
from fl4health_tpu_torch.metrics.aggregation import aggregate_metrics
from fl4health_tpu_torch.metrics.base import MetricManager
from fl4health_tpu_torch.optim import GradientTransformation
from fl4health_tpu_torch.precision.policy import PrecisionConfig
from fl4health_tpu_torch.resilience.faults import FaultPlan
from fl4health_tpu_torch.server.async_schedule import (AsyncConfig, build_event_plan,
                                                       build_registry_event_plan)
from fl4health_tpu_torch.server.client_manager import (ClientManager,
                                                       FullParticipationManager)
from fl4health_tpu_torch.server.pipeline import HostPull, RoundConsumer, RoundPrefetcher
from fl4health_tpu_torch.server.registry import (ClientRegistry, CohortConfig,
                                                 _SlotManagerView, as_registry_source,
                                                 rows_to_device)
from fl4health_tpu_torch.strategies.base import (FitResults, Strategy,
                                                 replace_global_params)
from fl4health_tpu_torch.strategies.fedbuff import FedBuff


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


def fit_summary(losses: dict, metrics: dict, mask: torch.Tensor,
                counts: torch.Tensor) -> tuple[dict, dict]:
    """A round's (or an event's) training losses and metrics, weighted by
    ``mask * counts`` over the clients."""
    w = mask * counts
    agg_losses = {
        # where() not multiply: an excluded client's NaN must not leak
        k: (torch.where(mask > 0, v, torch.zeros_like(v)) * w).sum()
        / torch.clamp(w.sum(), min=1.0)
        for k, v in losses.items()
    }
    return agg_losses, aggregate_metrics(metrics, counts, mask)


def base_entropy(seed: int) -> list[int]:
    """The JAX simulation's ``key_data(PRNGKey(seed))``."""
    return [int(w) for w in rng.key_data(rng.PRNGKey(seed))]


def payload_params(payload):
    """The params a client pulls: the payload's ``params`` where the
    strategy sends more than params (a ``ClippingPayload``), else the
    payload itself."""
    return payload.params if hasattr(payload, "params") else payload


EXEC_PIPELINED = "pipelined_per_round"
EXEC_CHUNKED = "chunked_scan"


@dataclasses.dataclass
class ClientDataset:
    """Host-side per-client data (numpy arrays or CPU tensors, or dicts of
    them sharing axis 0: multi-input models get the dict); the test split
    is optional, and taken only when every client has one."""

    x_train: Any
    y_train: Any
    x_val: Any
    y_val: Any
    x_test: Any = None
    y_test: Any = None

    @property
    def n_train(self) -> int:
        return engine.data_rows(self.x_train)


class ClientFailuresError(RuntimeError):
    """Raised when ``accept_failures=False`` and a client failed: carries
    the failing clients' indices and, once the round epilogue attached it,
    the ``round``."""

    def __init__(self, message: str, clients: Sequence[int] = ()):
        super().__init__(message)
        self.clients = [int(c) for c in clients]
        self.round: int | None = None
        # a cohort round's failed slots as registry ids
        self.registry_clients: list[int] | None = None


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
    # cohort rounds only: the sampled registry ids, valid count, staging
    # facts and the event the producer's next gather waits on
    cohort_meta: dict | None = None
    # an async event over the registry: its cohort facts, built by the
    # producer (no rows ride its pull)
    cohort_info: dict | None = None
    # async events only: the plan's facts (``_async_event_info``) and the
    # event index the round programs drew at (the record's round is
    # numbered after ``history``)
    async_info: dict | None = None
    event: int | None = None


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
        execution_mode: str = "auto",
        compression: CompressionConfig | None = None,
        cohort: CohortConfig | None = None,
        fault_plan: FaultPlan | None = None,
        async_config: AsyncConfig | None = None,
        device: str | torch.device = "cuda",
    ):
        if (local_epochs is None) == (local_steps is None):
            raise ValueError("specify exactly one of local_epochs / local_steps")
        if execution_mode not in ("auto", "pipelined", "chunked"):
            raise ValueError(
                f"execution_mode must be 'auto', 'pipelined' or 'chunked'; "
                f"got {execution_mode!r}")
        self.execution_mode = execution_mode
        if cohort is not None and not isinstance(cohort, CohortConfig):
            raise TypeError(
                "cohort must be a CohortConfig (or None); got "
                f"{type(cohort).__name__} — pass server.registry.CohortConfig")
        self.cohort_config = cohort
        self._cohort_active = cohort is not None
        self.registry: ClientRegistry | None = None
        self.registry_size: int | None = None
        if self._cohort_active:
            source = as_registry_source(datasets)
            self.registry = ClientRegistry(source, batch_size, local_steps, local_epochs)
            self.registry_size = source.n_clients
            # every round is slot-shaped; the registry keeps the O(N) facts
            datasets = []
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
        self.n_clients = cohort.slots if self._cohort_active else len(self.datasets)
        self.batch_size, self.metrics = batch_size, metrics
        self.local_epochs, self.local_steps = local_epochs, local_steps
        self.exchanger = exchanger or FullExchanger()
        # the compressed exchange runs inside aggregate, through a
        # CompressingStrategy wrapper; a config with no lossy stage wraps
        # nothing
        self.compression = compression
        if compression is not None and not isinstance(compression, CompressionConfig):
            raise TypeError(
                "compression must be a CompressionConfig (or None); got "
                f"{type(compression).__name__} — a duck-typed config "
                "would silently train uncompressed")
        if compression is not None and compression.enabled:
            if (getattr(self.exchanger, "wants_packet_payload", False)
                    or isinstance(self.exchanger, FixedLayerExchanger)):
                # a partial exchange's zeroed leaves would read as deltas
                raise ValueError(
                    "compression composes with full-model exchange only: "
                    f"{type(self.exchanger).__name__} ships partial "
                    "payloads whose zeroed/masked entries would read as "
                    "real deltas (it is already a compression scheme)")
            self.strategy = CompressingStrategy(self.strategy, compression)
        # buffered async (FedBuff): the schedule resolves to a static event
        # plan at fit(); None keeps the synchronous programs
        self.async_config = async_config
        if async_config is not None:
            if not isinstance(async_config, AsyncConfig):
                raise TypeError(
                    "async_config must be an AsyncConfig (or None); got "
                    f"{type(async_config).__name__} — a duck-typed config "
                    "would silently train synchronously")
            if self._cohort_active:
                # over the registry the buffer fills from the seated slots
                if async_config.buffer_size > cohort.slots:
                    raise ValueError(
                        f"async_config.buffer_size="
                        f"{async_config.buffer_size} exceeds the cohort "
                        f"slots ({cohort.slots}): the buffer "
                        "fills from the seated slots, so it could never "
                        "fill")
            elif async_config.buffer_size > len(self.datasets):
                raise ValueError(
                    f"async_config.buffer_size={async_config.buffer_size} "
                    f"exceeds the cohort ({len(self.datasets)} clients): the "
                    "buffer could never fill")
            if isinstance(self.strategy, FedBuff):
                # a pre-wrapped FedBuff must agree with the config
                fb = self.strategy
                if (fb.staleness_exponent != float(async_config.staleness_exponent)
                        or fb.max_staleness != async_config.max_staleness):
                    raise ValueError(
                        "the provided FedBuff wrapper's staleness "
                        f"parameters (exponent={fb.staleness_exponent}"
                        f", max_staleness={fb.max_staleness}) differ "
                        "from async_config's "
                        f"(exponent={async_config.staleness_exponent}, "
                        f"max_staleness={async_config.max_staleness}) — "
                        "the manifest records the config's values, so "
                        "they must match (simplest: pass the bare inner "
                        "strategy and let async_config do the wrapping)")
            else:
                # the outermost wrapper: the async programs call its mask
                # hook, and inner wrappers see the discounted fractional
                # mask as a sampled one
                self.strategy = FedBuff(
                    self.strategy, staleness_exponent=async_config.staleness_exponent,
                    max_staleness=async_config.max_staleness)
        self._async_active = async_config is not None
        # the last fit's event plan; the async programs, built at first use
        self._async_plan = None
        self._async_fns = None
        self._async_pending = None
        self._fault_plan = fault_plan
        if self._cohort_active:
            # the manager samples over the registry; the rounds are
            # slot-shaped
            self.client_manager = client_manager or FullParticipationManager(
                self.registry_size)
            if self.client_manager.n_clients != self.registry_size:
                raise ValueError(
                    f"client_manager covers {self.client_manager.n_clients} "
                    f"clients but the registry holds {self.registry_size}; "
                    "the sampling manager must be built over the registry")
            if (isinstance(self.client_manager, FullParticipationManager)
                    and cohort.slots < self.registry_size
                    and not self._async_active):
                # (async over the registry seats K of N clients by the
                # plan: full participation means every seated slot)
                raise ValueError(
                    f"full participation needs slots >= registry size "
                    f"({self.registry_size}); got slots={cohort.slots} — pass "
                    "a sampling manager (FixedFractionManager/"
                    "PoissonSamplingManager) whose worst-case draw fits the slots")
        else:
            self.client_manager = client_manager or FullParticipationManager(self.n_clients)
            if self.client_manager.n_clients != self.n_clients:
                raise ValueError(
                    f"client_manager covers {self.client_manager.n_clients} clients "
                    f"but {self.n_clients} datasets were given")
        # setup-time strategy <-> sampling-scheme check (the DP strategy
        # derives or checks its sampling fraction against the manager's)
        self.strategy.bind_client_manager(self.client_manager)
        if self._async_active:
            # the event programs fuse aggregate, eval and restart, and the
            # arrival schedule decides participation
            if not isinstance(self.client_manager, FullParticipationManager):
                raise ValueError(
                    "async_config derives participation from the buffer's "
                    "arrival schedule; a sampling client manager "
                    f"({type(self.client_manager).__name__}) is not "
                    "composable with buffered-async mode")
            if self._strategy_consumes_eval():
                raise ValueError(
                    "async_config is not composable with strategies that "
                    "consume per-round eval results on the host "
                    "(update_after_eval override): the async event "
                    "program fuses aggregate+eval+retrain in one dispatch")
            if self.train_data_provider is not None:
                raise ValueError(
                    "async_config is not composable with "
                    "train_data_provider: the async event programs bake "
                    "their data at dispatch time")
        if self._cohort_active:
            # bind again through a slot-count view, so a wrapper sizes its
            # per-client server rows [slots]; the checks above saw the real
            # manager
            self.strategy.bind_client_manager(
                _SlotManagerView(self.client_manager, cohort.slots))
            # the slot round evaluates the sampled cohort, and its data
            # lives in the registry
            if self._strategy_consumes_eval():
                raise ValueError(
                    "cohort=CohortConfig(...) is not composable with "
                    "strategies that consume per-round eval results on the "
                    "host (update_after_eval override): slot eval covers "
                    "the sampled cohort, not the population")
            if self.train_data_provider is not None:
                raise ValueError(
                    "cohort=CohortConfig(...) is not composable with "
                    "train_data_provider: per-round data lives in the "
                    "registry source — refresh it there")
        self.seed = seed
        self.rng = rng.PRNGKey(seed, self.device)
        self._host_rng_of = (self.rng, self.rng.cpu())
        self._registry_scatter_event: threading.Event | None = None
        # per-round summaries of cohort rounds (cohort_info), in round order
        self.round_metrics: list[dict] = []
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
                nx, ny = engine.data_rows(xs), engine.data_rows(ys)
                if nx != ny:
                    raise ValueError(
                        f"client {i}: x_{split} has {nx} rows but y_{split} has {ny}; "
                        "each client's features and labels must pair one-to-one.")
        if self._cohort_active:
            # a cohort round passes its own sample counts; no device banks:
            # a round's slot batches come from the registry
            self.sample_counts = torch.zeros((self.n_clients,), dtype=torch.float32,
                                             device=self.device)
            self._x_train_stack = self._y_train_stack = None
            self._x_val_stack = self._y_val_stack = None
        else:
            self.sample_counts = torch.tensor(
                [d.n_train for d in self.datasets], dtype=torch.float32,
                device=self.device)
            stack = engine.pad_and_stack_data
            self._x_train_stack = stack([d.x_train for d in self.datasets], "x_train",
                                        self.device)
            self._y_train_stack = stack([d.y_train for d in self.datasets], "y_train",
                                        self.device)
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
        if self._cohort_active:
            # client i's row derives from (proto, fold_in(init_rng, i + 1)),
            # the dense derivation; the strategy's rows from the slot
            # init's row 0 (checked client-symmetric)
            self.registry.bind_client_states(proto, init_rng)
            self.registry.bind_strategy_rows(self.strategy.state_rows(self.server_state))

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
        # through any wrapper (CompressingStrategy keeps the params inside)
        self.server_state = replace_global_params(self.strategy, self.server_state, params)
        self.client_states = dataclasses.replace(
            self.client_states, params=ptu.stack_clients([params] * self.n_clients))

    def set_train_data(self, xs: Sequence[Any], ys: Sequence[Any]) -> None:
        """Swap every client's training arrays (per-round data refresh).
        The new stacks must have the original shapes and dtypes."""
        if self._cohort_active:
            raise ValueError(
                "set_train_data swaps the dense device banks; a cohort-slot "
                "simulation has none — refresh the registry's data source "
                "instead (the next round's staging reads it)")
        new_x = engine.pad_and_stack_data(xs, "x_train", self.device)
        new_y = engine.pad_and_stack_data(ys, "y_train", self.device)
        for name, new, old in (("x_train", new_x, self._x_train_stack),
                               ("y_train", new_y, self._y_train_stack)):
            if engine.data_structure(new) != engine.data_structure(old):
                raise ValueError(
                    f"set_train_data: {name} pytree structure changed "
                    "(per-round refresh may not change the data layout)")
            for (path, a), (_, b) in zip(engine.leaves_with_paths(new),
                                         engine.leaves_with_paths(old)):
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise ValueError(
                        f"set_train_data: {name}{path} stack {tuple(a.shape)}/{a.dtype} "
                        f"must match the original {tuple(b.shape)}/{b.dtype} "
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
        # the fault plan's draws run only where it has specs of that kind:
        # without (or with an empty plan) the round is the plain one
        fault_plan, n_clients = self._fault_plan, self.n_clients
        inject_dropout = bool(fault_plan is not None and fault_plan.dropout_faults)
        inject_corruption = bool(fault_plan is not None and fault_plan.corruption_faults)

        def fit_round(server_state, client_states, batches, mask, round_idx,
                      val_batches, sample_counts=None):
            # a cohort round passes its slots' counts; others the baked ones
            if sample_counts is None:
                sample_counts = self.sample_counts
            payload = strategy.client_payload(server_state, round_idx)
            if inject_dropout:
                # a dropped client is an unsampled one: mask math only
                mask = mask * fault_plan.participation_factor(round_idx, n_clients,
                                                              mask.device)
            new_states, packets, losses, metrics = fit_clients(
                client_states, payload, batches, mask, val_batches)
            if inject_corruption:
                # the wire update is corrupted, not the client's state:
                # byzantine clients train honestly and lie upstream
                packets = fault_plan.corrupt_packets(packets, payload_params(payload),
                                                     round_idx, n_clients)
            # failed clients (non-finite loss) are excluded from aggregation
            finite = torch.isfinite(losses["backward"])
            results = FitResults(packets=packets,
                                 sample_counts=sample_counts,
                                 train_losses=losses, train_metrics=metrics,
                                 mask=mask * finite.to(mask.dtype))
            new_server_state = strategy.aggregate(server_state, results, round_idx)
            agg_losses, agg_metrics = fit_summary(losses, metrics, results.mask, sample_counts)
            return new_server_state, new_states, agg_losses, agg_metrics, losses

        def eval_round(server_state, client_states, batches, eval_counts):
            gp = strategy.client_payload(server_state, 0)
            new_states, losses, metrics = eval_clients(client_states, gp, batches)
            agg_losses = {k: (v * eval_counts).sum() / torch.clamp(eval_counts.sum(), min=1.0)
                          for k, v in losses.items()}
            agg_metrics = aggregate_metrics(metrics, eval_counts)
            return new_states, agg_losses, agg_metrics, losses, metrics

        return fit_round, eval_round

    # -- buffered-async programs (server/async_schedule.py) -------------
    def _build_async_fns(self):
        """(async_prologue, async_event) of the buffered-async mode.

        One buffer-fill event takes the place of a synchronous round:
        consume (the event's arrivals aggregate under the staleness-
        discounted mask times the finite screen of the buffered losses),
        eval (the fresh global, as a synchronous round evaluates), the
        optional test eval, then restart (the arrived clients pull the
        fresh global and train on data plan ``e+1`` from their post-eval
        states; their packets replace theirs in ``pending``, the others'
        stay buffered). The prologue trains every client on plan 1 into
        ``pending``. The clients run ``client_fit`` (the synchronous
        rounds' client) and ``eval_round``, so with every arrival at
        staleness 0 an event is a synchronous round bit for bit."""
        client_fit, _ = self._build_client_fns()
        fit_clients = vmap_clients(client_fit, (0, None, 0, 0, 0))
        eval_round = self._eval_round
        strategy = self.strategy
        fault_plan, n_clients = self._fault_plan, self.n_clients
        inject_dropout = bool(fault_plan is not None and fault_plan.dropout_faults)
        inject_corruption = bool(fault_plan is not None and fault_plan.corruption_faults)
        sample_counts = self.sample_counts
        # over the registry a slot's count is its occupant's, and a packet
        # is consumed after its trainer may have left the seat: the counts
        # ride the pending buffer with the packet
        cohort_active = self._cohort_active
        async_mask = getattr(strategy, "async_aggregation_mask", None)
        if async_mask is not None:
            # a hook with the 2-argument signature keeps working: the
            # exponent is passed (positionally) only where it is taken
            params = inspect.signature(async_mask).parameters.values()
            positional = sum(1 for p in params
                             if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))
            takes_exponent = positional >= 3 or any(p.kind == p.VAR_POSITIONAL
                                                    for p in params)
            if not takes_exponent:
                raw_mask = async_mask
                async_mask = lambda arr, stal, _exp: raw_mask(arr, stal)  # noqa: E731
            elif not hasattr(strategy, "staleness_exponent"):
                # it would receive the 0.0 fallback: no discount at all
                raise ValueError(
                    f"{type(strategy).__name__}.async_aggregation_mask "
                    "accepts an exponent argument but the strategy exposes "
                    "no 'staleness_exponent' attribute for the async round "
                    "programs to feed it from; expose the attribute (as "
                    "FedBuff does), or drop the parameter to use internal "
                    "defaults")

        def train_wave(server_state, client_states, batches, train_mask, round_idx,
                       val_batches, wave_counts=None):
            """One training wave on data plan ``round_idx``: the masked
            clients pull the payload and train, and the wire packets are
            corrupted with the synchronous round's draws. Returns the new
            client stack and the wave's pending pieces."""
            payload = strategy.client_payload(server_state, round_idx)
            new_states, packets, losses, metrics = fit_clients(
                client_states, payload, batches, train_mask, val_batches)
            if inject_corruption:
                packets = fault_plan.corrupt_packets(packets, payload_params(payload),
                                                     round_idx, n_clients)
            pending = {"packets": packets, "losses": losses, "metrics": metrics}
            if cohort_active:
                pending["sample_counts"] = (sample_counts if wave_counts is None
                                            else wave_counts)
            return new_states, pending

        def merge_pending(old, new, arrivals):
            """An arrived client's row takes its fresh wave output; every
            other row stays buffered (a NaN packet of a non-arrived row
            never crosses: ``where``, not arithmetic)."""
            def sel(n, o):
                return torch.where(arrivals.reshape((-1,) + (1,) * (n.ndim - 1)) > 0, n, o)

            return ptu.tree_map(sel, new, old)

        def async_prologue(server_state, client_states, batches, val_batches,
                           wave_counts=None):
            ones = torch.ones((n_clients,), dtype=torch.float32,
                              device=ptu.tree_leaves(client_states)[0].device)
            return train_wave(server_state, client_states, batches, ones, 1, val_batches,
                              wave_counts)

        def async_event(server_state, client_states, pending, batches_next, arrivals,
                        staleness, event_idx, val_batches, val_counts, staleness_exponent,
                        test_batches=None, test_counts=None, wave_counts=None):
            # -- consume: the buffer under the discounted mask -------------
            arr = arrivals
            if inject_dropout:
                # a dropped update is lost on the wire: it fills its slot
                # but aggregates with weight 0 (its client restarts)
                arr = arr * fault_plan.participation_factor(event_idx, n_clients,
                                                            arr.device)
            disc_mask = (async_mask(arr, staleness, staleness_exponent)
                         if async_mask is not None else arr)
            # the finite screen reads the buffered losses, not the packets
            finite = torch.isfinite(pending["losses"]["backward"])
            agg_mask = disc_mask * finite.to(disc_mask.dtype)
            counts = pending["sample_counts"] if cohort_active else sample_counts
            results = FitResults(packets=pending["packets"], sample_counts=counts,
                                 train_losses=pending["losses"],
                                 train_metrics=pending["metrics"], mask=agg_mask)
            new_server = strategy.aggregate(server_state, results, event_idx)
            agg_losses, agg_metrics = fit_summary(pending["losses"], pending["metrics"],
                                                  results.mask, counts)
            # -- eval: the fresh global, as a synchronous round -----------
            client_states, ev_losses, ev_metrics, _, _ = eval_round(
                new_server, client_states, val_batches, val_counts)
            out = {"fit_losses": agg_losses, "fit_metrics": agg_metrics,
                   "per_client_fit_losses": pending["losses"],
                   "eval_losses": ev_losses, "eval_metrics": ev_metrics}
            if test_batches is not None:
                client_states, out["test_losses"], out["test_metrics"] = eval_round(
                    new_server, client_states, test_batches, test_counts)[:3]
            # -- restart: the arrived clients train for a later event -----
            # on data plan event_idx + 1 and its fault draws, the streams a
            # synchronous round event_idx + 1 would use
            client_states, fresh = train_wave(new_server, client_states, batches_next,
                                              arrivals, event_idx + 1, val_batches,
                                              wave_counts)
            return new_server, client_states, merge_pending(pending, fresh, arrivals), out

        return async_prologue, async_event

    def _async_programs(self):
        """The async programs, built once a simulation."""
        if self._async_fns is None:
            self._async_fns = self._build_async_fns()
        return self._async_fns

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
                [engine.data_rows(d.x_val) for d in self.datasets])
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
                [engine.data_rows(d.x_test) for d in self.datasets])
        return self._test_cache

    # ------------------------------------------------------------------
    def _chunk_ineligibility(self) -> str | None:
        """Why ``fit`` may not take the chunked route (None: eligible):
        anything that needs the host between rounds keeps it pipelined."""
        if self._cohort_active and self._async_active:
            return ("buffered-async over the registry swaps slot "
                    "occupants host-side per event (pipelined "
                    "per-event path)")
        if self._cohort_active and getattr(self.client_manager, "draw_cohort", None) is None:
            # a cohort chunks with its draw on the device, the window
            # exchange in place of the per-round gather and scatter
            return (f"{type(self.client_manager).__name__} provides no "
                    "in-graph draw_cohort; the cohort draw must run on "
                    "the host every round")
        if self.train_data_provider is not None:
            return "train_data_provider needs a host data refresh every round"
        if not self.failure_policy.accept_failures:
            return "accept_failures=False must be able to terminate mid-run"
        if self._strategy_consumes_eval():
            return ("strategy overrides update_after_eval (host-side "
                    "per-round eval consumption)")
        return None

    def _strategy_consumes_eval(self) -> bool:
        """Whether the strategy reads each round's per-client eval on the
        host (overrides ``update_after_eval``; a wrapper says for its inner
        strategy through ``overrides_update_after_eval``)."""
        overrides = getattr(self.strategy, "overrides_update_after_eval", None)
        if overrides is None:
            overrides = (type(self.strategy).update_after_eval
                         is not Strategy.update_after_eval)
        return bool(overrides)

    def _select_execution_mode(self, n_rounds: int) -> tuple[str, str]:
        """(mode, reason) for this ``fit`` call: ``"auto"`` takes the
        chunked route unless something needs the host between rounds."""
        if n_rounds < 1:
            return EXEC_PIPELINED, "n_rounds < 1 (no rounds to run)"
        if self.execution_mode == "pipelined":
            return EXEC_PIPELINED, "forced by execution_mode='pipelined'"
        why = self._chunk_ineligibility()
        if self.execution_mode == "chunked":
            if why:
                raise ValueError(f"execution_mode='chunked' but {why}")
            return EXEC_CHUNKED, "forced by execution_mode='chunked'"
        if why:
            return EXEC_PIPELINED, why
        return EXEC_CHUNKED, "auto: no per-round host dependencies"

    def fit(self, n_rounds: int) -> list[RoundRecord]:
        """Run ``n_rounds`` more rounds (numbered after those already in
        ``history``) through the chunked or the pipelined route
        (``execution_mode``); under ``async_config`` each round is a
        buffer-fill event of a fresh plan. Returns the whole history.
        ``fit(0)`` runs nothing."""
        mode, reason = self._select_execution_mode(n_rounds)
        logging.getLogger(__name__).info("fit: execution_mode=%s (%s)", mode, reason)
        for rep in self.reporters:
            rep.report({"host_type": "server", "fit_start": time.time(),
                        "num_rounds": n_rounds, "execution_mode": mode,
                        "execution_mode_reason": reason})
        if n_rounds >= 1:
            first = len(self.history) + 1
            last = first + n_rounds - 1
            if self._async_active:
                self._fit_async(n_rounds, mode, first)
            elif self._cohort_active:
                (self._fit_cohort_chunked if mode == EXEC_CHUNKED
                 else self._fit_cohort)(first, last)
            elif mode == EXEC_CHUNKED:
                self._fit_chunked(first, last)
            else:
                self._fit_pipelined(first, last)
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
        round order. Launches nothing on the device. A cohort round's pull
        also brought its updated rows: they go into the registry first,
        then the producer's next gather may run."""
        host = work.pull.result()
        registry_rows = host.pop("_registry_rows", None)
        cohort_info = work.cohort_info
        if registry_rows is not None:
            meta = work.cohort_meta
            s0 = time.perf_counter()
            self.registry.scatter(meta["idx"], meta["valid"], registry_rows["client_states"],
                                  registry_rows.get("strategy_rows"))
            scatter_ms = (time.perf_counter() - s0) * 1e3
            meta["scatter_event"].set()
            cohort_info = self._cohort_info(meta, scatter_ms, work.pull)
        try:
            self.failure_policy.check(host["per_client_fit_losses"], host["mask"])
        except ClientFailuresError as cf:
            cf.round = work.round
            if work.cohort_meta is not None:
                # a cohort round fails by slot: name the registry ids
                ids = np.asarray(work.cohort_meta["idx"])
                cf.registry_clients = [int(ids[c]) for c in cf.clients if 0 <= c < len(ids)]
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
        self._record_round_metrics(work.round, cohort_info, work.async_info,
                                   work.event if work.event is not None else work.round)
        for rep in self.reporters:
            rep.report({"fit_losses": rec.fit_losses, "fit_metrics": rec.fit_metrics,
                        "eval_losses": rec.eval_losses, "eval_metrics": rec.eval_metrics,
                        "fit_elapsed_s": rec.fit_elapsed_s,
                        "eval_elapsed_s": rec.eval_elapsed_s,
                        "execution_mode": EXEC_PIPELINED}, round=work.round)

    def _record_round_metrics(self, rnd: int, cohort_info: dict | None = None,
                              async_info: dict | None = None,
                              fault_round: int | None = None) -> None:
        """A round's summary, kept in ``round_metrics`` where a cohort, an
        async event or a fault plan with client faults has something to
        say: the cohort facts (slots, valid, registry size and dirty rows,
        the staging, gather and scatter walls, staged and pulled bytes, the
        pull's device ms, rounds a dispatch, where the draw ran), the
        event's plan facts (``AsyncEventPlan.summarize_event`` and the
        arrived updates' ``_staleness_values``), and under ``"fault"`` the
        plan's ``summarize_round`` at the index the programs drew at
        (``fault_round``: an async event's own index)."""
        faults = self._fault_plan is not None and self._fault_plan.has_client_faults
        if cohort_info is None and async_info is None and not faults:
            return
        entry = {"round": rnd, **(cohort_info or {}), **(async_info or {})}
        if faults:
            entry["fault"] = self._fault_plan.summarize_round(
                rnd if fault_round is None else fault_round, self.n_clients)
        self.round_metrics.append(entry)

    # -- the chunked route ---------------------------------------------
    def _chunk_plans(self, start_round: int, k: int, mask=None):
        """Rounds ``[start_round, start_round + k)``'s index plans, moved to
        the device in one copy each (``[k, C, S, B]``, ``[k, C, S]``), and
        their ``[k, C]`` masks: drawn from ``fold_in(rng, 2000 + r)`` as the
        pipelined rounds draw them, or ``mask`` (``[C]`` or ``[k, C]``)."""
        plans = [self._round_plan(start_round + i) for i in range(k)]
        idx, em, sm = (engine.host_to_device(np.stack([p[j] for p in plans]).astype(dtype),
                                             self.device)
                       for j, dtype in enumerate((np.int64, np.float32, np.float32)))
        if mask is None:
            masks = torch.stack([
                self.client_manager.sample(rng.fold_in(self.rng, 2000 + r), r)
                for r in range(start_round, start_round + k)])
        else:
            mask = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
            if tuple(mask.shape) not in ((k, self.n_clients), (self.n_clients,)):
                raise ValueError(
                    f"fit_chunk mask must have shape ({k}, {self.n_clients}) "
                    f"or ({self.n_clients},); got {tuple(mask.shape)}")
            masks = mask if mask.ndim == 2 else mask.expand(k, self.n_clients)
        return idx, em, sm, masks

    def make_chunked_fit(self):
        """The chunk of ``fit_chunk``: ``chunk(server_state, client_states,
        x_stack, y_stack, idx, em, sm, masks, start_round, val_batches) ->
        (server_state, client_states, losses, metrics)``, the last two
        stacked ``[k]`` a key. Its ``k`` rounds run ``_fit_round`` back to
        back, each on batches gathered from the resident stacks by its
        ``[k, ...]`` plan row, with nothing pulled to the host in between:
        the JAX package's ``lax.scan`` over rounds, dispatched from this
        thread. Each round's math is ``_fit_round``'s on the same plans and
        masks, so the trajectory equals the per-round path's bit for bit.
        The failure screen, records and reports do not run inside it."""

        def chunk(server_state, client_states, x_stack, y_stack, idx, em, sm, masks,
                  start_round, val_batches):
            losses, metrics = [], []
            for i in range(idx.shape[0]):
                batches = engine.gather_batches(x_stack, y_stack, idx[i], em[i], sm[i])
                server_state, client_states, round_losses, round_metrics, _ = (
                    self._fit_round(server_state, client_states, batches, masks[i],
                                    start_round + i, val_batches))
                losses.append(round_losses)
                metrics.append(round_metrics)
            return (server_state, client_states, ptu.stack_clients(losses),
                    ptu.stack_clients(metrics))

        return chunk

    def fit_chunk(self, start_round: int, k: int, mask=None):
        """Run rounds ``[start_round, start_round + k)`` as one chunk; returns
        the per-round ``(losses, metrics)`` stacked ``[k]`` and updates the
        simulation's state (no ``RoundRecord``, no report). Each round's mask
        is drawn as ``fit`` draws it, unless ``mask`` (``[clients]`` or
        ``[k, clients]``) pins it. Refuses a ``train_data_provider``: the
        chunk trains on the stacks it was given."""
        if self.train_data_provider is not None:
            raise ValueError(
                "fit_chunk cannot honor train_data_provider (per-round data "
                "refresh happens on the host, between dispatches); use "
                "fit(), or chunk with the provider disabled if a frozen "
                "bank is acceptable")
        idx, em, sm, masks = self._chunk_plans(start_round, k, mask)
        self.server_state, self.client_states, losses, metrics = self.make_chunked_fit()(
            self.server_state, self.client_states, self._x_train_stack, self._y_train_stack,
            idx, em, sm, masks, start_round, self._val_batches()[0])
        return losses, metrics

    def _make_chunked_fit_with_eval(self):
        """``fit``'s chunk: each round runs what a pipelined round dispatches
        (``_fit_round``, the val ``_eval_round`` and, where every client has
        one, the test split's), and its outputs stack ``[k]`` on the
        device for the chunk's one pull."""

        def chunk(server_state, client_states, x_stack, y_stack, idx, em, sm, masks,
                  start_round, val_batches, val_counts, test_batches=None, test_counts=None):
            outs = []
            for i in range(idx.shape[0]):
                batches = engine.gather_batches(x_stack, y_stack, idx[i], em[i], sm[i])
                server_state, client_states, fit_losses, fit_metrics, per_fit = (
                    self._fit_round(server_state, client_states, batches, masks[i],
                                    start_round + i, val_batches))
                client_states, eval_losses, eval_metrics, _, _ = self._eval_round(
                    server_state, client_states, val_batches, val_counts)
                out = {"fit_losses": fit_losses, "fit_metrics": fit_metrics,
                       "per_client_fit_losses": per_fit,
                       "eval_losses": eval_losses, "eval_metrics": eval_metrics}
                if test_batches is not None:
                    client_states, out["test_losses"], out["test_metrics"] = (
                        self._eval_round(server_state, client_states, test_batches,
                                         test_counts)[:3])
                outs.append(out)
            return server_state, client_states, ptu.stack_clients(outs)

        return chunk

    def _rounds_per_dispatch(self, n_rounds: int, start_round: int = 1) -> int:
        """Rounds in the chunked route's next chunk: all that remain up to
        round ``n_rounds`` (the port has no state checkpointer whose cadence
        would cut it)."""
        return max(n_rounds - start_round + 1, 1)

    def _fit_chunked(self, first: int, last: int) -> None:
        """Rounds ``first..last`` through the chunked route: each chunk
        dispatches its rounds back to back, then one ``HostPull`` brings
        every round's results over and ``_chunked_epilogue`` records them."""
        s = first
        while s <= last:
            k = self._rounds_per_dispatch(last, s)
            self._run_sync_chunk(s, k)
            s += k

    def _run_sync_chunk(self, start_round: int, k: int) -> None:
        """Dispatch rounds ``[start_round, start_round + k)`` as one chunk
        and run their host epilogue."""
        t_start = time.time()
        val_batches, val_counts = self._val_batches()
        test = self._test_batches()
        idx, em, sm, masks = self._chunk_plans(start_round, k)
        self.server_state, self.client_states, outs = self._make_chunked_fit_with_eval()(
            self.server_state, self.client_states, self._x_train_stack, self._y_train_stack,
            idx, em, sm, masks, start_round, val_batches, val_counts, *(test or ()))
        stacked = HostPull({**outs, "mask": masks}).result()  # the chunk's one pull
        per_round_s = (time.time() - t_start) / max(k, 1)
        self._chunked_epilogue(k, stacked, stacked.pop("mask"), per_round_s,
                               start_round=start_round)

    def _chunked_epilogue(self, n_rounds: int, stacked: dict, masks_np: np.ndarray,
                          per_round_s: float, start_round: int = 1,
                          cohort_infos: list[dict] | None = None,
                          async_plan=None) -> None:
        """Each round of a chunk on the host, from the stacked pull: the
        failure screen (it logs; ``accept_failures`` is True on this
        route), the ``RoundRecord`` with ``fit_elapsed_s`` the chunk's wall
        amortised a round and ``eval_elapsed_s`` 0 (no separate eval wall),
        the cohort facts of each round (``cohort_infos``), an async chunk's
        event facts (``async_plan``: the chunk is the plan's every event),
        and the reports."""
        for i in range(n_rounds):
            rnd = start_round + i
            self.failure_policy.check(
                {k: v[i] for k, v in stacked["per_client_fit_losses"].items()}, masks_np[i])
            floats = lambda d, prefix="": {  # noqa: E731
                f"{prefix}{k}": float(v[i]) for k, v in d.items()}
            eval_losses, eval_metrics = (floats(stacked["eval_losses"]),
                                         floats(stacked["eval_metrics"]))
            if "test_losses" in stacked:
                eval_losses.update(floats(stacked["test_losses"], "test - "))
                eval_metrics.update(floats(stacked["test_metrics"], "test - "))
            rec = RoundRecord(round=rnd, fit_losses=floats(stacked["fit_losses"]),
                              fit_metrics=floats(stacked["fit_metrics"]),
                              eval_losses=eval_losses, eval_metrics=eval_metrics,
                              fit_elapsed_s=per_round_s, eval_elapsed_s=0.0)
            self.history.append(rec)
            event = i + 1 if async_plan is not None else rnd
            self._record_round_metrics(
                rnd, cohort_infos[i] if cohort_infos is not None else None,
                self._async_event_info(async_plan, event - 1)
                if async_plan is not None else None, event)
            for rep in self.reporters:
                rep.report({"fit_losses": rec.fit_losses, "fit_metrics": rec.fit_metrics,
                            "eval_losses": rec.eval_losses, "eval_metrics": rec.eval_metrics,
                            "fit_elapsed_s": rec.fit_elapsed_s,
                            "eval_elapsed_s": rec.eval_elapsed_s,
                            "execution_mode": EXEC_CHUNKED}, round=rnd)

    # -- the cohort-slot routes (server/registry.py) ---------------------
    def _to_device(self, tree):
        return ptu.tree_map(lambda a: engine.host_to_device(np.asarray(a), self.device), tree)

    def _cohort_info(self, meta: dict, scatter_ms: float, pull: HostPull) -> dict:
        """One round's cohort facts, as JAX's consumer builds them, and the
        round's pulled bytes and the pull's device ms (None on the CPU)."""
        k = meta.get("rounds_per_dispatch", 1)
        return {"cohort_slots": self.n_clients, "cohort_valid": meta["valid"],
                "registry_size": self.registry_size,
                "registry_dirty_rows": self.registry.dirty_rows,
                "stage_ms": round(meta["stage_ms"] / k, 3),
                "gather_ms": round(meta["gather_ms"] / k, 3),
                "scatter_ms": round(scatter_ms / k, 3),
                "staged_bytes": int(meta["staged_bytes"] // k),
                "pull_bytes": int(pull.nbytes // k),
                "pull_ms": None if pull.device_ms is None else round(pull.device_ms / k, 3),
                "rounds_per_dispatch": k,
                "cohort_draw": meta.get("cohort_draw", "host")}

    @property
    def _host_rng(self) -> torch.Tensor:
        """``self.rng`` on the CPU, for the cohort's host draws: copied once
        a key object (the constructor's copy waits for nothing), so the
        host draws follow ``rng`` even when it is reassigned."""
        key, host = self._host_rng_of
        if key is not self.rng:
            key = self.rng
            self._host_rng_of = (key, key.cpu())
        return self._host_rng_of[1]

    def _stage_cohort_round(self, rnd: int) -> dict:
        """One round's slot data, staged: the cohort's ids from the dense
        path's stream (``fold_in(rng, 2000 + round)``, the CPU copy), the
        registry's ``[K, ...]`` numpy tensors, and their copies to the
        device. A function of (key, round, registry data) alone, so it runs
        on the prefetcher's thread; the clients' state rows are absent (they
        wait for the previous round's scatter)."""
        idx, valid = self.client_manager.sample_indices(
            rng.fold_in(self._host_rng, 2000 + rnd), rnd, self.n_clients)
        t0 = time.perf_counter()
        staged = self.registry.stage_round(idx, valid, self._base_entropy, rnd)
        for name in ("batches", "val_batches", "mask", "sample_counts", "val_counts"):
            staged[name] = self._to_device(staged[name])
        staged["stage_ms"] = (time.perf_counter() - t0) * 1e3
        return staged

    def _await_registry_scatter(self) -> None:
        """Wait until the consumer has stored the previous round's rows in
        the registry (the read-after-write edge of the gather and scatter),
        raising the consumer's error if its epilogue failed meanwhile."""
        ev = self._registry_scatter_event
        if ev is None:
            return
        while not ev.wait(0.05):
            if self._consumer is not None:
                self._consumer.raise_pending()
        self._registry_scatter_event = None

    def _gather_cohort_rows(self, idx: np.ndarray) -> float:
        """Install the ids' client rows as ``client_states`` and their
        strategy rows in ``server_state``; returns the host ms it took."""
        g0 = time.perf_counter()
        reg = self.registry
        self.client_states = rows_to_device(reg.gather_client_states(idx),
                                            reg.client_dtypes, self.device)
        srows = reg.gather_strategy_rows(idx)
        if srows is not None:
            self.server_state = self.strategy.scatter_state_rows(
                self.server_state, rows_to_device(srows, reg.strategy_dtypes, self.device))
        return (time.perf_counter() - g0) * 1e3

    def _fit_cohort(self, first: int, last: int) -> None:
        """Rounds ``first..last`` of a cohort through the pipelined route:
        the prefetcher stages round r+1's slot data while round r runs; each
        round gathers its clients' rows once round r-1's are stored, and
        its epilogue (the pull, the registry scatter, the record) runs on
        the consumer."""
        self._fit_last_round = last
        self._registry_scatter_event = None
        consumer = self._consumer = RoundConsumer(maxsize=self.pipeline_depth)
        prefetcher = self._prefetcher = RoundPrefetcher(self)
        try:
            prefetcher.schedule(first)
            for rnd in range(first, last + 1):
                consumer.raise_pending()
                self._run_cohort_round(rnd)
            consumer.flush()
        finally:
            consumer.close()
            prefetcher.close()
            self._consumer = self._prefetcher = None
            self._registry_scatter_event = None

    def _run_cohort_round(self, rnd: int) -> None:
        """The producer's half of a cohort round: the staged slot data, the
        rows gathered after the previous scatter, fit and eval dispatched,
        and the epilogue (its pull carries the updated rows) handed to the
        consumer."""
        consumer, prefetcher = self._consumer, self._prefetcher
        t0 = time.time()
        staged = prefetcher.take(rnd) if prefetcher is not None else self._stage_cohort_round(rnd)
        if prefetcher is not None and rnd < self._fit_last_round:
            # round r+1's data has no state dependency; only the row
            # gather below waits for round r's scatter
            prefetcher.schedule(rnd + 1)
        self._await_registry_scatter()
        idx, valid = staged["idx"], staged["valid"]
        gather_ms = self._gather_cohort_rows(idx)
        (self.server_state, self.client_states, fit_losses, fit_metrics,
         per_client_fit_losses) = self._fit_round(
            self.server_state, self.client_states, staged["batches"], staged["mask"], rnd,
            staged["val_batches"], staged["sample_counts"])
        t1 = time.time()
        self.client_states, eval_losses, eval_metrics, _, _ = self._eval_round(
            self.server_state, self.client_states, staged["val_batches"], staged["val_counts"])
        results = {"mask": staged["mask"], "fit_losses": fit_losses, "fit_metrics": fit_metrics,
                   "per_client_fit_losses": per_client_fit_losses,
                   "eval_losses": eval_losses, "eval_metrics": eval_metrics,
                   # the updated rows ride the round's one pull
                   "_registry_rows": {"client_states": self.client_states,
                                      "strategy_rows": self.strategy.state_rows(
                                          self.server_state)}}
        scatter_event = self._registry_scatter_event = threading.Event()
        work = _RoundWork(
            round=rnd, pull=HostPull(results), fit_elapsed_s=t1 - t0,
            eval_elapsed_s=time.time() - t1,
            cohort_meta={"idx": idx, "valid": valid, "stage_ms": staged["stage_ms"],
                         "gather_ms": gather_ms, "staged_bytes": staged["staged_bytes"],
                         "scatter_event": scatter_event, "rounds_per_dispatch": 1,
                         "cohort_draw": "host"})
        if consumer is None:  # no pipeline: the epilogue inline
            self._finish_round(work)
            return
        consumer.submit_round(rnd, functools.partial(self._finish_round, work))
        if not self.failure_policy.accept_failures:
            consumer.flush()

    # -- the chunked cohort route (draws on the device, window exchange) -
    def _make_cohort_chunk(self):
        """The chunked cohort route's chunk: its rounds dispatched back to
        back, each drawing its cohort on the device (``draw_cohort`` of
        ``fold_in(rng, 2000 + round)``, equal to the host draw), finding
        the ids' rows in the staged window (``searchsorted``; a pad slot
        repeats a real id), running the slot round's fit and eval, and
        writing the post-eval rows (client states and strategy rows) back
        into the window, pad slots into a scratch row that is dropped. The
        outputs carry each round's drawn ids and count for the check at the
        pull. JAX's ``lax.scan`` body, without the scan."""
        draw = self.client_manager.draw_cohort
        slots = self.n_clients
        has_srows = self.registry.has_strategy_rows
        strategy = self.strategy

        def chunk(server_state, client_states, w_client, w_srows, base_rng, window_ids,
                  batches, masks, sample_counts, val_batches, val_counts, start_round):
            w = window_ids.shape[0]
            slot_ids = torch.arange(slots, device=window_ids.device)
            # one scratch row past the window takes the pad slots' writes
            scratch = lambda t: torch.cat([t, t[:1]])  # noqa: E731
            w_client = ptu.tree_map(scratch, w_client)
            w_srows = ptu.tree_map(scratch, w_srows) if has_srows else None
            outs = []
            for i in range(masks.shape[0]):
                r = start_round + i
                ids, valid = draw(rng.fold_in(base_rng, 2000 + r), r, slots)
                pos = torch.searchsorted(window_ids, ids.to(window_ids.dtype))
                client_states = ptu.tree_map(lambda t: t[pos], w_client)
                if has_srows:
                    server_state = strategy.scatter_state_rows(
                        server_state, ptu.tree_map(lambda t: t[pos], w_srows))
                at = lambda tree: ptu.tree_map(lambda t: t[i], tree)  # noqa: E731
                server_state, client_states, fit_losses, fit_metrics, per_fit = (
                    self._fit_round(server_state, client_states, at(batches), masks[i], r,
                                    at(val_batches), sample_counts[i]))
                client_states, eval_losses, eval_metrics, _, _ = self._eval_round(
                    server_state, client_states, at(val_batches), val_counts[i])
                outs.append({"fit_losses": fit_losses, "fit_metrics": fit_metrics,
                             "per_client_fit_losses": per_fit,
                             "eval_losses": eval_losses, "eval_metrics": eval_metrics,
                             "cohort_ids": ids, "cohort_valid": valid})
                dest = torch.where(slot_ids < valid, pos, w)
                w_client = ptu.tree_map(lambda wt, c: wt.index_copy(0, dest, c),
                                        w_client, client_states)
                if has_srows:
                    w_srows = ptu.tree_map(lambda wt, c: wt.index_copy(0, dest, c),
                                           w_srows, strategy.state_rows(server_state))
            cut = lambda t: t[:w]  # noqa: E731
            return (server_state, client_states, ptu.tree_map(cut, w_client),
                    ptu.tree_map(cut, w_srows) if has_srows else None,
                    ptu.stack_clients(outs))

        return chunk

    def _stage_cohort_chunk(self, start_round: int, k: int) -> dict:
        """One chunk's staging: rounds ``[start_round, start_round + k)``
        drawn on the host (the mirror of the device draw; an overflow
        raises here, before any device work), their slot tensors stacked,
        the chunk's window built, and the lot copied to the device; on the
        prefetcher's thread. The window's state rows are gathered later, by
        ``_run_cohort_chunk``."""
        draws = [self.client_manager.sample_indices(
            rng.fold_in(self._host_rng, 2000 + r), r, self.n_clients)
            for r in range(start_round, start_round + k)]
        t0 = time.perf_counter()
        staged = self.registry.stage_chunk(draws, self._base_entropy, start_round)
        staged["window_ids"], staged["w_real"] = self.registry.chunk_window(
            [d[0] for d in draws], [d[1] for d in draws], self.n_clients, k)
        staged["mask_np"] = staged["mask"]
        for name in ("batches", "val_batches", "mask", "sample_counts", "val_counts"):
            staged[name] = self._to_device(staged[name])
        staged["window_ids_dev"] = engine.host_to_device(staged["window_ids"], self.device)
        staged["stage_ms"] = (time.perf_counter() - t0) * 1e3
        return staged

    def _fit_cohort_chunked(self, first: int, last: int) -> None:
        """Rounds ``first..last`` of a cohort through the chunked route: a
        chunk is every round that remains (no state checkpointer cuts it),
        staged by the prefetcher; the next chunk's staging would overlap
        this one's device work."""
        prefetcher = self._prefetcher = RoundPrefetcher(self)
        try:
            s = first
            prefetcher.schedule_chunk(s, self._rounds_per_dispatch(last, s))
            while s <= last:
                k = self._rounds_per_dispatch(last, s)
                staged = prefetcher.take_chunk(s, k)
                if s + k <= last:
                    prefetcher.schedule_chunk(s + k, self._rounds_per_dispatch(last, s + k))
                self._run_cohort_chunk(s, k, staged)
                s += k
        finally:
            prefetcher.close()
            self._prefetcher = None

    def _run_cohort_chunk(self, start_round: int, k: int, staged: dict) -> None:
        """One cohort chunk: the window's rows gathered (after the previous
        chunk's scatter: same thread), its rounds dispatched, one pull of
        the outputs and the window, the device draws checked against the
        host's, the window's rows stored in the registry, and the shared
        chunked epilogue with each round's cohort facts."""
        t_start = time.time()
        chunk = self._make_cohort_chunk()
        reg = self.registry
        g0 = time.perf_counter()
        w_client_h, w_srows_h = reg.gather_window(staged["window_ids"])
        w_client = rows_to_device(w_client_h, reg.client_dtypes, self.device)
        w_srows = (rows_to_device(w_srows_h, reg.strategy_dtypes, self.device)
                   if w_srows_h is not None else None)
        gather_ms = (time.perf_counter() - g0) * 1e3
        self.server_state, self.client_states, w_client, w_srows, outs = chunk(
            self.server_state, self.client_states, w_client, w_srows, self.rng,
            staged["window_ids_dev"], staged["batches"], staged["mask"],
            staged["sample_counts"], staged["val_batches"], staged["val_counts"], start_round)
        pull = HostPull({"outs": outs, "client_rows": w_client, "strategy_rows": w_srows})
        host = pull.result()  # the chunk's one pull
        stacked = host["outs"]
        # the window was built from the host draws: a device draw that
        # differs would gather and store the wrong rows
        ids_dev = np.asarray(stacked.pop("cohort_ids"), np.int64)
        valid_dev = np.asarray(stacked.pop("cohort_valid"), np.int64)
        ids_host = np.asarray(staged["idx"], np.int64)
        valid_host = np.asarray(staged["valid"], np.int64)
        if not (np.array_equal(ids_dev, ids_host) and np.array_equal(valid_dev, valid_host)):
            raise RuntimeError(
                "in-graph cohort draw diverged from the host sampler for "
                f"rounds [{start_round}, {start_round + k}): the "
                f"{type(self.client_manager).__name__}.draw_cohort "
                "contract (bit-identical to sample_indices) is broken — "
                "the chunk's window exchange cannot be trusted")
        s0 = time.perf_counter()
        reg.scatter(staged["window_ids"], int(staged["w_real"]), host["client_rows"],
                    host["strategy_rows"] if w_srows_h is not None else None)
        scatter_ms = (time.perf_counter() - s0) * 1e3
        per_round_s = (time.time() - t_start) / max(k, 1)
        meta = {"stage_ms": staged["stage_ms"], "gather_ms": gather_ms,
                "staged_bytes": staged["staged_bytes"], "rounds_per_dispatch": k,
                "cohort_draw": "in_graph"}
        infos = [self._cohort_info({**meta, "valid": int(valid_host[i])}, scatter_ms, pull)
                 for i in range(k)]
        self._chunked_epilogue(k, stacked, np.asarray(staged["mask_np"]), per_round_s,
                               start_round=start_round, cohort_infos=infos)

    # -- buffered-async routes (server/async_schedule.py) ----------------
    @staticmethod
    def _async_event_info(plan, i: int) -> dict:
        """Event ``i + 1``'s plan facts for its record, and the arrived
        updates' staleness values (``_staleness_values``; JAX's histogram
        reads them)."""
        info = plan.summarize_event(i)
        info["_staleness_values"] = [float(v) for v in plan.staleness[i][plan.arrivals[i] > 0]]
        return info

    def _staleness_exponent_input(self) -> torch.Tensor:
        """The staleness exponent as a program input, read from the live
        (outermost) strategy at every dispatch, so a rebind of
        ``strategy.staleness_exponent`` reaches the next event; 0.0 for a
        strategy without it (a 2-argument mask hook never receives it). A
        0-d CPU tensor: torch reads it as a scalar on the card, no copy."""
        return torch.tensor(float(getattr(self.strategy, "staleness_exponent", 0.0)),
                            dtype=torch.float32)

    def _fit_async(self, n_events: int, mode: str, first: int) -> None:
        """``fit``'s buffered-async route: a fresh static plan over this
        call's ``n_events`` events (the async config's seed, the fault
        plan's stragglers, the cohort), then its events from a new prologue,
        numbered ``first..`` in ``history``."""
        if self._cohort_active:
            plan = build_registry_event_plan(self.async_config, n_events, self.n_clients,
                                             self.registry_size, self._fault_plan)
        else:
            plan = build_event_plan(self.async_config, n_events, self.n_clients,
                                    self._fault_plan)
        self._async_plan = plan
        if self._cohort_active:
            # seat swaps are host work between events: pipelined only
            self._fit_async_registry(plan, first)
        elif mode == EXEC_CHUNKED:
            self._fit_async_chunked(plan, first)
        else:
            self._fit_async_pipelined(plan, first)

    def _fit_async_pipelined(self, plan, first: int) -> None:
        """Per-event route: the prologue fills ``pending``, then each event
        dispatches consume, eval and restart while the ``RoundConsumer``
        runs the previous event's epilogue and the ``RoundPrefetcher``
        stages the next event's restart batches (data plan ``e+2``)."""
        prologue, _ = self._async_programs()
        val_batches, val_counts = self._val_batches()
        self._fit_last_round = plan.n_events
        consumer = self._consumer = RoundConsumer(maxsize=self.pipeline_depth)
        prefetcher = self._prefetcher = RoundPrefetcher(self)
        try:
            self.client_states, self._async_pending = prologue(
                self.server_state, self.client_states, self._round_batches(1), val_batches)
            prefetcher.schedule(2)  # event e restarts on data plan e+1
            for e in range(1, plan.n_events + 1):
                consumer.raise_pending()
                self._run_async_event(e, plan, first, val_batches, val_counts)
            consumer.flush()
        finally:
            consumer.close()
            prefetcher.close()
            self._consumer = self._prefetcher = None
            self._async_pending = None

    def _run_async_event(self, e: int, plan, first: int, val_batches, val_counts) -> None:
        """The producer's half of event ``e``: its plan row and the staged
        restart batches in, one dispatch of consume, eval and restart, the
        pull started and the epilogue handed to the consumer. Nothing here
        waits for the device."""
        consumer, prefetcher = self._consumer, self._prefetcher
        _, event = self._async_programs()
        t0 = time.time()
        arrivals = engine.host_to_device(plan.arrivals[e - 1], self.device)
        staleness = engine.host_to_device(plan.staleness[e - 1], self.device)
        batches_next = (prefetcher.take(e + 1) if prefetcher is not None
                        else self._round_batches(e + 1))
        if prefetcher is not None and e < self._fit_last_round:
            prefetcher.schedule(e + 2)
        (self.server_state, self.client_states, self._async_pending, out) = event(
            self.server_state, self.client_states, self._async_pending, batches_next,
            arrivals, staleness, e, val_batches, val_counts,
            self._staleness_exponent_input(), *(self._test_batches() or ()))
        work = _RoundWork(round=first + e - 1, pull=HostPull({"mask": arrivals, **out}),
                          fit_elapsed_s=time.time() - t0,
                          eval_elapsed_s=0.0,  # eval is fused into the event
                          async_info=self._async_event_info(plan, e - 1), event=e)
        if consumer is None:  # no pipeline: the epilogue inline
            self._finish_round(work)
            return
        consumer.submit_round(work.round, functools.partial(self._finish_round, work))
        if not self.failure_policy.accept_failures:
            # the failure screen must end the run before the next event
            consumer.flush()

    def _make_async_chunked(self):
        """The async chunked route's chunk: its events dispatched back to
        back over the resident stacks, each gathering its restart batches
        by its plan row, the server, client and ``pending`` trees carried on
        the device, the outputs stacked for one pull: JAX's ``lax.scan``
        over the event plan, without the scan."""
        _, event = self._async_programs()

        def chunk(server_state, client_states, pending, x_stack, y_stack, idx, em, sm,
                  arrivals, staleness, start_event, val_batches, val_counts,
                  staleness_exponent, test_batches=None, test_counts=None):
            outs = []
            for i in range(idx.shape[0]):
                batches_next = engine.gather_batches(x_stack, y_stack, idx[i], em[i], sm[i])
                server_state, client_states, pending, out = event(
                    server_state, client_states, pending, batches_next, arrivals[i],
                    staleness[i], start_event + i, val_batches, val_counts,
                    staleness_exponent, test_batches, test_counts)
                outs.append(out)
            return server_state, client_states, pending, ptu.stack_clients(outs)

        return chunk

    def _fit_async_chunked(self, plan, first: int) -> None:
        """The chunked route over the whole plan: the prologue, one chunk
        of every event (restart plans ``2..E+1``), one pull, and the shared
        epilogue with each event's facts."""
        t_start = time.time()
        prologue, _ = self._async_programs()
        val_batches, val_counts = self._val_batches()
        k = plan.n_events
        self.client_states, pending = prologue(
            self.server_state, self.client_states, self._round_batches(1), val_batches)
        plans = [self._round_plan(e + 1) for e in range(1, k + 1)]
        idx, em, sm = (engine.host_to_device(np.stack([p[j] for p in plans]).astype(dtype),
                                             self.device)
                       for j, dtype in enumerate((np.int64, np.float32, np.float32)))
        arrivals = engine.host_to_device(plan.arrivals, self.device)
        staleness = engine.host_to_device(plan.staleness, self.device)
        self.server_state, self.client_states, _, outs = self._make_async_chunked()(
            self.server_state, self.client_states, pending, self._x_train_stack,
            self._y_train_stack, idx, em, sm, arrivals, staleness, 1, val_batches,
            val_counts, self._staleness_exponent_input(), *(self._test_batches() or ()))
        stacked = HostPull(outs).result()  # the chunk's one pull
        self._chunked_epilogue(k, stacked, plan.arrivals, (time.time() - t_start) / k,
                               start_round=first, async_plan=plan)

    # -- buffered async over the registry (FedBuff x cohort slots) -------
    def _fit_async_registry(self, plan, first: int) -> None:
        """FedBuff over the registry: the ``K`` buffer slots are seats, and
        the ``RegistryEventPlan`` says who holds each seat at every event.
        The initial occupants' rows (and strategy rows) are gathered, the
        prologue trains them on plan 1, each event swaps the consumed seats
        whose occupant changes and dispatches, and at the end every seat's
        row goes back into the registry. The occupants' sample counts ride
        ``pending`` with their packets, so a packet is weighted by the
        counts it trained under."""
        prologue, _ = self._async_programs()
        slots, reg = self.n_clients, self.registry
        occ = np.asarray(plan.slot_ids[0])
        self._gather_cohort_rows(occ)
        consumer = self._consumer = RoundConsumer(maxsize=self.pipeline_depth)
        try:
            staged = reg.stage_round(occ, slots, self._base_entropy, 1)
            self.client_states, self._async_pending = prologue(
                self.server_state, self.client_states, self._to_device(staged["batches"]),
                self._to_device(staged["val_batches"]),
                self._to_device(staged["sample_counts"]))
            for e in range(1, plan.n_events + 1):
                consumer.raise_pending()
                occ = self._run_async_registry_event(e, plan, occ, first)
            consumer.flush()
            # the end of the plan: the seats' live rows persist
            host = HostPull({"client_states": self.client_states,
                             "strategy_rows": self.strategy.state_rows(self.server_state)
                             if reg.has_strategy_rows else None}).result()
            reg.scatter(occ, slots, host["client_states"], host["strategy_rows"])
        finally:
            consumer.close()
            self._consumer = None
            self._async_pending = None

    def _swap_seats(self, changed: np.ndarray, old_ids: np.ndarray,
                    new_ids: np.ndarray) -> tuple[float, float]:
        """Evict the ``changed`` seats' occupants (their client and strategy
        rows pulled and stored under their old ids), then seat the new
        occupants' rows there; the old are stored first, so a client that
        left and comes back reads its fresh row. Returns the scatter and
        gather ms."""
        reg = self.registry
        s0 = time.perf_counter()
        ch = engine.host_to_device(changed.astype(np.int64), self.device)
        take = lambda tree: ptu.tree_map(lambda t: t.index_select(0, ch), tree)  # noqa: E731
        srows_live = (self.strategy.state_rows(self.server_state)
                      if reg.has_strategy_rows else None)
        out = HostPull({"client_states": take(self.client_states),
                        "strategy_rows": take(srows_live) if srows_live is not None
                        else None}).result()
        reg.scatter(old_ids, len(changed), out["client_states"], out["strategy_rows"])
        scatter_ms = (time.perf_counter() - s0) * 1e3
        g0 = time.perf_counter()
        put = lambda tree, rows: ptu.tree_map(  # noqa: E731
            lambda t, n: t.index_copy(0, ch, n), tree, rows)
        self.client_states = put(self.client_states, rows_to_device(
            reg.gather_client_states(new_ids), reg.client_dtypes, self.device))
        if srows_live is not None:
            self.server_state = self.strategy.scatter_state_rows(
                self.server_state, put(srows_live, rows_to_device(
                    reg.gather_strategy_rows(new_ids), reg.strategy_dtypes, self.device)))
        return scatter_ms, (time.perf_counter() - g0) * 1e3

    def _run_async_registry_event(self, e: int, plan, occ_prev: np.ndarray,
                                  first: int) -> np.ndarray:
        """The producer's half of event ``e`` over the registry: swap the
        seats whose occupant changes, stage data plan ``e+1`` for the new
        occupancy (its val batches feed this event's eval, which runs on the
        post-swap stack), dispatch, and hand the epilogue to the consumer
        with the pre-swap occupancy (a consumed packet belongs to the
        occupant that trained it). Returns the new occupancy."""
        consumer = self._consumer
        _, event = self._async_programs()
        slots, reg = self.n_clients, self.registry
        t0 = time.time()
        occ_next = np.asarray(plan.slot_ids[e])
        changed = np.nonzero(occ_prev != occ_next)[0]
        scatter_ms = gather_ms = 0.0
        if changed.size:
            scatter_ms, gather_ms = self._swap_seats(changed, occ_prev[changed],
                                                     occ_next[changed])
        st0 = time.perf_counter()
        staged = reg.stage_round(occ_next, slots, self._base_entropy, e + 1)
        batches_next, val_batches, val_counts, wave_counts = (
            self._to_device(staged[k]) for k in ("batches", "val_batches", "val_counts",
                                                 "sample_counts"))
        stage_ms = (time.perf_counter() - st0) * 1e3
        arrivals = engine.host_to_device(plan.arrivals[e - 1], self.device)
        (self.server_state, self.client_states, self._async_pending, out) = event(
            self.server_state, self.client_states, self._async_pending, batches_next,
            arrivals, engine.host_to_device(plan.staleness[e - 1], self.device), e,
            val_batches, val_counts, self._staleness_exponent_input(),
            None, None, wave_counts)  # no test split under a cohort
        work = _RoundWork(
            round=first + e - 1, pull=HostPull({"mask": arrivals, **out}),
            fit_elapsed_s=time.time() - t0, eval_elapsed_s=0.0,
            # failures are named by the pre-swap occupants' ids
            cohort_meta={"idx": occ_prev},
            cohort_info={"cohort_slots": slots, "cohort_valid": slots,
                         "registry_size": self.registry_size,
                         "registry_dirty_rows": reg.dirty_rows,
                         "stage_ms": round(stage_ms, 3), "gather_ms": round(gather_ms, 3),
                         "scatter_ms": round(scatter_ms, 3),
                         "staged_bytes": staged["staged_bytes"], "swapped": int(changed.size),
                         "rounds_per_dispatch": 1, "cohort_draw": "event_plan"},
            async_info=self._async_event_info(plan, e - 1), event=e)
        consumer.submit_round(work.round, functools.partial(self._finish_round, work))
        if not self.failure_policy.accept_failures:
            consumer.flush()
        return occ_next
