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

Checkpointing, as in JAX (``checkpointing/``): ``model_checkpointers``
(``(CheckpointMode, ParamsCheckpointer)`` pairs) fire in each round's
epilogue on the clients' post-fit params or the global params, and keep a
run on the pipelined route; a ``state_checkpointer``
(``SimulationStateCheckpointer``) writes a crash-consistent frame every
``checkpoint_every`` rounds (and after the last), and ``fit`` resumes from
the newest good one. The trees a save needs ride the round's one pull
(``_round_snapshots``), or the chunk's on the chunked routes, whose chunks
are then ``checkpoint_every`` rounds long; the frame is written on an
``AsyncCheckpointWriter`` thread, and its stats land in
``round_metrics[r]["checkpoint"]``. Dense frames, cohort frames (with the
registry's rows) and async frames (with ``pending``, mid-plan) resume on
either route, bit for bit.

Observability (``observability=Observability(...)``, JAX's facade;
disabled by default): ``fit`` arms the handle, logs the ``execution_mode``
event, builds the run manifest, traps SIGTERM while a flight recorder is
armed, publishes a postmortem bundle on any abnormal end
(``_dump_postmortem``) and shuts the handle down in its ``finally``. Each
route opens JAX's spans and, with ``sync_device``, fences the device after
its dispatches. With ``telemetry`` on, the round programs are their
telemetry builds (``_fit_round_t``/``_eval_round_t``, the async programs'
likewise): they also return the ``RoundTelemetry`` tree, which rides the
round's (or the chunk's) one pull, and a logic's ``telemetry_loss_keys``
(DP's ``clip_fraction``) enter the fit losses, as in JAX. Each round's
epilogue absorbs the round into the fleet ledger (before the round's state
frame, which then carries the ledger under ``"fleet"``), records JAX's
``fl_*`` metrics, the ``round`` and ``telemetry`` JSONL events and the
flight-recorder entry (``_record_round_metrics``), and lets the watchdog
observe the telemetry last; the dense pipelined route samples the
watchdog's quarantined clients out in ``configure_fit``. With
``introspection`` on (JAX's default) ``fit`` runs each round program it
will dispatch once on fake tensors (``_introspect_programs``, JAX's
program names; not on the async routes, as in JAX), and every round record
carries ``program_flops_round``, ``tflops_measured`` and, on a card the
device table knows, ``mfu_pct``. The operations plane (``slo=``,
``admin_token=``) reads each round's summary in the epilogue
(``observe_round_kpis``), and an armed admin plane's retunes apply at every
pipelined route's round (or event) boundary on the producer thread
(``_apply_admin_retunes``); it steers ``"auto"`` to the pipelined route
with JAX's reason.

Departures: without a state checkpointer ``fit(n)`` runs ``n`` more
rounds, numbered after ``history`` (under one, JAX's numbering: restore
round ``c`` and run ``c+1..n``); a round's facts (a cohort round's
``cohort_info`` with the pull's bytes and ms, an async event's plan facts,
the fault plan's ``summarize_round`` under ``"fault"``, a save's stats
under ``"checkpoint"``) also land in ``round_metrics``; ``profile_dir``
and ``profile_round_idx`` write ``torch.profiler`` traces, not XProf; the
compile counters count kernel-extension builds; measured MFU divides a
round's counted flops by its wall less its builds, not by the fence's
wait.

Resilience, as in JAX: a strategy with ``quarantine_mask`` (a
``QuarantiningStrategy``) has its in-graph mask brought to the host every
round (riding the round's pull, or stacked in the chunk's) for the
``fl_quarantine_*`` records, the fleet ledger and the flight recorder; and
``recovery=RecoveryPolicy(...)`` runs ``fit`` under a
``RecoverySupervisor`` (``resilience/supervisor.py``), whose quarantine
roster masks the sampling on every route (by registry id under a cohort)
and whose probation every route's epilogue feeds.

Device meshes (``mesh=MeshConfig(...)``, ``parallel/``): one process a
device, every rank building the same simulation from the same seed. Rank
``r`` holds the block ``[lo, hi)`` of every ``[C, ...]`` client stack that
JAX's ``P("clients")`` gives device ``r`` (its data banks, index-plan rows,
sample counts and client states; a cohort round's slots), and the server
state as the strategy's ``state_sharding_spec`` says (ZeRO-1 vectors and
wrappers' per-client rows by block, the rest whole; the Megatron shards
under ``tp_rules``). The round programs run with the mesh's clients axis
active (``RoundProgramBuilder.jit``): they take the round's whole ``[C]``
mask and keep their block, every reduction over clients all-reduces the
rank's partial, and the per-client records come back gathered, so the host
code sees what it sees without a mesh and every rank takes the same
decisions. Checkpoint frames hold the gathered global trees, written by
rank 0 (as reporters and observability exports are) and restored by every
rank onto its block. A mesh with a cohort takes the pipelined route. The
dense buffered-async routes run under a mesh as the synchronous ones do
(each rank its block of ``pending`` too; async with a cohort and a mesh is
refused, as in JAX), and an armed admin plane's retunes, received by rank
0's endpoint, are broadcast at each pipelined boundary so every rank
applies them at the same round. FLASH early stopping
(``flash_early_stopping``) replaces the local train with
``clients/flash.py``'s epoch loop, as in JAX. Left out here: the
``WandBReporter``; so of JAX's reasons for the pipelined route, only those
of the features above apply.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import logging
import sys
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.checkpointing.async_writer import AsyncCheckpointWriter
from fl4health_tpu_torch.checkpointing.checkpointer import CheckpointMode
from fl4health_tpu_torch.checkpointing.serialization import leaves_like
from fl4health_tpu_torch.clients import engine
from fl4health_tpu_torch.clients.engine import Batch, ClientLogic, TrainState
from fl4health_tpu_torch.compression.config import CompressionConfig
from fl4health_tpu_torch.compression.strategy import CompressingStrategy
from fl4health_tpu_torch.core import pytree as ptu
from fl4health_tpu_torch.core.aggregate import client_all, client_block, client_sum
from fl4health_tpu_torch.device import resolve_device
from fl4health_tpu_torch.exchange.exchanger import FixedLayerExchanger, FullExchanger
from fl4health_tpu_torch.metrics.aggregation import aggregate_metrics
from fl4health_tpu_torch.metrics.base import MetricManager
from fl4health_tpu_torch.observability import Observability, device_specs, get_registry
from fl4health_tpu_torch.observability import stages as stage_attr
from fl4health_tpu_torch.observability import telemetry as telem
from fl4health_tpu_torch.observability.cudamon import profile_round
from fl4health_tpu_torch.observability.flightrec import trap_sigterm
from fl4health_tpu_torch.observability.introspect import device_identity
from fl4health_tpu_torch.observability.manifest import config_hash, run_manifest
from fl4health_tpu_torch.observability.telemetry import RoundTelemetry
from fl4health_tpu_torch.optim import GradientTransformation
from fl4health_tpu_torch.parallel.program import CLIENTS_AXIS, MeshConfig, RoundProgramBuilder
from fl4health_tpu_torch.precision.policy import PrecisionConfig
from fl4health_tpu_torch.resilience.faults import FaultPlan
from fl4health_tpu_torch.server.async_schedule import (AsyncConfig, build_event_plan,
                                                       build_registry_event_plan,
                                                       plan_prefix_fingerprints)
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
    ``mask * counts`` over the clients (summed by ``client_sum``)."""
    w = mask * counts
    total = torch.clamp(client_sum(w), min=1.0)
    agg_losses = {
        # where() not multiply: an excluded client's NaN must not leak
        k: client_sum(torch.where(mask > 0, v, torch.zeros_like(v)) * w) / total
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


def _dtypes(tree):
    return ptu.tree_map(lambda t: t.dtype, tree)


def host_snapshot(pulled, dtypes):
    """A pulled tree with its bf16 leaves (widened to f32 by ``HostPull``,
    exactly) narrowed back to bf16 CPU tensors, so a frame keeps every
    dtype."""
    return ptu.tree_map(lambda a, dt: torch.from_numpy(np.array(a)).to(dt)
                        if dt == torch.bfloat16 else a, pulled, dtypes)


def _account_wire(logical: int, wire: int, direction: str) -> None:
    """``fl_wire_*`` accounting of the compressed exchange on the
    process-wide registry, JAX's ``transport.codec.account_wire`` (the
    transport is not ported): logical against wire bytes, and the ratio."""
    reg = get_registry()
    labels = {"direction": direction}
    reg.counter("fl_wire_bytes_logical_total",
                help="dense byte footprint of trees crossing the compressed codec",
                labels=labels).inc(logical)
    reg.counter("fl_wire_bytes_compressed_total",
                help="actual wire bytes of compressed frames", labels=labels).inc(wire)
    if wire > 0:
        reg.gauge("fl_wire_compression_ratio",
                  help="logical/wire byte ratio of the last compressed exchange",
                  labels=labels).set(logical / wire)


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
    # the dtypes of the checkpoint trees riding the pull (None: none ride)
    snapshot_dtypes: dict | None = None
    # an async snapshot's plan-prefix fingerprint and virtual clock
    resume_meta: dict | None = None
    # async events only: the plan's facts (``_async_event_info``) and the
    # event index the round programs drew at (the record's round is
    # numbered after ``history``)
    async_info: dict | None = None
    event: int | None = None
    # observability: the fenced device wait and the compile counters read
    # by the producer around the round's dispatches
    device_wait_s: float = 0.0
    compiles_before: float = 0.0
    compile_s_before: float = 0.0
    compiles_after: float | None = None
    compile_s_after: float | None = None


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
        model_checkpointers: Sequence[tuple[Any, Any]] = (),
        state_checkpointer: Any = None,
        early_stopping: engine.EarlyStoppingConfig | None = None,
        flash_early_stopping: Any = None,
        failure_policy: FailurePolicy | None = None,
        profile_dir: str | None = None,
        train_data_provider: Any = None,
        observability: Observability | None = None,
        execution_mode: str = "auto",
        pipeline_depth: int = 2,
        fault_plan: FaultPlan | None = None,
        compression: CompressionConfig | None = None,
        mesh: Any = None,
        precision: PrecisionConfig | None = None,
        async_config: AsyncConfig | None = None,
        cohort: CohortConfig | None = None,
        recovery: Any = None,
        device: str | torch.device = "cuda",
    ):
        # JAX's parameters in JAX's order (a positional call binds alike)
        if mesh is not None and not isinstance(mesh, MeshConfig):
            raise TypeError(
                "mesh must be a MeshConfig (or None); got "
                f"{type(mesh).__name__} — pass parallel.program.MeshConfig")
        self.mesh_config = mesh
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
        self._precision_active = bool(precision is not None and precision.active)
        self._precision_scaling = bool(precision is not None and precision.scaling_active)
        self.device = resolve_device(device)
        # the device name the peaks of device_specs are keyed by (measured MFU)
        self._device_kind = device_identity(self.device)[1]
        # per-round flops of the round programs, set by introspection
        self._round_program_flops: float | None = None
        # fit() wraps its rounds in one torch.profiler capture written here
        self.profile_dir = profile_dir
        # a disabled handle's every hook is a no-op: no sync, no record
        self.observability = observability or Observability(enabled=False)
        self._telemetry_enabled = self.observability.telemetry_enabled
        self._payload_bytes_cache: tuple[int, int] | None = None
        self._wire_bytes_cache: int | None = None
        self._active_execution_mode: str | None = None
        # the newest round whose pipelined epilogue finished (the verdict's
        # epilogues_through_round), and the round a SIGTERM arrived at
        self._last_epilogue_round: int | None = None
        self._sigterm_round: int | None = None
        self._extra_loss_keys = tuple(extra_loss_keys)
        self._eval_loss_keys = tuple(eval_loss_keys)
        self.reporters = list(reporters)
        self.early_stopping = early_stopping
        self.flash_early_stopping = flash_early_stopping
        if flash_early_stopping is not None:
            # Flash is epoch-defined: the reference refuses step-wise training
            if local_epochs is None:
                raise ValueError("flash_early_stopping requires local_epochs")
            if early_stopping is not None:
                raise ValueError("flash_early_stopping and early_stopping are exclusive")
            if flash_early_stopping.n_epochs != local_epochs:
                raise ValueError(
                    f"flash_early_stopping.n_epochs={flash_early_stopping.n_epochs} "
                    f"must equal local_epochs={local_epochs}: the gamma rule is "
                    "defined per true local epoch")
        self.failure_policy = failure_policy or FailurePolicy()
        # callable(round) -> (x_list, y_list) | None, called at the top of
        # each round: fresh train arrays of the original shapes and dtypes
        self.train_data_provider = train_data_provider
        # how many rounds of host epilogue may be in flight behind the
        # producer (the RoundConsumer's bound)
        self.pipeline_depth = pipeline_depth
        # (CheckpointMode, ParamsCheckpointer) pairs, fired in the round's
        # epilogue; the state checkpointer snapshots the run for resume
        self.model_checkpointers = list(model_checkpointers)
        self.state_checkpointer = state_checkpointer
        self._ckpt_writer: AsyncCheckpointWriter | None = None
        # facts of the restore a fit() made; None on a fresh run
        self._resume_info: dict | None = None
        # per-event prefix digests of the async plan (event e's snapshot
        # stores entry e-1), while async checkpointing is on
        self._async_prefix_fps: list[str] | None = None
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
        # self-healing recovery (resilience/supervisor.py): recovery=
        # RecoveryPolicy(...) routes fit() through a RecoverySupervisor that
        # turns the structured abnormal ends (watchdog halt, client
        # failures, quorum loss, corrupt checkpoints) into rollback,
        # mitigation and resume; None keeps fit() the unsupervised loop,
        # and an armed policy that never engages changes nothing either
        self.recovery_policy = recovery
        if recovery is not None:
            from fl4health_tpu_torch.resilience.supervisor import RecoveryPolicy

            if not isinstance(recovery, RecoveryPolicy):
                raise TypeError(
                    "recovery must be a RecoveryPolicy (or None); got "
                    f"{type(recovery).__name__} — pass "
                    "resilience.supervisor.RecoveryPolicy")
        self._recovery_supervisor = None
        # the host copy of the in-graph quarantine mask, for the transition
        # accounting of the quarantine records; under a cohort, the
        # registry-wide view (both per fit)
        self._last_quarantine: list[int] | None = None
        self._cohort_quarantine: set | None = None
        # the current fit call's n_rounds (the supervisor's seeding reads it)
        self._fit_n_rounds = 0
        # synchronous rounds sent to the device by fit, on any route; a round
        # a rollback replays counts each time it runs
        self.rounds_dispatched = 0
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
            if self.model_checkpointers:
                raise ValueError(
                    "async_config is not composable with per-round model "
                    "checkpointing: there is no synchronous post-fit/"
                    "pre-aggregation moment inside a fused buffer-fill "
                    "event (state checkpointing — resume — composes; use "
                    "state_checkpointer)")
            if self._cohort_active and self.mesh_config is not None:
                raise ValueError(
                    "async_config + cohort=CohortConfig(...) does not yet "
                    "compose with mesh: the per-event occupancy swap "
                    "restages seated rows host-side, which would fight the "
                    "mesh's sharded staging; run the composition unsharded "
                    "or drop one of the two")
            if self._cohort_active and self.state_checkpointer is not None:
                raise ValueError(
                    "async_config + cohort=CohortConfig(...) does not yet "
                    "compose with state checkpointing: a resume would need "
                    "a frame persisting BOTH the pending update buffer and "
                    "the registry's dirty rows + seating cursor, and no "
                    "such combined frame format exists yet")
            sc = self.state_checkpointer
            if sc is not None and not (hasattr(sc, "save_async_snapshot")
                                       and hasattr(sc, "load_async_simulation")):
                raise ValueError(
                    "async state checkpointing needs a checkpointer that "
                    "can snapshot the pending update buffer and the event "
                    "cursor (save_async_snapshot/load_async_simulation — "
                    f"SimulationStateCheckpointer); {type(sc).__name__} "
                    "cannot, so an interrupted async run could not resume "
                    "mid-plan")
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
            sc = self.state_checkpointer
            if sc is not None and not (hasattr(sc, "save_cohort_snapshot")
                                       and hasattr(sc, "load_cohort_simulation")):
                raise ValueError(
                    "cohort state checkpointing needs a checkpointer that "
                    "persists the registry's dirty rows (save_cohort_"
                    "snapshot/load_cohort_simulation — "
                    f"SimulationStateCheckpointer); {type(sc).__name__} "
                    "cannot, so an interrupted cohort run could not resume")
        # device-mesh placement (parallel/program.py): None keeps every
        # program the single-device one; a MeshConfig makes this process one
        # rank of the mesh, holding its block [lo, hi) of every [C, ...]
        # client stack, the reductions over clients all-reduced
        self._program_builder = RoundProgramBuilder(mesh, n_clients=self.n_clients)
        self._client_lo, self._client_hi = self._program_builder.client_block(
            self.n_clients)
        self._n_local = self._client_hi - self._client_lo
        if mesh is not None:
            if self._n_local != self.n_clients:
                # per-client server rows (wrappers' bookkeeping) are this
                # rank's block; the checks above saw the real manager
                self.strategy.bind_client_manager(
                    _SlotManagerView(self.client_manager, self._n_local))
            if not self._program_builder.mesh.is_leader:
                # effects that leave the program happen on rank 0 only
                self.reporters = []
                self.observability.output_dir = None
                self.observability.http_port = None
            if self._program_builder.config.tp_rules:
                module = getattr(getattr(logic, "model", None), "module", None)
                if module is None:
                    raise ValueError(
                        "MeshConfig(tp_rules=True) needs a logic whose model wraps "
                        "a module (engine.from_module)")
                from fl4health_tpu_torch.parallel.tp import enable_tensor_parallel

                enable_tensor_parallel(module, self._program_builder.model_axis)
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
            # this rank's block of the clients (all of them without a mesh)
            local = self._local_datasets()
            self.sample_counts = torch.tensor(
                [d.n_train for d in local], dtype=torch.float32, device=self.device)
            stack = engine.pad_and_stack_data
            self._x_train_stack = stack([d.x_train for d in local], "x_train", self.device)
            self._y_train_stack = stack([d.y_train for d in local], "y_train", self.device)
            self._x_val_stack = stack([d.x_val for d in local], "x_val", self.device)
            self._y_val_stack = stack([d.y_val for d in local], "y_val", self.device)
        self._val_cache: tuple[Batch, torch.Tensor] | None = None
        self._test_cache: tuple[Batch, torch.Tensor] | None = None
        self._init_states(wire_zero1=True)
        self._fit_round, self._eval_round = self._build_round_fns()
        # the telemetry builds (one more output each), dispatched by fit()
        # when observability's telemetry is on
        self._fit_round_t = self._eval_round_t = None
        if self._telemetry_enabled:
            self._fit_round_t, self._eval_round_t = self._build_round_fns(
                collect_telemetry=True)

    # ------------------------------------------------------------------
    def _local_datasets(self) -> list:
        """This rank's block of the clients' datasets."""
        return self.datasets[self._client_lo:self._client_hi]

    def _init_states(self, wire_zero1: bool = False) -> None:
        """The client stack and the server state from ``self.rng``; under a
        mesh this rank's block of the clients and its shards of the
        tensor-parallel params. ``wire_zero1``: the constructor's one-time
        ZeRO-1 wiring of the server optimizer."""
        init_rng = rng.fold_in(self.rng, 0)
        proto = engine.create_train_state(
            self.logic, self.tx, init_rng, torch.Generator().manual_seed(self.seed),
            self.device, precision=self.precision)
        b = self._program_builder
        if b.mesh is not None and b.config.tp_rules:
            from fl4health_tpu_torch.parallel.tp import shard_like_params

            # the Megatron shards of the params and of the params-shaped
            # optimizer state
            proto = dataclasses.replace(
                proto, params=shard_like_params(proto.params, proto.params, b.mesh),
                opt_state=shard_like_params(proto.opt_state, proto.params, b.mesh))
        if wire_zero1 and b.mesh is not None and b.config.zero1:
            self._wire_zero1_server_optimizer(proto.params)
        # every client starts from the same params; only the key differs
        keys = torch.stack([rng.fold_in(init_rng, i + 1)
                            for i in range(self._client_lo, self._client_hi)])
        self.client_states: TrainState = dataclasses.replace(
            ptu.stack_clients([proto] * self._n_local), rng=keys)
        self.server_state = self.strategy.init(proto.params)
        if self._cohort_active:
            # client i's row derives from (proto, fold_in(init_rng, i + 1)),
            # the dense derivation; the strategy's rows from the slot
            # init's row 0 (checked client-symmetric)
            self.registry.bind_client_states(proto, init_rng)
            self.registry.bind_strategy_rows(self.strategy.state_rows(self.server_state))

    def _wire_zero1_server_optimizer(self, params_template) -> None:
        """``MeshConfig(zero1=True)``: wrap the innermost FedOpt-family
        strategy's server transform in ``parallel/zero.py``'s ZeRO-1 over
        the clients (replica) axis of THIS mesh, whose parity probe then
        validates the deployed sharding. The caller's strategy objects are
        never mutated: the wrapper chain is rebuilt around shallow copies."""
        import copy

        from fl4health_tpu_torch.parallel.zero import (Zero2ShardedOptimizer,
                                                        ZeroShardedOptimizer,
                                                        _validate_elementwise,
                                                        zero_sharded_optimizer)
        from fl4health_tpu_torch.strategies.fedopt import FedOpt

        chain = [self.strategy]
        while hasattr(chain[-1], "inner"):
            chain.append(chain[-1].inner)
        inner = chain[-1]
        if not isinstance(inner, FedOpt):
            raise ValueError(
                "MeshConfig(zero1=True) shards a SERVER optimizer: the "
                "(innermost) strategy must be FedOpt-family (fed_adam/"
                "fed_yogi/fed_adagrad/fed_avg_m/FedOpt); got "
                f"{type(inner).__name__}, which has no server optax "
                "transform to shard")
        mesh = self._program_builder.mesh
        if isinstance(inner.tx, (ZeroShardedOptimizer, Zero2ShardedOptimizer)):
            # sharded by the caller: it must be THIS mesh's clients axis
            if inner.tx.mesh is not mesh or inner.tx.axis_name != CLIENTS_AXIS:
                raise ValueError(
                    "the server optimizer was ZeRO-sharded against a "
                    f"different mesh/axis ({inner.tx.axis_name!r} on "
                    f"{dict(inner.tx.mesh.shape)}) than the round programs "
                    f"dispatch on ({CLIENTS_AXIS!r} on {dict(mesh.shape)}); "
                    "let MeshConfig(zero1=True) do the wiring (pass the "
                    "plain optax transform) so validation reflects the "
                    "deployed sharding")
            if self.mesh_config.validate_zero1:
                n_local = (inner.tx.n_shards
                           if isinstance(inner.tx, Zero2ShardedOptimizer) else None)
                _validate_elementwise(inner.tx, inner.tx.tx, params_template,
                                      n_local=n_local)
            return
        new_inner = copy.copy(inner)
        new_inner.tx = zero_sharded_optimizer(
            inner.tx, mesh, params_template, axis_name=CLIENTS_AXIS,
            validate=self.mesh_config.validate_zero1)
        rebuilt = new_inner
        for wrapper in reversed(chain[:-1]):
            wrapper = copy.copy(wrapper)
            wrapper.inner = rebuilt
            rebuilt = wrapper
        self.strategy = rebuilt

    # -- placement under a mesh (identities without one) ------------------
    def _client_placement(self):
        """The client stack's sharding tree (None without a mesh)."""
        return self._program_builder.client_state_shardings(self.client_states)

    def _server_placement(self):
        """How a rank holds the server state: the strategy's specs
        (``server_state_shardings``) and, under ``tp_rules``, the Megatron
        shards of its params-shaped leaves, which the port keeps sharded
        like the clients' (JAX replicates them and lets GSPMD reshard)."""
        b = self._program_builder
        sh = b.server_state_shardings(self.strategy, self.server_state)
        if sh is None or not b.config.tp_rules:
            return sh
        from fl4health_tpu_torch.parallel import tp as tplib
        from fl4health_tpu_torch.parallel.mesh import P
        from fl4health_tpu_torch.parallel.program import _map_placed, _specs_to_named

        tp = tplib.spec_like_params(self.server_state,
                                    self.strategy.global_params(self.server_state))
        base = _map_placed(lambda leaf, spec: P() if spec is None else spec,
                           self.server_state, sh)
        merged = [t if any(a is not None for a in t) else f for (_, t), (_, f) in
                  zip(tplib.leaves_with_paths(tp), tplib.leaves_with_paths(base))]
        return _specs_to_named(tplib._rebuild(self.server_state, iter(merged)), b)

    def _tp_specs_named(self):
        """The Megatron shardings of a params dict."""
        from fl4health_tpu_torch.parallel.program import _specs_to_named
        from fl4health_tpu_torch.parallel.tp import spec_like_params

        local = self.strategy.global_params(self.server_state)
        return _specs_to_named(spec_like_params(local, local), self._program_builder)

    @property
    def global_params(self):
        params = self.strategy.global_params(self.server_state)
        b = self._program_builder
        if b.mesh is not None and b.config.tp_rules:
            params = b.gather(params, self._tp_specs_named())
        return params

    def set_global_params(self, params, broadcast_to_clients: bool = True) -> None:
        """Install weights (same keys and shapes as the model's, cast to the
        model's dtypes) as the global model (a warm start:
        ``preprocessing/checkpoint_io.py``). With ``broadcast_to_clients``
        every client's local params reset to them too, the only path by
        which leaves that are never exchanged (personal layers, a frozen
        LoRA base) receive the pretrained values."""
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
        b = self._program_builder
        if b.mesh is not None and b.config.tp_rules:
            params = b.put(params, self._tp_specs_named())
        # through any wrapper (CompressingStrategy keeps the params inside)
        self.server_state = replace_global_params(self.strategy, self.server_state, params)
        if broadcast_to_clients:
            self.client_states = dataclasses.replace(
                self.client_states, params=ptu.stack_clients([params] * self._n_local))

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
    def _build_client_fns(self, collect_telemetry: bool = False):
        """(client_fit, client_eval) of one client: pull -> local train ->
        push, and pull -> evaluate. The telemetry build's ``client_fit``
        returns a fifth output, the client's telemetry row (the engine's
        loss and grad-norm statistics, the update norm, the loss scaler's
        skips), and trains bit for bit as the plain one."""
        logic, tx, exchanger = self.logic, self.tx, self.exchanger
        loss_keys = ("backward", *self._extra_keys())
        if collect_telemetry:
            # a logic's per-step statistics (DP's clip fraction) enter the
            # loss meter on the telemetry build only, as in JAX
            loss_keys += tuple(k for k in getattr(logic, "telemetry_loss_keys", ())
                               if k not in loss_keys)
        if self.early_stopping is not None:
            train = engine.make_local_train_with_early_stopping(
                logic, tx, self.metrics, self.early_stopping, loss_keys,
                precision=self.precision, collect_telemetry=collect_telemetry)
        elif self.flash_early_stopping is not None:
            from fl4health_tpu_torch.clients.flash import make_flash_local_train

            # the gamma rule's epoch loop keeps no telemetry accumulator: the
            # engine's statistics come back NaN, as in JAX (the update norm
            # is measured outside the train)
            flash_train = make_flash_local_train(logic, tx, self.metrics,
                                                 self.flash_early_stopping, loss_keys,
                                                 precision=self.precision)

            def train(state, ctx, batches, val_batches):
                outs = flash_train(state, ctx, batches, val_batches)
                if collect_telemetry:
                    return (*outs, telem.nan_engine_telemetry(batches.step_mask.device))
                return outs
        else:
            plain_train = engine.make_local_train(logic, tx, self.metrics, loss_keys,
                                                  precision=self.precision,
                                                  collect_telemetry=collect_telemetry)

            def train(state, ctx, batches, val_batches):
                return plain_train(state, ctx, batches)
        evaluate = engine.make_local_eval(logic, self.metrics,
                                          ("checkpoint", *self._eval_keys()))
        evaluate_after_fit = getattr(self.strategy, "evaluate_after_fit", False)
        scaling_active = self._precision_scaling
        # a partial exchange's pull reads the strategy's whole payload (the
        # packet's mask of refreshed leaves), not just its params
        wants_packet = getattr(exchanger, "wants_packet_payload", False)

        def pull_source(payload):
            return payload if wants_packet else payload_params(payload)

        def client_fit(state: TrainState, payload, batches: Batch,
                       participate: torch.Tensor, val_batches: Batch):
            orig = state
            pulled = exchanger.pull(pull_source(payload), state.params)
            state = dataclasses.replace(state, params=pulled)
            ctx = logic.init_round_context(state, payload)
            new_state, losses, metrics, _, *engine_telem = train(state, ctx, batches,
                                                                 val_batches)
            if evaluate_after_fit:
                # local validation before aggregation (FedDG-GA's
                # evaluate_after_fit)
                post_fit = evaluate(new_state, ctx, val_batches)[0]
                losses = {**losses, "val_checkpoint_post_fit": post_fit["checkpoint"]}
            client_telem = None
            if collect_telemetry:
                # the update norm of the TRAINED state against the pulled
                # globals, before participation masking (the watchdog
                # filters rows by the mask)
                client_telem = {**engine_telem[0],
                                "update_norm": telem.global_norm_diff(new_state.params,
                                                                      pulled)}
            # non-participants neither pull nor train
            new_state = ptu.tree_map(
                lambda n, o: torch.where(participate > 0, n, o), new_state, orig)
            if collect_telemetry and scaling_active:
                # the scaler's cumulative skipped steps, after masking
                client_telem["loss_scale_skips"] = new_state.loss_scale["skipped"]
            pushed = exchanger.push(new_state.params, pulled)
            packet = logic.pack(new_state, pushed, losses)
            if collect_telemetry:
                return new_state, packet, losses, metrics, client_telem
            return new_state, packet, losses, metrics

        def client_eval(state: TrainState, payload, batches: Batch):
            pulled = exchanger.pull(pull_source(payload), state.params)
            st = dataclasses.replace(state, params=pulled)
            ctx = logic.init_round_context(st, payload)
            losses, metrics = evaluate(st, ctx, batches)
            return st, losses, metrics

        return client_fit, client_eval

    def _build_round_fns(self, client_axis=vmap_clients, collect_telemetry: bool = False):
        """(fit_round, eval_round), each running the clients through
        ``client_axis`` (``vmap_clients``; the tests pass
        ``loop_clients``). With ``collect_telemetry`` each appends one
        output: ``fit_round`` a ``RoundTelemetry``, ``eval_round`` the
        per-client count of non-finite eval losses; the training math is
        the plain build's."""
        client_fit, client_eval = self._build_client_fns(collect_telemetry)
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
            # the [C] mask of the round; under a mesh this rank's block
            mask = client_block(mask)
            payload = strategy.client_payload(server_state, round_idx)
            if inject_dropout:
                # a dropped client is an unsampled one: mask math only
                mask = mask * client_block(fault_plan.participation_factor(
                    round_idx, n_clients, mask.device))
            new_states, packets, losses, metrics, *client_telem = fit_clients(
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
            with stage_attr.stage("server_update"):
                new_server_state = strategy.aggregate(server_state, results, round_idx)
            agg_losses, agg_metrics = fit_summary(losses, metrics, results.mask, sample_counts)
            if not collect_telemetry:
                return (new_server_state, new_states, agg_losses, agg_metrics,
                        ptu.tree_map(client_all, losses))
            ct = client_telem[0]
            train_loss = losses["backward"].to(torch.float32)
            nan_row = torch.full_like(train_loss, float("nan"))
            round_telemetry = RoundTelemetry(
                train_loss=train_loss,
                train_loss_min=ct["train_loss_min"],
                train_loss_max=ct["train_loss_max"],
                grad_norm_mean=ct["grad_norm_mean"],
                grad_norm_max=ct["grad_norm_max"],
                update_norm=ct["update_norm"],
                clip_fraction=losses.get("clip_fraction", nan_row),
                nonfinite_params=telem.per_client_nonfinite(new_states.params),
                nonfinite_loss=telem.nonfinite_in_losses(losses),
                divergence=telem.per_client_divergence(
                    new_states.params, strategy.divergence_reference(new_server_state)),
                nonfinite_eval_loss=torch.zeros_like(nan_row),
                loss_scale_skips=ct.get("loss_scale_skips"))
            # the host reads every client's row: under a mesh, gathered
            return (new_server_state, new_states, agg_losses, agg_metrics,
                    ptu.tree_map(client_all, losses), ptu.tree_map(client_all, round_telemetry))

        def eval_round(server_state, client_states, batches, eval_counts):
            gp = strategy.client_payload(server_state, 0)
            new_states, losses, metrics = eval_clients(client_states, gp, batches)
            total = torch.clamp(client_sum(eval_counts), min=1.0)
            agg_losses = {k: client_sum(v * eval_counts) / total for k, v in losses.items()}
            agg_metrics = aggregate_metrics(metrics, eval_counts)
            per_losses, per_metrics = (ptu.tree_map(client_all, losses),
                                       ptu.tree_map(client_all, metrics))
            if collect_telemetry:
                return (new_states, agg_losses, agg_metrics, per_losses, per_metrics,
                        client_all(telem.nonfinite_in_losses(losses)))
            return new_states, agg_losses, agg_metrics, per_losses, per_metrics

        b = self._program_builder
        return b.jit(fit_round), b.jit(eval_round)

    # -- buffered-async programs (server/async_schedule.py) -------------
    def _build_async_fns(self, collect_telemetry: bool = False):
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
        staleness 0 an event is a synchronous round bit for bit. The
        telemetry build carries each wave's client telemetry in ``pending``
        (``"telem"``) and returns the CONSUMED updates' ``RoundTelemetry``
        in the event's outputs, as JAX's does.

        Under a mesh both are round programs of the mesh: a rank holds its
        block of the client stack and of ``pending``, takes its block of
        the event's global ``[C]`` arrivals, staleness and fault draws (the
        draws keep their global client indices), sums over clients through
        ``client_total`` and hands back every client's per-client rows
        (all-gathered), so the host's decisions are the same on every
        rank."""
        client_fit, _ = self._build_client_fns(collect_telemetry)
        fit_clients = vmap_clients(client_fit, (0, None, 0, 0, 0))
        eval_round = self._eval_round_t if collect_telemetry else self._eval_round
        strategy = self.strategy
        quarantine_fn = (getattr(strategy, "quarantine_mask", None)
                         if self.observability.enabled else None)
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
            new_states, packets, losses, metrics, *client_telem = fit_clients(
                client_states, payload, batches, train_mask, val_batches)
            if inject_corruption:
                packets = fault_plan.corrupt_packets(packets, payload_params(payload),
                                                     round_idx, n_clients)
            pending = {"packets": packets, "losses": losses, "metrics": metrics}
            if cohort_active:
                pending["sample_counts"] = (sample_counts if wave_counts is None
                                            else wave_counts)
            if collect_telemetry:
                pending["telem"] = client_telem[0]
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
            ones = client_block(torch.ones((n_clients,), dtype=torch.float32,
                                           device=ptu.tree_leaves(client_states)[0].device))
            return train_wave(server_state, client_states, batches, ones, 1, val_batches,
                              wave_counts)

        def async_event(server_state, client_states, pending, batches_next, arrivals,
                        staleness, event_idx, val_batches, val_counts, staleness_exponent,
                        test_batches=None, test_counts=None, wave_counts=None):
            # -- consume: the buffer under the discounted mask -------------
            # the plan's [C] rows; under a mesh this rank's block
            arrivals, staleness = client_block(arrivals), client_block(staleness)
            arr = arrivals
            if inject_dropout:
                # a dropped update is lost on the wire: it fills its slot
                # but aggregates with weight 0 (its client restarts)
                arr = arr * client_block(fault_plan.participation_factor(
                    event_idx, n_clients, arr.device))
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
            round_telemetry = None
            if collect_telemetry:
                # the CONSUMED updates' telemetry (like the loss record): the
                # engine's statistics ride pending from train time; the
                # divergence and non-finite counts read the live stack
                # against the fresh aggregate
                pt = pending["telem"]
                train_loss = pending["losses"]["backward"].to(torch.float32)
                nan_row = torch.full_like(train_loss, float("nan"))
                round_telemetry = ptu.tree_map(client_all, RoundTelemetry(
                    train_loss=train_loss,
                    train_loss_min=pt["train_loss_min"],
                    train_loss_max=pt["train_loss_max"],
                    grad_norm_mean=pt["grad_norm_mean"],
                    grad_norm_max=pt["grad_norm_max"],
                    update_norm=pt["update_norm"],
                    clip_fraction=pending["losses"].get("clip_fraction", nan_row),
                    nonfinite_params=telem.per_client_nonfinite(client_states.params),
                    nonfinite_loss=telem.nonfinite_in_losses(pending["losses"]),
                    divergence=telem.per_client_divergence(
                        client_states.params, strategy.divergence_reference(new_server)),
                    nonfinite_eval_loss=torch.zeros_like(nan_row),
                    loss_scale_skips=pt.get("loss_scale_skips")))
            # -- eval: the fresh global, as a synchronous round -----------
            client_states, ev_losses, ev_metrics, _, _, *ev_nonfinite = eval_round(
                new_server, client_states, val_batches, val_counts)
            out = {"fit_losses": agg_losses, "fit_metrics": agg_metrics,
                   "per_client_fit_losses": ptu.tree_map(client_all, pending["losses"]),
                   "eval_losses": ev_losses, "eval_metrics": ev_metrics}
            if round_telemetry is not None:
                out["telemetry"] = round_telemetry.replace(nonfinite_eval_loss=ev_nonfinite[0])
            if quarantine_fn is not None:
                out["quarantine"] = client_all(quarantine_fn(new_server))
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

        b = self._program_builder
        return b.jit(async_prologue), b.jit(async_event)

    def _async_programs(self):
        """The async programs (their telemetry build when telemetry is on),
        built once a simulation."""
        if self._async_fns is None:
            self._async_fns = self._build_async_fns(self._telemetry_enabled)
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
        plans = engine.multi_client_index_plans(
            entropies, [d.n_train for d in self.datasets], self.batch_size,
            n_steps=self.local_steps, local_epochs=self.local_epochs)
        return self._local_rows(plans)

    def _local_rows(self, arrays):
        """This rank's client rows of global host ``[C, ...]`` arrays (the
        arrays themselves without a mesh)."""
        if self._n_local == self.n_clients:
            return arrays
        return tuple(a[self._client_lo:self._client_hi] for a in arrays)

    def _round_batches(self, round_idx: int) -> Batch:
        return engine.gather_batches(self._x_train_stack, self._y_train_stack,
                                     *self._round_plan(round_idx))

    def _eval_split_batches(self, x_stack, y_stack, ns) -> tuple[Batch, torch.Tensor]:
        """The val and test splits' batching: one fixed-order pass, and the
        per-client row counts."""
        idx, em, sm = self._local_rows(engine.multi_client_index_plans(
            [[0]] * self.n_clients, ns, self.batch_size, shuffle=False))
        lo, hi = self._client_lo, self._client_hi
        return (engine.gather_batches(x_stack, y_stack, idx, em, sm),
                torch.tensor(ns[lo:hi], dtype=torch.float32, device=self.device))

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
            local = self._local_datasets()
            self._test_cache = self._eval_split_batches(
                stack([d.x_test for d in local], "x_test", self.device),
                stack([d.y_test for d in local], "y_test", self.device),
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
        if self._cohort_active and self.recovery_policy is not None:
            return ("recovery supervision refreshes the quarantine "
                    "keep-mask against the live registry every round")
        if self._cohort_active and self.mesh_config is not None:
            return ("mesh + cohort stages each round's slot tensors "
                    "with sharded per-round device_put; the chunk's "
                    "window exchange is unsharded")
        if self.train_data_provider is not None:
            return "train_data_provider needs a host data refresh every round"
        if self.model_checkpointers:
            return "per-round model checkpointing needs per-round host access"
        # a snapshot-capable state checkpointer saves at chunk boundaries
        # (chunks of checkpoint_every rounds); only the legacy API, which
        # reads the live state every round, needs the per-round loop
        if (self.state_checkpointer is not None
                and not hasattr(self.state_checkpointer, "save_simulation_snapshot")):
            return ("legacy state checkpointer (save_simulation reads live "
                    "per-round state)")
        if not self.failure_policy.accept_failures:
            return "accept_failures=False must be able to terminate mid-run"
        obs = self.observability
        if (obs.enabled and obs.profile_round_idx is not None
                and obs.output_dir is not None):
            # without an output_dir maybe_profile() captures nothing
            return ("opt-in XProf capture (profile_round_idx) wraps one "
                    "round's dispatch")
        if obs.enabled and obs.per_round_spans:
            return ("per-round span fencing requested "
                    "(Observability(per_round_spans=True))")
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
        if self.observability.enabled and self.observability.admin is not None:
            # live retunes apply at per-round host boundaries, which a chunk
            # has none of; only the auto route demotes (a forced chunked
            # run answers submits with mid_chunk)
            return EXEC_PIPELINED, (
                "admin retune endpoint armed (live scalar rebinds apply "
                "at per-round boundaries)")
        return EXEC_CHUNKED, "auto: no per-round host dependencies"

    def fit(self, n_rounds: int) -> list[RoundRecord]:
        """Run ``n_rounds`` more rounds (numbered after those already in
        ``history``) through the chunked or the pipelined route
        (``execution_mode``); under ``async_config`` each round is a
        buffer-fill event of a fresh plan. Returns the whole history.
        ``fit(0)`` runs nothing.

        Under a ``state_checkpointer`` the numbering is JAX's: ``fit(n)``
        restores the newest good generation (round ``c``) where one exists
        and runs rounds ``c+1..n`` (``1..n`` on a fresh start), so a run
        killed after round ``c`` and rebuilt on the same directory goes on
        where it stopped. With ``profile_dir`` the whole call runs under
        one ``torch.profiler`` capture written there.

        Under ``recovery`` a ``RecoverySupervisor`` runs the call: after
        each recoverable abnormal end it rolls back (through the checkpoint
        ring, or to the initial state), applies its ladder's rung and
        enters ``_fit_unsupervised`` again."""
        if self.recovery_policy is not None:
            if self._recovery_supervisor is None:
                from fl4health_tpu_torch.resilience.supervisor import RecoverySupervisor

                self._recovery_supervisor = RecoverySupervisor(self, self.recovery_policy)
            return self._recovery_supervisor.run(n_rounds)
        return self._fit_unsupervised(n_rounds)

    def _fit_unsupervised(self, n_rounds: int) -> list[RoundRecord]:
        """One ``fit`` attempt without the recovery wrapper (the
        supervisor's entry point for each attempt)."""
        if self.profile_dir is not None:
            with profile_round(self.profile_dir):
                return self._fit_loop(n_rounds)
        return self._fit_loop(n_rounds)

    def _reset_to_initial(self) -> None:
        """Roll the live training state back to the constructor's init: the
        recovery supervisor's rollback when no checkpoint generation
        predates a failure. ``fit`` never changes ``self.rng`` or the
        init's generator seed, so ``_init_states`` rebuilds the fresh
        states bit for bit (a ``set_global_params`` made after construction
        is not kept, as in JAX). The cohort's stored rows, the history, the
        async buffer and the fleet ledger's records of the abandoned rounds
        go too."""
        if self._cohort_active:
            self.registry.reset_rows()
        self._init_states()
        self.history = []
        self._async_pending = None
        ledger = self.observability.fleet_ledger
        if ledger is not None:
            ledger.clear()

    def _build_compiled(self) -> None:
        """Rebuild the round functions from the current ``strategy`` (the
        supervisor's robustify rung swaps it); the chunked and cohort
        chunks are built from them at each dispatch, the async programs at
        their next use."""
        self._fit_round, self._eval_round = self._build_round_fns()
        if self._telemetry_enabled:
            self._fit_round_t, self._eval_round_t = self._build_round_fns(
                collect_telemetry=True)
        self._async_fns = None

    def _apply_recovery_keep(self, mask, rnd: int):
        """A round's sampling mask times the recovery supervisor's
        quarantine keep-mask; the input object itself while no supervisor
        is attached or nothing is quarantined, so an armed, idle policy
        changes no bit."""
        sup = self._recovery_supervisor
        if sup is None:
            return mask
        keep = sup.keep_mask(rnd, self.n_clients)
        if keep is None:
            return mask
        return mask * torch.as_tensor(keep, dtype=torch.float32, device=mask.device)

    def _note_recovery_round(self, rnd: int) -> None:
        """The round epilogue's last hook on every route, after the
        watchdog passed: the supervisor's probation and quarantine-release
        accounting. Nothing without a supervisor."""
        sup = self._recovery_supervisor
        if sup is not None:
            sup.note_round(rnd)

    def _apply_admin_retunes(self, rnd: int) -> None:
        """Round-boundary hook of every pipelined route, on the producer
        thread before the round reads ``server_state``: drain the admin
        plane's pending and scheduled retunes and rebind them on the live
        run — state-kind scalars through the sweep's
        ``apply_state_scalars`` (a server-state leaf swap: no extension
        build), the async staleness exponent by ``setattr`` (the next
        dispatch reads it). Nothing without an armed plane.

        Under a mesh only rank 0 serves the endpoint, so rank 0's drain
        (its live submits and its schedule) is broadcast and every rank
        applies the same values at this same boundary, keeping the ranks
        in lockstep; only rank 0 journals them."""
        obs = self.observability
        admin = obs.admin if obs.enabled else None
        if admin is None:
            return
        values = admin.drain(rnd)
        mesh = self._program_builder.mesh
        if mesh is not None:
            values = mesh.broadcast_object(values)
        if not values:
            return
        from fl4health_tpu_torch.sweep import hoisting

        try:
            state_vals = {n: v for n, v in values.items()
                          if hoisting.binding(n).kind == "state"}
            if state_vals:
                self.server_state = hoisting.apply_state_scalars(
                    self.strategy, self.server_state, state_vals)
            for name, value in values.items():
                if name not in state_vals:
                    b = hoisting.binding(name)
                    setattr(b.find(self.strategy), b.attr, float(value))
        except Exception:
            # submit() validated against this strategy chain, so this is a
            # race (the strategy swapped between submit and drain): a bad
            # retune must not end the run
            logging.getLogger(__name__).warning(
                "admin retune %r failed to apply at round %d", values, rnd,
                exc_info=True)
            return
        if mesh is None or mesh.is_leader:
            admin.note_applied(rnd, values)
            obs.update_manifest({"admin": admin.descriptor()})

    def _fit_loop(self, n_rounds: int) -> list[RoundRecord]:
        """``fit``'s body, JAX's ``_fit_loop``: arm the observability handle
        (an empty recorder and ledger), pick the route, resume, log the
        ``execution_mode`` event and the manifest, trap SIGTERM while a
        recorder is armed, run the route, publish a postmortem bundle on any
        abnormal end, and shut the handle down whatever happens."""
        obs = self.observability
        obs.start()  # re-arm after a previous fit()'s shutdown
        flight = obs.flight_recorder if obs.enabled else None
        if flight is not None:
            flight.clear()  # the black box records THIS run only
        fleet = obs.fleet_ledger if obs.enabled else None
        if fleet is not None:
            # a resume below adopts the frame's ledger, so replayed rounds
            # absorb exactly once
            fleet.clear()
        self._last_epilogue_round = None
        self._fit_n_rounds = n_rounds
        mode, reason = self._select_execution_mode(n_rounds)
        self._active_execution_mode = mode
        self._last_quarantine = None  # the transition accounting is per run
        self._cohort_quarantine = None
        logging.getLogger(__name__).info("fit: execution_mode=%s (%s)", mode, reason)
        # the async plan comes first: a resume checks its consumed prefix
        plan = None
        if self._async_active and n_rounds >= 1:
            if self._cohort_active:
                plan = build_registry_event_plan(self.async_config, n_rounds, self.n_clients,
                                                 self.registry_size, self._fault_plan)
            else:
                plan = build_event_plan(self.async_config, n_rounds, self.n_clients,
                                        self._fault_plan)
            self._async_plan = plan
        try:
            start = self._maybe_resume(n_rounds, plan)
        except BaseException as resume_exc:
            # a failed restore is a postmortem too
            self._dump_postmortem(resume_exc)
            obs.shutdown()
            raise
        if self._recovery_supervisor is not None:
            # after the restore: the supervisor applies its pending
            # mitigations (in-graph quarantine seeding, the server-lr
            # override) to the restored state and keeps /healthz at 503
            # while a recovery is on probation
            self._recovery_supervisor.on_resume(start)
        if obs.watchdog is not None and not self._telemetry_enabled:
            logging.getLogger(__name__).warning(
                "HealthWatchdog attached but in-graph telemetry is off "
                "(Observability(enabled=%s, telemetry=%s)) — no health "
                "checks will run.", obs.enabled, obs.telemetry)
        if obs.enabled and obs.admin is not None:
            # validation needs the live strategy chain and mode (a chunked
            # run refuses submits with mid_chunk); the manifest discloses
            # the plane from round 0
            obs.admin.bind_run(self.strategy, mode, async_active=self._async_active)
            obs.update_manifest({"admin": obs.admin.descriptor()})
        if obs.enabled and self._program_builder.mesh is not None:
            # one-time mesh gauges: a scraped page can divide by them
            b = self._program_builder
            obs.registry.gauge("fl_mesh_devices",
                               help="devices backing the round-program mesh",
                               ).set(float(b.n_devices))
            obs.registry.gauge("fl_mesh_client_axis",
                               help="size of the 'clients' (data-parallel) mesh axis",
                               ).set(float(b.client_axis_size))
            obs.registry.gauge("fl_mesh_model_axis",
                               help="size of the 'model' (tensor-parallel) mesh axis",
                               ).set(float(b.mesh.shape.get("model", 1)))
        if obs.enabled:
            obs.log_event("execution_mode", mode=mode, reason=reason)
            try:
                extra = ({"resume": dict(self._resume_info)}
                         if self._resume_info is not None else None)
                obs.update_manifest(run_manifest(
                    execution_mode=mode, execution_mode_reason=reason, device=self.device,
                    config=self._manifest_config(n_rounds), extra=extra,
                    mesh=self._program_builder.descriptor()))
            except Exception:
                logging.getLogger(__name__).warning("run manifest construction failed",
                                                    exc_info=True)
            # the payload byte counts, on this thread: the epilogues read the
            # cache
            self._payload_nbytes()
            if obs.introspection and n_rounds >= 1 and not self._async_active:
                # each round program once on fake tensors: no device work,
                # measured MFU for every round record (async runs skip it,
                # as in JAX: an event's work varies with the buffer)
                with obs.span("introspect", cat="fit"):
                    self._introspect_programs(
                        mode, self._rounds_per_dispatch(n_rounds, start))
        if flight is not None:
            facts: dict[str, Any] = {"execution_mode": mode, "execution_mode_reason": reason,
                                     "n_rounds": n_rounds, "start_round": start,
                                     "config_hash": obs.manifest.get("config_hash")}
            if self._cohort_active:
                facts["cohort_slots"] = self.n_clients
                facts["registry_size"] = self.registry_size
            if self._async_active:
                facts["async"] = True
            flight.set_run_facts(**facts)
        for rep in self.reporters:
            rep.report({"host_type": "server", "fit_start": time.time(),
                        "num_rounds": n_rounds, "execution_mode": mode,
                        "execution_mode_reason": reason})
        self._sigterm_round = None

        def _note_sigterm() -> None:
            # inside the signal handler: the round the run was at, read
            # without the recorder's lock (the handler may interrupt the
            # thread that holds it)
            if flight is not None:
                self._sigterm_round = flight.last_round_hint

        try:
            # a SIGTERM becomes a SigtermShutdown raised in this thread, so
            # every finally (the writer, the consumer) runs, the bundle is
            # published below and the process exits 143
            with (trap_sigterm(on_signal=_note_sigterm) if flight is not None
                  else contextlib.nullcontext()):
                self._run_route(n_rounds, mode, plan, start)
        except BaseException as e:
            self._dump_postmortem(e)
            raise
        finally:
            # always: the failed run's trace and metrics are the ones most
            # wanted on disk
            artifacts = obs.shutdown()
        for rep in self.reporters:
            if artifacts:
                rep.report({"observability_artifacts": dict(artifacts)})
            rep.report({"fit_end": time.time()})
            rep.shutdown()
        return self.history

    def _run_route(self, n_rounds: int, mode: str, plan, start: int) -> None:
        """The rounds of one ``fit`` call through the selected route."""
        if n_rounds < 1:
            return
        if self.state_checkpointer is not None:
            first, last = start, n_rounds
        else:
            first = len(self.history) + 1
            last = first + n_rounds - 1
        self._fit_last_round = last
        if self._async_active:
            # event e's record is number first + e - 1: e itself under a
            # checkpointer (JAX's numbering), else after ``history``
            self._fit_async(plan, mode, 1 if self.state_checkpointer is not None
                            else first, start)
        elif self._cohort_active:
            (self._fit_cohort_chunked if mode == EXEC_CHUNKED
             else self._fit_cohort)(first, last)
        elif mode == EXEC_CHUNKED:
            self._fit_chunked(first, last)
        else:
            self._fit_pipelined(first, last)
        if self._program_builder.mesh is not None:
            # the leader's frames are durable before any rank goes on (a
            # later fit on another rank may restore from them)
            self._program_builder.mesh.barrier()

    def _dump_postmortem(self, exc: BaseException) -> None:
        """Publish a postmortem bundle for an abnormal end of ``fit``
        (``observability/bundle.py``): classify ``exc`` into a verdict,
        publish ``postmortem_<ts>/`` under the output dir and flip
        ``/healthz`` to 503. By the time ``exc`` reaches here the routes'
        ``finally`` blocks have closed the consumer (draining its epilogues
        into the ring) and drained the checkpoint writer, so the ring and
        the newest good generation are as complete as the process can make
        them. Never raises: the primary failure propagates untouched."""
        obs = self.observability
        if not obs.enabled or obs.output_dir is None:
            return
        try:
            from fl4health_tpu_torch.observability.bundle import verdict_from_exception

            verdict = verdict_from_exception(exc, recorder=obs.flight_recorder)
            if verdict.get("kind") == "sigterm" and self._sigterm_round is not None:
                # the handler's reading wins: drains during the unwind may
                # have recorded later rounds
                verdict["round"] = self._sigterm_round
            if self._last_epilogue_round is not None:
                verdict["epilogues_through_round"] = self._last_epilogue_round
            path = obs.dump_bundle(verdict)
            if path:
                obs.log_event("postmortem", path=path, kind=verdict.get("kind"),
                              round=verdict.get("round"))
                logging.getLogger(__name__).warning(
                    "abnormal end (%s) — postmortem bundle published at %s",
                    verdict.get("kind"), path)
        except Exception:
            logging.getLogger(__name__).warning(
                "postmortem bundle dump failed (the primary exception propagates)",
                exc_info=True)

    # -- crash-consistent checkpoint and resume -------------------------
    def _manifest_config(self, n_rounds: int) -> dict:
        """The run's JSON-able config facts, as JAX's manifest lists them."""
        config = {
            "n_clients": self.n_clients,
            "batch_size": self.batch_size,
            "local_epochs": self.local_epochs,
            "local_steps": self.local_steps,
            "n_rounds": n_rounds,
            "strategy": type(self.strategy).__name__,
            "exchanger": type(self.exchanger).__name__,
            "client_manager": type(self.client_manager).__name__,
            "execution_mode": self.execution_mode,
            "telemetry": self._telemetry_enabled,
            "compression": (self.compression.describe()
                            if self.compression is not None and self.compression.enabled
                            else None),
            "precision": (self.precision.describe()
                          if self.precision is not None and self.precision.active else None),
        }
        if self._cohort_active:
            config["cohort"] = {"slots": self.cohort_config.slots,
                                "registry_size": self.registry_size}
        if self._async_active:
            config["async"] = self.async_config.describe()
        if self._program_builder.mesh is not None:
            # a sharded and an unsharded run of one recipe are different
            # experiments (the resume hash leaves it out: placement only)
            config["mesh"] = self._program_builder.descriptor()
        return config

    def _resume_config_hash(self) -> str:
        """The experiment identity a checkpoint binds to: the manifest
        config without what may differ between a run and its resume
        (``n_rounds``, ``execution_mode``: the routes are bit-equal,
        ``telemetry``, ``mesh``). Equal to JAX's for the same recipe."""
        return config_hash({k: v for k, v in self._manifest_config(0).items()
                            if k not in ("n_rounds", "execution_mode", "telemetry", "mesh")})

    def adopt_restored_state(self, server_state, client_states, pending=None) -> None:
        """Install restored host trees as the live state, on the simulation's
        device, in the live trees' dtypes (the frame keeps every dtype)."""
        b = self._program_builder
        if pending is not None:
            pending = ptu.tree_map(
                lambda a: (a if isinstance(a, torch.Tensor)
                           else torch.from_numpy(np.array(a))).to(self.device), pending)
        if b.mesh is not None:
            # a frame holds the global trees: keep this rank's block
            server_state = b.put(server_state, self._server_placement())
            client_states = b.put(client_states, self._client_placement())
            if pending is not None:
                pending = b.put(pending, b.client_sharding())
        self.server_state = leaves_like(self.server_state, server_state, self.device)
        self.client_states = leaves_like(self.client_states, client_states, self.device)
        if pending is not None:
            self._async_pending = pending

    def _ckpt_every(self) -> int | None:
        """The snapshot checkpointer's cadence in rounds (None without a
        snapshot-capable checkpointer)."""
        sc = self.state_checkpointer
        if sc is None or not hasattr(sc, "save_simulation_snapshot"):
            return None
        return max(int(getattr(sc, "checkpoint_every", 1) or 1), 1)

    def _checkpoint_due(self, rnd: int) -> bool:
        every = self._ckpt_every()
        if every is None:
            return False
        return rnd % every == 0 or rnd >= self._fit_last_round

    def _async_pending_template(self, val_batches):
        """The ``pending`` buffer's structure, the template a frame's
        restore reads (it takes the structure and the frame's values):
        the prologue run once on fake tensors (``FakeTensorMode``: no
        device work, no kernel launch, a kernel's fake branch answers) with
        one step of one example a client (``pending``'s structure depends
        on neither)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        prologue, _ = self._async_programs()
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        fake = lambda tree: ptu.tree_map(  # noqa: E731
            lambda t: mode.from_tensor(t) if isinstance(t, torch.Tensor) else t, tree)

        def one_example(b: Batch) -> Batch:
            cut = lambda t: t[:, :1, :1]  # noqa: E731
            return fake(Batch(x=ptu.tree_map(cut, b.x), y=ptu.tree_map(cut, b.y),
                              example_mask=cut(b.example_mask), step_mask=b.step_mask[:, :1]))

        # the batches are staged (on the card, from pinned memory) before
        # the fake mode starts
        args = (fake(self.server_state), fake(self.client_states),
                one_example(self._round_batches(1)), one_example(val_batches))
        with mode:
            _, pending = prologue(*args)
        return pending

    def _maybe_resume(self, n_rounds: int, plan=None) -> int:
        """Bind the checkpointer to this run (its config hash and the save
        stats' hook) and restore the newest good generation where one
        exists. Returns the first round (event) to run: 1 on a fresh start.
        ``_resume_info`` keeps the restore's facts (JAX's manifest
        ``resume`` descriptor, and the restore's host seconds)."""
        self._resume_info = None
        sc = self.state_checkpointer
        if sc is None:
            return 1
        if getattr(sc, "config_hash", "absent") is None:
            sc.config_hash = self._resume_config_hash()
        if getattr(sc, "on_save", "absent") is None:
            sc.on_save = self._note_checkpoint
        if not (hasattr(sc, "exists") and sc.exists()):
            return 1
        t0 = time.perf_counter()
        if self._async_active:
            if n_rounds < 1:
                return 1
            template = self._async_pending_template(self._val_batches()[0])
            start = sc.load_async_simulation(self, template, plan)
        elif self._cohort_active:
            start = sc.load_cohort_simulation(self)
        elif hasattr(sc, "load_simulation"):
            start = sc.load_simulation(self)
        else:
            return 1
        info = getattr(sc, "last_restore_info", None)
        self._resume_info = {"next_round": int(start),
                             "kind": ("async" if self._async_active
                                      else "cohort" if self._cohort_active else "sync"),
                             # the read, the checks and the copies onto the
                             # device, enqueued (not synchronised)
                             "restore_s": time.perf_counter() - t0}
        if info is not None:
            self._resume_info.update(path=info.path, generation=info.generation,
                                     bytes=info.nbytes,
                                     fallback_skipped=list(info.fallback_skipped))
        obs = self.observability
        if obs.enabled:
            reg = obs.registry
            reg.counter("fl_ckpt_restores_total",
                        help="state-checkpoint restores (resumed runs)").inc()
            if info is not None and info.fallback_skipped:
                reg.counter("fl_ckpt_fallbacks_total",
                            help="corrupt checkpoint generations skipped by the "
                                 "retention-ring fallback at restore",
                            ).inc(len(info.fallback_skipped))
            obs.log_event("resume", **self._resume_info)
        logging.getLogger(__name__).info("resumed from checkpoint: next %s %d",
                                         "event" if self._async_active else "round", start)
        return start

    def _note_checkpoint(self, stats: dict) -> None:
        """The state checkpointer's save stats (path, generation, bytes,
        write_s, ...) into the saved round's ``round_metrics`` entry under
        ``"checkpoint"``, and JAX's ``fl_ckpt_*`` metrics, ``checkpoint``
        event and recorder note (``_emit_checkpoint_stats``). Runs on
        whichever thread wrote the frame."""
        rnd = stats.get("round")
        entry = next((m for m in reversed(self.round_metrics) if m.get("round") == rnd), None)
        if entry is None:
            self.round_metrics.append({"round": rnd, "checkpoint": dict(stats)})
        else:
            entry["checkpoint"] = dict(stats)
        self._emit_checkpoint_stats(stats)

    def _emit_checkpoint_stats(self, stats: dict) -> None:
        """``fl_ckpt_*`` metrics and one ``checkpoint`` JSONL event a durable
        save, and the flight recorder's "what to resume from" note."""
        obs = self.observability
        if not obs.enabled:
            return
        reg = obs.registry
        write_s = float(stats.get("write_s", 0.0))
        reg.counter("fl_ckpt_writes_total", help="durable state-checkpoint writes").inc()
        reg.counter("fl_ckpt_bytes_written_total",
                    help="bytes of durable state-checkpoint frames written",
                    ).inc(int(stats.get("bytes", 0)))
        reg.counter("fl_ckpt_write_seconds_total",
                    help="wall seconds spent serializing+writing state checkpoints "
                         "(off the round loop under the async writer)").inc(write_s)
        reg.gauge("fl_ckpt_last_write_ms",
                  help="wall milliseconds of the most recent checkpoint write",
                  ).set(write_s * 1000.0)
        reg.gauge("fl_ckpt_generation",
                  help="newest durable checkpoint generation in the retention ring",
                  ).set(float(stats.get("generation", 0)))
        reg.log_event("checkpoint", round=stats.get("round"),
                      generation=stats.get("generation"), bytes=stats.get("bytes"),
                      write_ms=round(write_s * 1000.0, 3), path=stats.get("path"),
                      kind=stats.get("kind", "sync"))
        if obs.flight_recorder is not None:
            obs.flight_recorder.note_checkpoint(stats)

    def _close_ckpt_writer(self, writer) -> None:
        """Close the writer on every exit path and raise its stored failure,
        without masking an exception already in flight: a halted run still
        publishes its last completed round's checkpoint."""
        writer.close()
        in_flight = sys.exc_info()[1] is not None
        try:
            writer.raise_pending()
        except BaseException:
            if not in_flight:
                raise
            logging.getLogger(__name__).warning(
                "checkpoint write failed during error shutdown (the "
                "primary exception propagates)", exc_info=True)

    @contextlib.contextmanager
    def _ckpt_writer_scope(self, active: bool, attach_model_ckpts: bool = False):
        """The async writer's lifetime, shared by every route: a fresh
        ``AsyncCheckpointWriter`` (None when not ``active``), flushed on a
        clean exit, closed on every exit (``_close_ckpt_writer``), the model
        checkpointers attached for the run and detached after."""
        if not active:
            yield None
            return
        writer = self._ckpt_writer = AsyncCheckpointWriter()
        attached = []
        if attach_model_ckpts:
            for _mode, ckpt in self.model_checkpointers:
                if hasattr(ckpt, "async_writer"):
                    ckpt.async_writer = writer
                    attached.append(ckpt)
        try:
            yield writer
            writer.flush()  # a clean exit: every submitted write is durable
        finally:
            try:
                self._close_ckpt_writer(writer)
            finally:
                for ckpt in attached:
                    ckpt.async_writer = None
                self._ckpt_writer = None

    def _snapshot_trees(self, pending=None) -> dict:
        """The state trees a snapshot pulls: the live trees themselves, since
        no round writes into its inputs (every round returns new tensors),
        so the next round cannot overwrite them before the pull, which rides
        the round's (or the chunk's) one ``HostPull``; with an async run's
        ``pending`` buffer where given."""
        trees = {"server_state": self.server_state, "client_states": self.client_states}
        b = self._program_builder
        if b.mesh is not None:
            # a frame holds the global trees: every rank's block gathered
            trees = {"server_state": b.gather(self.server_state, self._server_placement()),
                     "client_states": b.gather(self.client_states, self._client_placement())}
        if pending is not None:
            trees["pending"] = b.gather(pending, b.client_sharding())
        return trees

    def _gather_client_params(self, params):
        """Every client's params from this rank's block (itself without a
        mesh)."""
        b = self._program_builder
        place = self._client_placement()
        if place is None:
            return params
        return b.gather(params, place.params if isinstance(place, TrainState) else place)

    def _introspect_programs(self, mode: str, n_rounds: int) -> None:
        """The ``program`` and ``stage`` records of the round programs this
        ``fit`` will dispatch (``observability/introspect.py``), with JAX's
        names: ``fit_round[_t]``, ``eval_round[_t]`` (and
        ``eval_round[_t]_test``) on the pipelined route, ``fit_chunk_eval``
        on the dense chunked route, the slot programs and
        ``fit_cohort_chunk`` (``cohort_draw="in_graph"``) under a cohort.

        Each program runs once on fake tensors: arguments the route builds
        per round (batches, masks, plans, the cohort's slot tensors and
        window) are meta placeholders of their shapes, so no device work
        runs and the trajectory cannot change. A chunk is traced for one
        round and scaled by its ``n_rounds`` (its rounds are one function
        run back to back), so the cost does not grow with the run. Sets the
        per-round flops that measured MFU reads. Failures degrade to a
        warning: introspection must not take down a run."""
        intro = self.observability.introspector
        mesh_desc = self._program_builder.descriptor()
        prec = self.precision.describe() if self._precision_active else None
        dev = self.device
        meta = lambda shape, dtype=torch.float32: torch.empty(  # noqa: E731
            shape, dtype=dtype, device="meta")
        fit_fn, eval_fn, telemetry_on = self._round_fns()
        fit_name, eval_name = (("fit_round_t", "eval_round_t") if telemetry_on
                               else ("fit_round", "eval_round"))
        try:
            if self._cohort_active:
                # slot shapes only: a function of (slots, step budgets,
                # batch, example shape), never of the registry size
                aa = self.registry.abstract_round_args(self._n_local)
                aa["mask"] = meta((self.n_clients,))  # the whole mask: a round takes its block
                intro.introspect_fn(
                    fit_name, fit_fn,
                    (self.server_state, self.client_states, aa["batches"], aa["mask"], 1,
                     aa["val_batches"], aa["sample_counts"]), device=dev, precision=prec,
                    mesh=mesh_desc)
                intro.introspect_fn(
                    eval_name, eval_fn,
                    (self.server_state, self.client_states, aa["val_batches"],
                     aa["val_counts"]), device=dev, precision=prec, mesh=mesh_desc)
                self._round_program_flops = intro.round_flops((fit_name, eval_name))
                if mode == EXEC_CHUNKED:
                    ca = self.registry.abstract_chunk_args(self.n_clients, n_rounds)
                    first = lambda tree: ptu.tree_map(lambda a: a[:1], tree)  # noqa: E731
                    w = ca["window_ids"].shape[0]
                    window = lambda tree: ptu.tree_map(  # noqa: E731
                        lambda a: meta((w, *a.shape[1:]), a.dtype), tree)
                    w_srows = (window(self.strategy.state_rows(self.server_state))
                               if self.registry.has_strategy_rows else None)
                    intro.introspect_fn(
                        "fit_cohort_chunk", self._make_cohort_chunk(),
                        (self.server_state, self.client_states, window(self.client_states),
                         w_srows, self.rng, ca["window_ids"], first(ca["batches"]),
                         first(ca["mask"]), first(ca["sample_counts"]),
                         first(ca["val_batches"]), first(ca["val_counts"]), 1),
                        device=dev, rounds_per_dispatch=n_rounds, cohort_draw="in_graph",
                        precision=prec, mesh=mesh_desc)
                intro.hbm_headroom_bytes(dev.index or 0)
                return
            val_batches, val_counts = self._val_batches()
            test = self._test_batches()
            idx, em, sm = self._round_plan(1)
            if mode == EXEC_CHUNKED:
                args = [self.server_state, self.client_states, self._x_train_stack,
                        self._y_train_stack, meta((1, *idx.shape), torch.int64),
                        meta((1, *em.shape)), meta((1, *sm.shape)),
                        meta((1, self.n_clients)), 1, val_batches, val_counts, *(test or ())]
                intro.introspect_fn("fit_chunk_eval", self._make_chunked_fit_with_eval(),
                                    tuple(args), device=dev, rounds_per_dispatch=n_rounds,
                                    precision=prec, mesh=mesh_desc)
                names: tuple[str, ...] = ("fit_chunk_eval",)
            else:
                c, steps, b = idx.shape
                gathered = lambda tree: ptu.tree_map(  # noqa: E731
                    lambda x: meta((c, steps, b, *x.shape[2:]), x.dtype), tree)
                batches = Batch(x=gathered(self._x_train_stack),
                                y=gathered(self._y_train_stack),
                                example_mask=meta(em.shape), step_mask=meta(sm.shape))
                intro.introspect_fn(
                    fit_name, fit_fn,
                    (self.server_state, self.client_states, batches, meta((self.n_clients,)),
                     1, val_batches), device=dev, precision=prec, mesh=mesh_desc)
                intro.introspect_fn(
                    eval_name, eval_fn,
                    (self.server_state, self.client_states, val_batches, val_counts),
                    device=dev, precision=prec, mesh=mesh_desc)
                names = (fit_name, eval_name)
                if test is not None:
                    # the same eval function on the test split's shapes
                    intro.introspect_fn(
                        eval_name + "_test", eval_fn,
                        (self.server_state, self.client_states, *test),
                        device=dev, precision=prec, mesh=mesh_desc)
                    names += (eval_name + "_test",)
            self._round_program_flops = intro.round_flops(names)
            intro.hbm_headroom_bytes(dev.index or 0)
        except Exception:
            logging.getLogger(__name__).warning(
                "round-program introspection failed (continuing without measured "
                "MFU)", exc_info=True)

    def _fit_pipelined(self, first: int, last: int) -> None:
        """Rounds ``first..last``: this thread dispatches each round and
        submits its host epilogue to a ``RoundConsumer``; a
        ``RoundPrefetcher`` stages the next round's batches meanwhile."""
        obs = self.observability
        with obs.span("setup", cat="fit"):
            val_batches, val_counts = self._val_batches()
        self._fit_last_round = last
        # the writer scope flushes on a clean exit and, on an error, drains
        # and raises write failures without masking the error
        with self._ckpt_writer_scope(bool(self.model_checkpointers
                                          or self.state_checkpointer is not None),
                                     attach_model_ckpts=True):
            consumer = self._consumer = RoundConsumer(maxsize=self.pipeline_depth)
            prefetcher = self._prefetcher = RoundPrefetcher(self)
            try:
                if first <= last:
                    prefetcher.schedule(first)
                for rnd in range(first, last + 1):
                    consumer.raise_pending()
                    with obs.maybe_profile(rnd):
                        self._run_round(rnd, val_batches, val_counts)
                consumer.flush()  # barrier: every round's epilogue has run
            finally:
                consumer.close()
                prefetcher.close()
                # for the verdict: the newest round whose epilogue finished
                self._last_epilogue_round = consumer.last_completed_round
                self._consumer = self._prefetcher = None

    def _round_fns(self):
        """(fit_round, eval_round, telemetry_on): the telemetry builds when
        telemetry is on, else the plain ones (read at call time, so a test's
        swap of ``_fit_round`` reaches the plain routes)."""
        if self._telemetry_enabled:
            return self._fit_round_t, self._eval_round_t, True
        return self._fit_round, self._eval_round, False

    def _compile_counts(self) -> tuple[float, float]:
        """The compile counters (kernel-extension builds and their seconds)
        where observability is on, else zeros."""
        obs = self.observability
        if not obs.enabled:
            return 0.0, 0.0
        return (obs.registry.counter("jax_backend_compiles_total").value,
                obs.registry.counter("jax_backend_compiles_seconds_total").value)

    def _snapshot_span(self, rnd: int, what: str):
        """The ``state_snapshot`` span where the round sends trees to a
        checkpointer, else no span."""
        if self.model_checkpointers or self._checkpoint_due(rnd):
            return self.observability.span("state_snapshot", round=rnd, what=what)
        return contextlib.nullcontext()

    def _run_round(self, rnd: int, val_batches, val_counts) -> None:
        """The producer's half of a round: sample, dispatch fit, eval (and
        the test eval) and ``update_after_eval``, start the results' pull,
        and hand the round to the consumer. Nothing here waits for the
        device, unless observability fences it (``sync_device``)."""
        obs = self.observability
        consumer, prefetcher = self._consumer, self._prefetcher
        fit_round, eval_round, telemetry_on = self._round_fns()
        compiles_before, compile_s_before = self._compile_counts()
        device_wait_s = 0.0
        t0 = time.time()
        with obs.span("round", round=rnd):
            with obs.span("configure_fit", round=rnd):
                if self.train_data_provider is not None:
                    fresh = self.train_data_provider(rnd)
                    if fresh is not None:
                        self.set_train_data(*fresh)
                # admin retunes land here: before anything reads
                # server_state, after the provider (a submit made from it
                # applies this round)
                self._apply_admin_retunes(rnd)
                mask = self.client_manager.sample(rng.fold_in(self.rng, 2000 + rnd), rnd)
                if obs.watchdog is not None:
                    # the watchdog's quarantined clients are sampled out of
                    # later rounds (None while nothing is quarantined)
                    keep = obs.watchdog.quarantine_keep_mask(self.n_clients)
                    if keep is not None:
                        mask = mask * torch.as_tensor(np.asarray(keep, np.float32),
                                                      device=mask.device)
                # the recovery supervisor's quarantine: the suspects an
                # engagement named stay sampled out until their release
                mask = self._apply_recovery_keep(mask, rnd)
                batches = (prefetcher.take(rnd) if prefetcher is not None
                           else self._round_batches(rnd))
            if prefetcher is not None and rnd < self._fit_last_round:
                prefetcher.schedule(rnd + 1)  # stage round r+1 while round r runs
            with obs.span("fit_round", round=rnd) as fit_span:
                (self.server_state, self.client_states, fit_losses, fit_metrics,
                 per_client_fit_losses, *telemetry) = fit_round(
                    self.server_state, self.client_states, batches, mask, rnd, val_batches)
                self.rounds_dispatched += 1
                _, wait = obs.fence((fit_losses, fit_metrics, per_client_fit_losses))
                device_wait_s += wait
                fit_span.set(device_wait_s=wait)
            # the clients' trained params, before eval replaces them with the
            # global model (a pre-aggregation checkpointer's tree)
            post_fit_params = self.client_states.params
            t1 = time.time()
            with obs.span("eval_round", round=rnd) as eval_span:
                (self.client_states, eval_losses, eval_metrics, per_client_eval_losses,
                 per_client_eval_metrics, *ev_nonfinite) = eval_round(
                    self.server_state, self.client_states, val_batches, val_counts)
                self.server_state = self.strategy.update_after_eval(
                    self.server_state, per_client_eval_losses, per_client_eval_metrics, mask)
                _, eval_wait = obs.fence((eval_losses, eval_metrics))
                results = {"mask": mask, "fit_losses": fit_losses, "fit_metrics": fit_metrics,
                           "per_client_fit_losses": per_client_fit_losses,
                           "eval_losses": eval_losses, "eval_metrics": eval_metrics}
                if telemetry_on:
                    # rides the round's one pull
                    results["telemetry"] = telemetry[0].replace(
                        nonfinite_eval_loss=ev_nonfinite[0])
                self._ship_quarantine_mask(results)
                test = self._test_batches()
                if test is not None:
                    # the same aggregated model on the test split, its keys
                    # "test - "-prefixed beside the val keys
                    self.client_states, results["test_losses"], results["test_metrics"] = (
                        eval_round(self.server_state, self.client_states, *test)[:3])
                    eval_wait += obs.fence((results["test_losses"],
                                            results["test_metrics"]))[1]
                device_wait_s += eval_wait
                eval_span.set(device_wait_s=eval_wait)
            with self._snapshot_span(rnd, "post_agg"):
                snap = self._round_snapshots(results, rnd, post_fit_params)
            compiles_after, compile_s_after = self._compile_counts()
            work = _RoundWork(round=rnd, pull=HostPull(results), fit_elapsed_s=t1 - t0,
                              eval_elapsed_s=time.time() - t1, snapshot_dtypes=snap,
                              device_wait_s=device_wait_s, compiles_before=compiles_before,
                              compile_s_before=compile_s_before,
                              compiles_after=compiles_after, compile_s_after=compile_s_after)
            if consumer is None:  # no pipeline: the epilogue inline
                self._finish_round(work)
                return
            consumer.submit_round(rnd, functools.partial(self._finish_round, work))
            legacy_state_save = (self.state_checkpointer is not None
                                 and not hasattr(self.state_checkpointer,
                                                 "save_simulation_snapshot"))
            if legacy_state_save or not self.failure_policy.accept_failures:
                # the legacy checkpointer reads the live state, and the
                # failure screen must end the run: both before the next
                # round dispatches
                consumer.flush()

    def _round_snapshots(self, results: dict, rnd: int, post_fit_params=None,
                         with_pending: bool = False) -> dict | None:
        """Add the round's checkpoint trees to its results, so they ride the
        round's one pull: the clients' post-fit params for a pre-aggregation
        checkpointer, the global params for a post-aggregation one, and the
        state trees when a snapshot is due. Returns their dtypes (None when
        nothing rides)."""
        modes = {m for m, _ in self.model_checkpointers}
        trees = {}
        if CheckpointMode.PRE_AGGREGATION in modes and post_fit_params is not None:
            trees["_pre_agg_params"] = self._gather_client_params(post_fit_params)
        if CheckpointMode.POST_AGGREGATION in modes:
            trees["_post_agg_params"] = self.global_params
        if (self.state_checkpointer is not None
                and hasattr(self.state_checkpointer, "save_simulation_snapshot")
                and self._checkpoint_due(rnd)):
            trees["_state_trees"] = self._snapshot_trees(
                self._async_pending if with_pending else None)
        results.update(trees)
        return _dtypes(trees) if trees else None

    def _finish_round(self, work: _RoundWork) -> None:
        """The consumer's half of a round: the round's one device->host
        pull, the failure screen, the ``RoundRecord``, the fleet ledger, the
        round's records (``_record_round_metrics``), the state frame, the
        reports and last the watchdog, in round order. Launches nothing on
        the device. A cohort round's pull also brought its updated rows:
        they go into the registry first, then the producer's next gather
        may run."""
        obs = self.observability
        rnd = work.round
        host = work.pull.result()
        snaps = {k: host_snapshot(host.pop(k), work.snapshot_dtypes[k])
                 for k in ("_pre_agg_params", "_post_agg_params", "_state_trees")
                 if k in host}
        registry_rows = host.pop("_registry_rows", None)
        quarantine_mask = host.pop("_quarantine", None)
        telemetry_obj = host.pop("telemetry", None)
        telemetry_host = (telem.telemetry_from_dict(telemetry_obj)
                          if telemetry_obj is not None else None)
        cohort_info = work.cohort_info
        if registry_rows is not None:
            meta = work.cohort_meta
            with obs.span("registry_scatter", round=rnd, valid=meta["valid"]) as sc_span:
                s0 = time.perf_counter()
                self.registry.scatter(meta["idx"], meta["valid"],
                                      registry_rows["client_states"],
                                      registry_rows.get("strategy_rows"))
                scatter_ms = (time.perf_counter() - s0) * 1e3
                sc_span.set(scatter_ms=scatter_ms)
            meta["scatter_event"].set()
            cohort_info = self._cohort_info(meta, scatter_ms, work.pull)
        mask = np.asarray(host["mask"])
        host_fit_losses = host["per_client_fit_losses"]
        with obs.span("aggregate", round=rnd):
            try:
                failed = self.failure_policy.check(host_fit_losses, mask)
            except ClientFailuresError as cf:
                cf.round = rnd
                if work.cohort_meta is not None:
                    # a cohort round fails by slot: name the registry ids
                    ids = np.asarray(work.cohort_meta["idx"])
                    cf.registry_clients = [int(ids[c]) for c in cf.clients
                                           if 0 <= c < len(ids)]
                raise
            floats = lambda d, prefix="": {  # noqa: E731
                f"{prefix}{k}": float(v) for k, v in d.items()}
            eval_losses = floats(host["eval_losses"])
            eval_metrics = floats(host["eval_metrics"])
            if "test_losses" in host:
                eval_losses.update(floats(host["test_losses"], "test - "))
                eval_metrics.update(floats(host["test_metrics"], "test - "))
        rec = RoundRecord(round=rnd, fit_losses=floats(host["fit_losses"]),
                          fit_metrics=floats(host["fit_metrics"]),
                          eval_losses=eval_losses, eval_metrics=eval_metrics,
                          fit_elapsed_s=work.fit_elapsed_s,
                          eval_elapsed_s=work.eval_elapsed_s)
        leader_ckpts = self.model_checkpointers if self._is_leader else []
        with obs.span("checkpoint", round=rnd, mode="pre_aggregation"):
            for mode, ckpt in leader_ckpts:
                if mode == CheckpointMode.PRE_AGGREGATION:
                    ckpt.maybe_checkpoint(snaps.get("_pre_agg_params"),
                                          rec.fit_losses.get("backward", float("nan")),
                                          rec.fit_metrics)
        with obs.span("checkpoint", round=rnd, mode="post_aggregation"):
            for mode, ckpt in leader_ckpts:
                if mode == CheckpointMode.POST_AGGREGATION:
                    ckpt.maybe_checkpoint(snaps.get("_post_agg_params"),
                                          rec.eval_losses.get("checkpoint", float("nan")),
                                          rec.eval_metrics)
        self.history.append(rec)
        event = work.event if work.event is not None else rnd
        registry_ids = (np.asarray(work.cohort_meta["idx"])
                        if work.cohort_meta is not None else None)
        # the ledger absorbs BEFORE the round's frame: the frame's ledger is
        # as-of this round, so a resume absorbs each round once
        fleet_info = self._fleet_absorb_round(
            rnd, mask, host_fit_losses, telemetry_host, registry_ids=registry_ids,
            quarantine_mask=quarantine_mask, failed=failed, async_info=work.async_info,
            fault_round=event)
        summary = self._record_round_metrics(
            rnd, rec, mask, host_fit_losses, failed, work.compiles_before,
            work.compile_s_before, work.device_wait_s, compiles_after=work.compiles_after,
            compile_s_after=work.compile_s_after, telemetry=telemetry_host,
            async_info=work.async_info, cohort_info=cohort_info, fleet_info=fleet_info,
            registry_ids=registry_ids, fault_round=event)
        if quarantine_mask is not None:
            # a cohort round names its quarantined clients by registry id
            self._emit_quarantine_metrics(rnd, np.asarray(quarantine_mask), ids=registry_ids)
        if self.state_checkpointer is not None:
            with obs.span("checkpoint", round=rnd, mode="state"):
                self._save_round_state(work, snaps.get("_state_trees"))
        with obs.span("report", round=rnd):
            for rep in self.reporters:
                payload = {"fit_losses": rec.fit_losses, "fit_metrics": rec.fit_metrics,
                           "eval_losses": rec.eval_losses, "eval_metrics": rec.eval_metrics,
                           "fit_elapsed_s": rec.fit_elapsed_s,
                           "eval_elapsed_s": rec.eval_elapsed_s,
                           "execution_mode": EXEC_PIPELINED}
                if summary is not None:
                    payload["observability"] = dict(summary)
                rep.report(payload, round=rnd)
        # the watchdog LAST: the round's record, metrics and reports land
        # before a halt (raised into the producer through the consumer)
        if telemetry_host is not None and obs.watchdog is not None:
            obs.watchdog.observe(rnd, telemetry_host, mask,
                                 rec.fit_losses.get("backward", float("nan")),
                                 obs=obs, reporters=self.reporters)
        # recovery probation: a round counts healthy once the watchdog
        # passed it (a halt above skips this)
        self._note_recovery_round(rnd)

    def _save_round_state(self, work: _RoundWork, trees: dict | None) -> None:
        """The round's state checkpoint, after its record: the async frame
        (with ``pending``, the plan-prefix fingerprint and the virtual
        clock), the cohort frame (with the registry's rows, exported after
        this round's scatter) or the sync one, each with the fleet ledger's
        snapshot where one is armed; the legacy API reads the live state
        (the producer waited for this epilogue)."""
        sc = self.state_checkpointer
        if sc is None or not self._is_leader:
            return
        rnd = work.event if work.event is not None else work.round
        history = list(self.history)
        if trees is not None:
            fleet = self._fleet_snapshot_doc()
            if work.resume_meta is not None:
                sc.save_async_snapshot(trees, rnd, self.n_clients, history,
                                       plan_fingerprint=work.resume_meta["plan_fingerprint"],
                                       virtual_time_s=work.resume_meta["virtual_time_s"],
                                       writer=self._ckpt_writer, fleet=fleet)
            elif work.cohort_meta is not None:
                sc.save_cohort_snapshot(trees, rnd, self.n_clients, self.registry_size,
                                        self.registry.export_rows(), history,
                                        writer=self._ckpt_writer, fleet=fleet)
            else:
                sc.save_simulation_snapshot(trees, rnd, self.n_clients, history,
                                            writer=self._ckpt_writer, fleet=fleet)
        elif not hasattr(sc, "save_simulation_snapshot"):
            sc.save_simulation(self, rnd)

    # -- observability records (observability/) --------------------------
    @property
    def _is_leader(self) -> bool:
        """Whether this process publishes the run's effects (rank 0 of a
        mesh; the only process without one)."""
        mesh = self._program_builder.mesh
        return mesh is None or mesh.is_leader

    def _steps_per_client(self) -> np.ndarray:
        """[C] local steps a client trains a round (its plan's real steps)."""
        cache = getattr(self, "_steps_per_client_cache", None)
        if cache is None and self._cohort_active:
            # every valid slot runs the registry-wide step budget
            cache = self._steps_per_client_cache = np.full(
                (self.n_clients,), float(self.registry.train_steps))
        if cache is None:
            plans = engine.multi_client_index_plans(
                [self._client_entropy(1, i) for i in range(self.n_clients)],
                [d.n_train for d in self.datasets], self.batch_size,
                n_steps=self.local_steps, local_epochs=self.local_epochs)
            cache = self._steps_per_client_cache = np.asarray(plans[2]).sum(axis=1)
        return cache

    def _payload_nbytes(self) -> tuple[int, int]:
        """(broadcast, gather) logical payload bytes a participating client:
        the payload's params and what the exchanger pushes, from shapes and
        dtypes; computed once (``fit`` calls it on its own thread)."""
        if self._payload_bytes_cache is not None:
            return self._payload_bytes_cache
        gp = self.global_params
        try:
            down_tree = payload_params(self.strategy.client_payload(self.server_state, 0))
        except Exception:  # an exotic payload counts as the globals
            down_tree = gp
        try:
            up_tree = self.exchanger.push(gp, gp)
        except Exception:
            up_tree = gp
        self._payload_bytes_cache = (ptu.tree_nbytes(down_tree), ptu.tree_nbytes(up_tree))
        return self._payload_bytes_cache

    def _compressed_gather_nbytes(self) -> int | None:
        """The estimated compressed client->server bytes a participating
        client under the active ``CompressionConfig`` (None without)."""
        if self.compression is None or not self.compression.enabled:
            return None
        if self._wire_bytes_cache is None:
            from fl4health_tpu_torch.compression.codecs import estimate_wire_nbytes

            gp = self.global_params
            self._wire_bytes_cache = estimate_wire_nbytes(self.exchanger.push(gp, gp),
                                                          self.compression)
        return self._wire_bytes_cache

    def _fleet_absorb_round(self, rnd: int, mask, host_fit_losses, telemetry, *,
                            registry_ids=None, quarantine_mask=None, failed=(),
                            async_info: dict | None = None,
                            fault_round: int | None = None) -> dict | None:
        """Fold one completed round into the fleet ledger: host arrays this
        epilogue already holds, so a ledger-on run trains bit for bit as a
        ledger-off one. Returns the round's fleet facts, or None without a
        ledger."""
        obs = self.observability
        ledger = obs.fleet_ledger if obs.enabled else None
        if ledger is None:
            return None
        mask_np = np.asarray(mask)
        pos = np.nonzero(mask_np > 0)[0]
        ids_arr = None
        if registry_ids is not None:
            # cohort rounds: slots -> the REGISTRY ids they served
            ids_arr = np.asarray(registry_ids)
            pos = pos[pos < len(ids_arr)]
            part_ids = ids_arr[pos].astype(np.int64)
        else:
            part_ids = pos.astype(np.int64)

        def _sel(row):
            if row is None:
                return None
            arr = np.asarray(row)
            if arr.ndim < 1 or (pos.size and pos.max() >= arr.shape[0]):
                return None
            return arr[pos]

        def _map_ids(idxs):
            if ids_arr is None:
                return [int(c) for c in idxs]
            return [int(ids_arr[int(c)]) for c in idxs if 0 <= int(c) < len(ids_arr)]

        q_in = q_out = None
        if quarantine_mask is not None:
            q = np.asarray(quarantine_mask)
            q_in = _map_ids(np.nonzero(q > 0)[0])
            q_out = _map_ids(np.nonzero(q <= 0)[0])
        fault_ids: list[int] = []
        if self._fault_plan is not None:
            fault = self._fault_plan.summarize_round(
                rnd if fault_round is None else fault_round, self.n_clients)
            if fault:
                fault_ids = _map_ids(sorted(set(fault["dropped"]) | set(fault["corrupted"])))
        down, up = self._payload_nbytes()
        return ledger.absorb_round(
            rnd, part_ids,
            losses=_sel((host_fit_losses or {}).get("backward")),
            update_norms=_sel((telemetry or {}).get("update_norm")),
            nonfinite=_sel((telemetry or {}).get("nonfinite")),
            staleness_pool=(async_info or {}).get("_staleness_values"),
            failed_ids=_map_ids(failed or ()),
            quarantined_ids=q_in,
            unquarantined_ids=q_out,
            fault_ids=fault_ids,
            bytes_down_per_client=down,
            bytes_up_per_client=up,
            registry_size=(self.registry_size if self._cohort_active else self.n_clients))

    def _ship_quarantine_mask(self, results: dict) -> None:
        """Add the strategy's in-graph quarantine mask to a round's results
        (under ``"_quarantine"``, riding the round's one pull) where the
        strategy has one and observability is on; the quarantine itself
        lives in the strategy and needs no observability."""
        q_fn = getattr(self.strategy, "quarantine_mask", None)
        if q_fn is not None and self.observability.enabled:
            b = self._program_builder
            results["_quarantine"] = b.gather(q_fn(self.server_state), b.client_sharding())

    def _emit_quarantine_metrics(self, rnd: int, q_np: np.ndarray,
                                 ids: np.ndarray | None = None) -> None:
        """JAX's ``fl_quarantine_*`` gauges and counters and one
        ``quarantine`` JSONL event from a host copy of the in-graph
        quarantine mask, the same on every route. Entered and released
        clients diff against the previous round's mask; ``ids`` (cohort
        rounds) maps slots to registry ids, so the event names real
        clients. The round's flight-recorder entry gets the mask and the
        active ids."""
        obs = self.observability
        if not obs.enabled:
            return
        reg = obs.registry
        nz = np.nonzero(np.asarray(q_np) > 0)[0]
        if ids is not None:
            # a cohort round sees only the sampled clients' rows: refresh
            # those ids in the registry-wide view, so an unsampled
            # quarantined client does not read as released
            ids = np.asarray(ids)
            cur = self._cohort_quarantine or set()
            for i in ids:
                cur.discard(int(i))
            cur |= {int(i) for i in ids[nz]}
            self._cohort_quarantine = cur
            active = sorted(cur)
        else:
            active = [int(c) for c in nz]
        prev = self._last_quarantine or []
        entered = sorted(set(active) - set(prev))
        released = sorted(set(prev) - set(active))
        self._last_quarantine = active
        reg.gauge("fl_quarantine_active_clients",
                  help="clients currently masked out of aggregation by quarantine",
                  ).set(float(len(active)))
        if entered:
            reg.counter("fl_quarantine_entries_total",
                        help="clients entering quarantine").inc(len(entered))
        if released:
            reg.counter("fl_quarantine_releases_total",
                        help="clients released from quarantine (probation served)",
                        ).inc(len(released))
        if active or entered or released:
            reg.log_event("quarantine", round=rnd, source="strategy", active=active,
                          entered=entered, released=released)
        flight = obs.flight_recorder
        if flight is not None:
            # late-attached to the round's entry (this runs right after
            # _record_round_metrics on every route); registry ids under a
            # cohort
            flight.attach(rnd, quarantine=np.asarray(q_np), quarantine_active=list(active))

    def _fleet_snapshot_doc(self) -> dict | None:
        """The ledger's JSON snapshot for a frame's header: None without a
        ledger, so such frames carry no ``"fleet"`` key."""
        obs = self.observability
        if obs.enabled and obs.fleet_ledger is not None:
            return obs.fleet_ledger.snapshot()
        return None

    def adopt_fleet_snapshot(self, doc: dict | None) -> None:
        """The resume hook (``checkpointing/state.py`` loaders): adopt the
        frame's ledger; a frame without one clears it."""
        ledger = self.observability.fleet_ledger
        if ledger is not None:
            ledger.restore(doc)

    def _record_round_metrics(self, rnd: int, rec: RoundRecord, mask, host_fit_losses,
                              failed, compiles_before: float = 0.0,
                              compile_s_before: float = 0.0, device_wait_s: float = 0.0, *,
                              compiles_after: float | None = None,
                              compile_s_after: float | None = None,
                              telemetry: dict | None = None,
                              async_info: dict | None = None,
                              cohort_info: dict | None = None,
                              fleet_info: dict | None = None,
                              registry_ids: np.ndarray | None = None,
                              fault_round: int | None = None) -> dict | None:
        """A round's records, on the consumer thread (pipelined) or in the
        chunked epilogue, the same on every route.

        ``round_metrics`` gets an entry where a cohort, an async event or a
        fault plan with client faults has something to say: the cohort facts
        (slots, valid, registry size and dirty rows, the staging, gather and
        scatter walls, staged and pulled bytes, the pull's device ms, rounds
        a dispatch, where the draw ran), the event's plan facts
        (``AsyncEventPlan.summarize_event`` and the arrived updates'
        ``_staleness_values``), and under ``"fault"`` the plan's
        ``summarize_round`` at the index the programs drew at
        (``fault_round``: an async event's own index).

        With observability on, JAX's: every ``fl_*`` gauge and counter, one
        ``round`` JSONL event (its summary, which is returned and bridged to
        the reporters), one ``telemetry`` event with the per-client vectors,
        the ``fault`` event, and the flight recorder's entry with the ring's
        bytes and window gauges. The compile counters ``*_after`` are the
        producer's readings right after its dispatches."""
        fault_idx = rnd if fault_round is None else fault_round
        faults = self._fault_plan is not None and self._fault_plan.has_client_faults
        if cohort_info is not None or async_info is not None or faults:
            entry = {"round": rnd, **(cohort_info or {}), **(async_info or {})}
            if faults:
                entry["fault"] = self._fault_plan.summarize_round(fault_idx, self.n_clients)
            self.round_metrics.append(entry)
        obs = self.observability
        if not obs.enabled:
            return None
        reg = obs.registry
        mask_np = np.asarray(mask)
        participants = int((mask_np > 0).sum())
        down, up = self._payload_nbytes()
        bcast, gather = down * participants, up * participants
        reg.counter("fl_rounds_total", help="completed federated rounds").inc()
        reg.counter("fl_client_failures_total",
                    help="clients excluded by the failure policy (non-finite loss)",
                    ).inc(len(failed))
        reg.gauge("fl_participating_clients",
                  help="clients sampled into the current round").set(participants)
        row = np.asarray(host_fit_losses.get("backward", np.zeros_like(mask_np)))
        sel = row[(mask_np > 0) & np.isfinite(row)]
        loss_std = float(sel.std()) if sel.size else 0.0
        loss_spread = float(sel.max() - sel.min()) if sel.size else 0.0
        reg.gauge("fl_fit_loss_std",
                  help="dispersion of participating clients' training loss").set(loss_std)
        reg.gauge("fl_fit_loss_spread",
                  help="straggler proxy: max-min participating client training loss",
                  ).set(loss_spread)
        reg.counter("fl_broadcast_bytes_total",
                    help="logical server->client payload bytes (what a wire "
                         "deployment would serialize per round)").inc(bcast)
        reg.counter("fl_gather_bytes_total",
                    help="logical client->server payload bytes").inc(gather)
        gather_wire = None
        wire_per_client = self._compressed_gather_nbytes()
        if wire_per_client is not None:
            gather_wire = wire_per_client * participants
            _account_wire(gather, gather_wire, "gather")
        if compiles_after is None:
            compiles_after = reg.counter("jax_backend_compiles_total").value
        if compile_s_after is None:
            compile_s_after = reg.counter("jax_backend_compiles_seconds_total").value
        summary = {
            "round": rnd,
            "execution_mode": self._active_execution_mode,
            "compiles": compiles_after - compiles_before,
            "compile_s": compile_s_after - compile_s_before,
            "device_wait_s": device_wait_s,
            "fit_s": rec.fit_elapsed_s,
            "eval_s": rec.eval_elapsed_s,
            "host_s": max(0.0, rec.fit_elapsed_s + rec.eval_elapsed_s - device_wait_s),
            "broadcast_bytes": bcast,
            "gather_bytes": gather,
            "participants": participants,
            "failures": len(failed),
            "fit_loss_std": loss_std,
            "fit_loss_spread": loss_spread,
        }
        if gather_wire is not None:
            summary["gather_bytes_wire"] = gather_wire
            summary["wire_compression_ratio"] = (gather / gather_wire if gather_wire > 0
                                                 else None)
        if async_info is not None:
            info = {k: v for k, v in async_info.items() if k != "_staleness_values"}
            summary.update(info)
            reg.gauge("fl_async_buffer_occupancy",
                      help="updates consumed by the current buffer-fill event",
                      ).set(float(info.get("async_buffer", 0)))
            reg.gauge("fl_async_round_cadence_vs",
                      help="virtual seconds between consecutive aggregation "
                           "events (arrival-driven round cadence)",
                      ).set(float(info.get("async_cadence_vs", 0.0)))
            hist = reg.histogram("fl_async_staleness",
                                 help="staleness (server versions) of consumed updates",
                                 buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0))
            for v in async_info.get("_staleness_values", []):
                hist.observe(float(v))
        if cohort_info is not None:
            # JAX's cohort facts (the pull's bytes and ms and the swap count
            # stay in round_metrics)
            summary.update({k: v for k, v in cohort_info.items()
                            if k not in ("pull_bytes", "pull_ms", "swapped")})
            reg.gauge("fl_registry_clients",
                      help="clients in the host-resident cohort registry",
                      ).set(float(cohort_info["registry_size"]))
            reg.gauge("fl_registry_dirty_rows",
                      help="registry clients with materialized (participated) "
                           "state rows — registry host memory is O(this), not "
                           "O(registry)").set(float(cohort_info["registry_dirty_rows"]))
            reg.gauge("fl_registry_cohort_valid",
                      help="real (non-padded) slots in the current round's "
                           "sampled cohort").set(float(cohort_info["cohort_valid"]))
            reg.counter("fl_registry_staged_bytes_total",
                        help="host bytes staged into slot tensors per round "
                             "(train + val batches)").inc(int(cohort_info["staged_bytes"]))
        if fleet_info is not None:
            summary.update({k: v for k, v in fleet_info.items() if v is not None})
            ledger = obs.fleet_ledger
            reg.gauge("fl_fleet_clients_seen",
                      help="clients with a fleet-ledger lifetime record (ledger "
                           "host memory is O(this), not O(registry))").set(float(len(ledger)))
            reg.counter("fl_fleet_new_clients_total",
                        help="first-ever participations absorbed by the fleet ledger",
                        ).inc(int(fleet_info.get("participants_new") or 0))
            if fleet_info.get("participation_gini") is not None:
                reg.gauge("fl_fleet_participation_gini",
                          help="participation skew over seen clients (0 = even, "
                               "->1 = a few clients do everything)",
                          ).set(float(fleet_info["participation_gini"]))
            if fleet_info.get("straggler_p99") is not None:
                reg.gauge("fl_fleet_straggler_p99",
                          help="p99 of the lifetime participation-gap "
                               "distribution, in rounds (sketched)",
                          ).set(float(fleet_info["straggler_p99"]))
            reg.gauge("fl_fleet_ledger_bytes",
                      help="approximate host bytes held by the fleet ledger + "
                           "its sketches (registry-size-invariant)").set(float(ledger.nbytes()))
        if self._precision_active:
            summary["compute_dtype"] = self.precision.compute_dtype_name
            if self._precision_scaling:
                summary["loss_scale_mode"] = self.precision.resolved_loss_scale
        if telemetry is not None:
            t_summary = telem.summarize_host(telemetry, mask_np)
            summary.update(t_summary)
            reg.gauge("fl_fit_grad_norm_max",
                      help="max per-client gradient norm this round "
                           "(post transform_gradients)").set(t_summary["grad_norm_max"])
            reg.gauge("fl_fit_update_norm_min",
                      help="min participating client update norm (dead-client proxy)",
                      ).set(t_summary["update_norm_min"])
            reg.gauge("fl_fit_divergence_max",
                      help="max client weight divergence from the aggregated global",
                      ).set(t_summary["divergence_max"])
            reg.gauge("fl_dp_clip_fraction",
                      help="mean fraction of examples clipped by the DP path "
                           "(NaN without DP)").set(t_summary["clip_fraction"])
            reg.gauge("fl_nonfinite_values",
                      help="non-finite entries across participating clients' "
                           "params/losses this round").set(t_summary["nonfinite"])
            reg.log_event("telemetry", round=rnd,
                          **{k: np.asarray(v, np.float64).tolist()
                             for k, v in telemetry.items()})
        # the measured rate's denominator: the round's wall less its
        # extension builds. JAX divides by its fence's wait, which is the
        # device's execution time when the host dispatches a compiled round
        # at once; eager rounds are dispatched op by op while the device
        # runs, so the port's fence waits only for the tail (device_wait_s)
        # and a rate over it would overstate the work done a second
        wall = rec.fit_elapsed_s + rec.eval_elapsed_s
        exec_s = wall - summary["compile_s"]
        b = self._program_builder
        if b.mesh is not None:
            # mesh-run extras (absent from single-device records): the mesh
            # facts and the participants' local steps a second a device
            summary["mesh_devices"] = b.n_devices
            summary["mesh_client_axis"] = b.client_axis_size
            steps = float((self._steps_per_client() * (np.asarray(mask) > 0)).sum())
            if steps > 0 and exec_s > 0:
                summary["steps_per_s_per_chip"] = steps / exec_s / b.n_devices
                reg.gauge("fl_round_steps_per_s_per_chip",
                          help="participating clients' local steps per second "
                               "per mesh device").set(summary["steps_per_s_per_chip"])
        if self._round_program_flops and exec_s > 0:
            # counted flops (introspection) over the round's time; mfu_pct
            # only where the device's peak is known, never a made-up share
            achieved = self._round_program_flops / exec_s
            summary["program_flops_round"] = self._round_program_flops
            summary["program_exec_s"] = exec_s
            summary["tflops_measured"] = achieved / 1e12
            reg.gauge("fl_round_tflops_measured",
                      help="measured TFLOP/s this round (counted FLOPs / "
                           "device-execution time)").set(achieved / 1e12)
            if b.mesh is not None:
                # the counted program is this rank's: its rate is a device's
                summary["tflops_per_chip"] = achieved / 1e12
                reg.gauge("fl_round_tflops_per_chip",
                          help="measured TFLOP/s per mesh device this round",
                          ).set(summary["tflops_per_chip"])
            mfu = device_specs.mfu_pct(achieved, self._device_kind)
            if mfu is not None:
                summary["mfu_pct"] = mfu
                reg.gauge("fl_round_mfu_pct",
                          help="measured model FLOPs utilization vs the device's "
                               "bf16 peak").set(mfu)
        fault = None
        if self._fault_plan is not None:
            fault = self._fault_plan.summarize_round(fault_idx, self.n_clients)
            if fault:
                reg.counter("fl_resilience_faults_injected_total",
                            help="client faults injected by the active FaultPlan "
                                 "(dropouts + corruptions)",
                            ).inc(len(fault["dropped"]) + len(fault["corrupted"]))
                reg.log_event("fault", **fault)
                summary["faults_injected"] = len(fault["dropped"]) + len(fault["corrupted"])
        reg.log_event("round", **summary)
        flight = obs.flight_recorder
        if flight is not None:
            # host data this epilogue already holds: no device work, and the
            # ring stays O(window x cohort slots)
            flight.record_round(rnd, summary, fit_loss=rec.fit_losses.get("backward"),
                                eval_loss=rec.eval_losses.get("checkpoint"), mask=mask_np,
                                telemetry=telemetry, registry_ids=registry_ids,
                                fault=fault or None)
            reg.counter("fl_flightrec_rounds_total",
                        help="rounds captured into the flight-recorder ring").inc()
            reg.gauge("fl_flightrec_ring_bytes",
                      help="host bytes of the flight-recorder ring's array payload "
                           "(bounded: O(window x cohort slots))").set(float(flight.nbytes()))
            reg.gauge("fl_flightrec_window",
                      help="flight-recorder ring capacity in rounds").set(float(flight.window))
        obs.tracer.counter("fl_round_time_s", fit=rec.fit_elapsed_s, eval=rec.eval_elapsed_s)
        # the operations plane: the same host floats into the KPI window and
        # the SLO verdict (nothing while unarmed)
        obs.observe_round_kpis(rnd, summary, fit_loss=rec.fit_losses.get("backward"),
                               eval_loss=rec.eval_losses.get("checkpoint"))
        return summary

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
            # the supervisor's keep-mask is a function of (roster, round), so
            # a chunk's masks drawn ahead of its dispatch are the ones the
            # pipelined route would draw
            masks = torch.stack([
                self._apply_recovery_keep(
                    self.client_manager.sample(rng.fold_in(self.rng, 2000 + r), r), r)
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

        return self._program_builder.jit(chunk)

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
        (the fit round, the val eval round and, where every client has one,
        the test split's; their telemetry builds when telemetry is on), and
        its outputs, the ``RoundTelemetry`` among them, stack ``[k]`` on the
        device for the chunk's one pull. ``sample_counts`` replaces the
        simulation's own aggregation weights (a sweep cell's, whose phantom
        clients weigh 0)."""
        fit_round, eval_round, telemetry_on = self._round_fns()
        quarantine_fn = (getattr(self.strategy, "quarantine_mask", None)
                         if self.observability.enabled else None)

        def chunk(server_state, client_states, x_stack, y_stack, idx, em, sm, masks,
                  start_round, val_batches, val_counts, test_batches=None, test_counts=None,
                  sample_counts=None):
            outs = []
            for i in range(idx.shape[0]):
                batches = engine.gather_batches(x_stack, y_stack, idx[i], em[i], sm[i])
                server_state, client_states, fit_losses, fit_metrics, per_fit, *telemetry = (
                    fit_round(server_state, client_states, batches, masks[i],
                              start_round + i, val_batches, sample_counts))
                client_states, eval_losses, eval_metrics, _, _, *ev_nonfinite = eval_round(
                    server_state, client_states, val_batches, val_counts)
                out = {"fit_losses": fit_losses, "fit_metrics": fit_metrics,
                       "per_client_fit_losses": per_fit,
                       "eval_losses": eval_losses, "eval_metrics": eval_metrics}
                if telemetry_on:
                    out["telemetry"] = telemetry[0].replace(nonfinite_eval_loss=ev_nonfinite[0])
                if quarantine_fn is not None:
                    # each round's in-graph quarantine mask stacks with the
                    # outputs: the chunk's one pull, a round at a time
                    out["quarantine"] = client_all(quarantine_fn(server_state))
                if test_batches is not None:
                    client_states, out["test_losses"], out["test_metrics"] = (
                        eval_round(server_state, client_states, test_batches,
                                   test_counts)[:3])
                outs.append(out)
            return server_state, client_states, ptu.stack_clients(outs)

        return self._program_builder.jit(chunk)

    def _rounds_per_dispatch(self, n_rounds: int, start_round: int = 1) -> int:
        """Rounds in the chunked route's next chunk: all that remain up to
        round ``n_rounds``, at most ``checkpoint_every`` when snapshots are
        due at chunk boundaries."""
        remaining = max(n_rounds - start_round + 1, 1)
        every = self._ckpt_every()
        return remaining if every is None else min(every, remaining)

    def _fit_chunked(self, first: int, last: int) -> None:
        """Rounds ``first..last`` through the chunked route: each chunk
        dispatches its rounds back to back, then one ``HostPull`` brings
        every round's results over and ``_chunked_epilogue`` records them.
        Under a snapshot checkpointer a chunk is ``checkpoint_every`` rounds
        and the state trees ride its pull into the boundary's frame (with
        the fleet ledger as of the chunk's last round); the rounds' math
        does not depend on the chunk length, so the trajectory is the
        one-chunk run's bit for bit."""
        sc = self.state_checkpointer
        chunk_ckpt = sc is not None and hasattr(sc, "save_simulation_snapshot")
        with self._ckpt_writer_scope(chunk_ckpt) as writer:
            s = first
            while s <= last:
                k = self._rounds_per_dispatch(last, s)
                trees = self._run_sync_chunk(s, k, snapshot=chunk_ckpt)
                if chunk_ckpt and self._is_leader:
                    sc.save_simulation_snapshot(trees, s + k - 1, self.n_clients,
                                                list(self.history), writer=writer,
                                                fleet=self._fleet_snapshot_doc())
                s += k

    def _run_sync_chunk(self, start_round: int, k: int, snapshot: bool = False):
        """Dispatch rounds ``[start_round, start_round + k)`` as one chunk
        and run their host epilogue; with ``snapshot``, returns the state
        trees that rode the chunk's pull."""
        obs = self.observability
        compiles_before, compile_s_before = self._compile_counts()
        t_start = time.time()
        val_batches, val_counts = self._val_batches()
        test = self._test_batches()
        idx, em, sm, masks = self._chunk_plans(start_round, k)
        with obs.span("fit_chunk", cat="fit", rounds=k, start_round=start_round) as span:
            self.server_state, self.client_states, outs = self._make_chunked_fit_with_eval()(
                self.server_state, self.client_states, self._x_train_stack,
                self._y_train_stack, idx, em, sm, masks, start_round, val_batches,
                val_counts, *(test or ()))
            self.rounds_dispatched += k
            device_wait = obs.fence(outs)[1]
            tree = {**outs, "mask": masks}
            if snapshot:
                tree["_state_trees"] = self._snapshot_trees()
                dtypes = _dtypes(tree["_state_trees"])
            stacked = HostPull(tree).result()  # the chunk's one pull
            span.set(device_wait_s=device_wait)
        compiles_after, compile_s_after = self._compile_counts()
        trees = host_snapshot(stacked.pop("_state_trees"), dtypes) if snapshot else None
        per_round_s = (time.time() - t_start) / max(k, 1)
        self._chunked_epilogue(k, stacked, stacked.pop("mask"), per_round_s,
                               start_round=start_round,
                               compiles=(compiles_before, compile_s_before, compiles_after,
                                         compile_s_after),
                               device_wait_round=device_wait / max(k, 1))
        return trees

    def _chunked_epilogue(self, n_rounds: int, stacked: dict, masks_np: np.ndarray,
                          per_round_s: float, start_round: int = 1,
                          cohort_infos: list[dict] | None = None,
                          async_plan=None, first_event: int = 1,
                          registry_ids: np.ndarray | None = None,
                          compiles: tuple = (0.0, 0.0, None, None),
                          device_wait_round: float = 0.0) -> None:
        """Each round of a chunk on the host, from the stacked pull: the
        failure screen (it logs; ``accept_failures`` is True on this
        route), the ``RoundRecord`` with ``fit_elapsed_s`` the chunk's wall
        amortised a round and ``eval_elapsed_s`` 0 (no separate eval wall),
        the fleet ledger, the round's records with the cohort facts of each
        round (``cohort_infos``; ``registry_ids`` ``[k, K]`` names the
        slots' registry ids) or an async chunk's event facts
        (``async_plan``: the chunk's events from ``first_event``), the
        reports, and last the watchdog: a halt raises naming the first
        offending round. The chunk's compiles (``compiles``: before and
        after) count against its first round; its fenced device wait is
        amortised (``device_wait_round``)."""
        obs = self.observability
        telemetry_stack = stacked.get("telemetry")
        if telemetry_stack is not None:
            telemetry_stack = telem.telemetry_from_dict(telemetry_stack)
        quarantine_stack = stacked.get("quarantine")
        compiles_before, compile_s_before, compiles_after, compile_s_after = compiles
        for i in range(n_rounds):
            rnd = start_round + i
            per_fit_i = {k: v[i] for k, v in stacked["per_client_fit_losses"].items()}
            failed = self.failure_policy.check(per_fit_i, masks_np[i])
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
            event = first_event + i if async_plan is not None else rnd
            async_info = (self._async_event_info(async_plan, event - 1)
                          if async_plan is not None else None)
            telemetry_i = ({k: np.asarray(v[i]) for k, v in telemetry_stack.items()}
                           if telemetry_stack is not None else None)
            ids_i = np.asarray(registry_ids[i]) if registry_ids is not None else None
            # the ledger absorbs before the chunk boundary's frame
            q_i = np.asarray(quarantine_stack[i]) if quarantine_stack is not None else None
            fleet_info = self._fleet_absorb_round(
                rnd, masks_np[i], per_fit_i, telemetry_i, registry_ids=ids_i,
                quarantine_mask=q_i, failed=failed, async_info=async_info,
                fault_round=event)
            summary = self._record_round_metrics(
                rnd, rec, masks_np[i], per_fit_i, failed, compiles_before, compile_s_before,
                device_wait_round,
                compiles_after=compiles_after if i == 0 else compiles_before,
                compile_s_after=compile_s_after if i == 0 else compile_s_before,
                telemetry=telemetry_i, async_info=async_info,
                cohort_info=cohort_infos[i] if cohort_infos is not None else None,
                fleet_info=fleet_info, registry_ids=ids_i, fault_round=event)
            if q_i is not None:
                self._emit_quarantine_metrics(rnd, q_i, ids=ids_i)
            for rep in self.reporters:
                payload = {"fit_losses": rec.fit_losses, "fit_metrics": rec.fit_metrics,
                           "eval_losses": rec.eval_losses, "eval_metrics": rec.eval_metrics,
                           "fit_elapsed_s": rec.fit_elapsed_s,
                           "eval_elapsed_s": rec.eval_elapsed_s,
                           "execution_mode": EXEC_CHUNKED}
                if summary is not None:
                    payload["observability"] = dict(summary)
                rep.report(payload, round=rnd)
            if telemetry_i is not None and obs.watchdog is not None:
                obs.watchdog.observe(rnd, telemetry_i, masks_np[i],
                                     rec.fit_losses.get("backward", float("nan")),
                                     obs=obs, reporters=self.reporters)
            # recovery probation (see _finish_round): healthy rounds only
            self._note_recovery_round(rnd)

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
        lo, hi = self._client_lo, self._client_hi
        for name in ("batches", "val_batches", "mask", "sample_counts", "val_counts"):
            # under a mesh this rank's block of the slots (the mask stays
            # whole: the round program takes its block)
            rows = (staged[name] if name == "mask" or self._n_local == self.n_clients
                    else ptu.tree_map(lambda a: a[lo:hi], staged[name]))
            staged[name] = self._to_device(rows)
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
        idx = np.asarray(idx)[self._client_lo:self._client_hi]  # this rank's slots
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
        obs = self.observability
        self._fit_last_round = last
        self._registry_scatter_event = None
        with self._ckpt_writer_scope(bool(self.model_checkpointers
                                          or self.state_checkpointer is not None),
                                     attach_model_ckpts=True):
            consumer = self._consumer = RoundConsumer(maxsize=self.pipeline_depth)
            prefetcher = self._prefetcher = RoundPrefetcher(self)
            try:
                if first <= last:
                    prefetcher.schedule(first)
                for rnd in range(first, last + 1):
                    consumer.raise_pending()
                    with obs.maybe_profile(rnd):
                        self._run_cohort_round(rnd)
                consumer.flush()
            finally:
                consumer.close()
                prefetcher.close()
                self._last_epilogue_round = consumer.last_completed_round
                self._consumer = self._prefetcher = None
                self._registry_scatter_event = None

    def _count_cohort_roundtrip(self) -> None:
        """One host round-trip against the registry (a draw, a row gather
        and scatter, a dispatch): one a round pipelined, one a chunk
        chunked, one an event over the registry."""
        obs = self.observability
        if obs.enabled:
            obs.registry.counter(
                "fl_cohort_host_roundtrips_total",
                help="host round-trips paid against the client registry "
                     "(one per dispatch: cohort draw + gather/scatter)").inc()

    def _run_cohort_round(self, rnd: int) -> None:
        """The producer's half of a cohort round: the staged slot data, the
        rows gathered after the previous scatter, fit and eval dispatched,
        and the epilogue (its pull carries the updated rows) handed to the
        consumer."""
        obs = self.observability
        consumer, prefetcher = self._consumer, self._prefetcher
        fit_round, eval_round, telemetry_on = self._round_fns()
        compiles_before, compile_s_before = self._compile_counts()
        t0 = time.time()
        # the round boundary: retunes rebind server_state before this
        # round's functions read it
        self._apply_admin_retunes(rnd)
        with obs.span("round", round=rnd, kind="cohort"):
            with obs.span("configure_fit", round=rnd):
                staged = (prefetcher.take(rnd) if prefetcher is not None
                          else self._stage_cohort_round(rnd))
            if prefetcher is not None and rnd < self._fit_last_round:
                # round r+1's data has no state dependency; only the row
                # gather below waits for round r's scatter
                prefetcher.schedule(rnd + 1)
            self._await_registry_scatter()
            idx, valid = staged["idx"], staged["valid"]
            sup = self._recovery_supervisor
            if sup is not None:
                # the supervisor's quarantine by registry id: a sampled slot
                # whose id is on the roster is masked out (its row still
                # gathers and scatters, zero-weight like an unsampled
                # client); nothing while idle
                drop = sup.quarantined_ids(rnd)
                if drop:
                    keep = (~np.isin(np.asarray(idx), np.asarray(drop))).astype(np.float32)
                    staged["mask"] = staged["mask"] * torch.as_tensor(
                        keep, device=staged["mask"].device)
            with obs.span("cohort_gather", round=rnd, valid=valid) as gather_span:
                gather_ms = self._gather_cohort_rows(idx)
                gather_span.set(gather_ms=gather_ms)
            with obs.span("fit_round", round=rnd) as fit_span:
                (self.server_state, self.client_states, fit_losses, fit_metrics,
                 per_client_fit_losses, *telemetry) = fit_round(
                    self.server_state, self.client_states, staged["batches"], staged["mask"],
                    rnd, staged["val_batches"], staged["sample_counts"])
                self.rounds_dispatched += 1
                device_wait_s = obs.fence((fit_losses, fit_metrics, per_client_fit_losses))[1]
                fit_span.set(device_wait_s=device_wait_s)
            post_fit_params = self.client_states.params
            t1 = time.time()
            with obs.span("eval_round", round=rnd) as eval_span:
                self.client_states, eval_losses, eval_metrics, _, _, *ev_nonfinite = (
                    eval_round(self.server_state, self.client_states, staged["val_batches"],
                               staged["val_counts"]))
                eval_wait = obs.fence((eval_losses, eval_metrics))[1]
                device_wait_s += eval_wait
                eval_span.set(device_wait_s=eval_wait)
            results = {"mask": staged["mask"], "fit_losses": fit_losses,
                       "fit_metrics": fit_metrics,
                       "per_client_fit_losses": per_client_fit_losses,
                       "eval_losses": eval_losses, "eval_metrics": eval_metrics,
                       # the updated rows ride the round's one pull (under
                       # a mesh, every rank's slots: each keeps the registry)
                       "_registry_rows": {
                           "client_states": self._program_builder.gather(
                               self.client_states, self._client_placement()),
                           "strategy_rows": self._program_builder.gather(
                               self.strategy.state_rows(self.server_state),
                               self._program_builder.client_sharding())}}
            if telemetry_on:
                results["telemetry"] = telemetry[0].replace(
                    nonfinite_eval_loss=ev_nonfinite[0])
            self._ship_quarantine_mask(results)
            with self._snapshot_span(rnd, "post_agg"):
                snap = self._round_snapshots(results, rnd, post_fit_params)
            compiles_after, compile_s_after = self._compile_counts()
            scatter_event = self._registry_scatter_event = threading.Event()
            work = _RoundWork(
                round=rnd, pull=HostPull(results), fit_elapsed_s=t1 - t0,
                eval_elapsed_s=time.time() - t1, snapshot_dtypes=snap,
                cohort_meta={"idx": idx, "valid": valid, "stage_ms": staged["stage_ms"],
                             "gather_ms": gather_ms, "staged_bytes": staged["staged_bytes"],
                             "scatter_event": scatter_event, "rounds_per_dispatch": 1,
                             "cohort_draw": "host"},
                device_wait_s=device_wait_s, compiles_before=compiles_before,
                compile_s_before=compile_s_before, compiles_after=compiles_after,
                compile_s_after=compile_s_after)
            self._count_cohort_roundtrip()
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
        pull, and their ``RoundTelemetry`` when telemetry is on. JAX's
        ``lax.scan`` body, without the scan."""
        fit_round, eval_round, telemetry_on = self._round_fns()
        quarantine_fn = (getattr(self.strategy, "quarantine_mask", None)
                         if self.observability.enabled else None)
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
                with stage_attr.stage("cohort_exchange"):
                    pos = torch.searchsorted(window_ids, ids.to(window_ids.dtype))
                    client_states = ptu.tree_map(lambda t: t[pos], w_client)
                    if has_srows:
                        server_state = strategy.scatter_state_rows(
                            server_state, ptu.tree_map(lambda t: t[pos], w_srows))
                at = lambda tree: ptu.tree_map(lambda t: t[i], tree)  # noqa: E731
                server_state, client_states, fit_losses, fit_metrics, per_fit, *telemetry = (
                    fit_round(server_state, client_states, at(batches), masks[i], r,
                              at(val_batches), sample_counts[i]))
                client_states, eval_losses, eval_metrics, _, _, *ev_nonfinite = eval_round(
                    server_state, client_states, at(val_batches), val_counts[i])
                out = {"fit_losses": fit_losses, "fit_metrics": fit_metrics,
                       "per_client_fit_losses": per_fit,
                       "eval_losses": eval_losses, "eval_metrics": eval_metrics,
                       "cohort_ids": ids, "cohort_valid": valid}
                if telemetry_on:
                    out["telemetry"] = telemetry[0].replace(nonfinite_eval_loss=ev_nonfinite[0])
                if quarantine_fn is not None:
                    out["quarantine"] = quarantine_fn(server_state)
                outs.append(out)
                with stage_attr.stage("cohort_exchange"):
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
        chunk is every round that remains, or ``checkpoint_every`` rounds
        under a state checkpointer, staged by the prefetcher while the
        previous chunk runs. At a boundary the window's rows go back into
        the registry first, then the cohort frame (slot states and the
        registry's rows and the fleet ledger) is written as the pipelined
        consumer would."""
        obs = self.observability
        sc = self.state_checkpointer
        chunk_ckpt = sc is not None
        if first > last:
            return
        prefetcher = self._prefetcher = RoundPrefetcher(self)
        try:
            with self._ckpt_writer_scope(chunk_ckpt) as writer:
                s = first
                prefetcher.schedule_chunk(s, self._rounds_per_dispatch(last, s))
                while s <= last:
                    k = self._rounds_per_dispatch(last, s)
                    staged = prefetcher.take_chunk(s, k)
                    if s + k <= last:
                        prefetcher.schedule_chunk(s + k,
                                                  self._rounds_per_dispatch(last, s + k))
                    with obs.span("cohort_chunk", start_round=s, rounds=k):
                        trees = self._run_cohort_chunk(s, k, staged, snapshot=chunk_ckpt)
                    if chunk_ckpt:
                        sc.save_cohort_snapshot(trees, s + k - 1, self.n_clients,
                                                self.registry_size, self.registry.export_rows(),
                                                list(self.history), writer=writer,
                                                fleet=self._fleet_snapshot_doc())
                    s += k
        finally:
            prefetcher.close()
            self._prefetcher = None

    def _run_cohort_chunk(self, start_round: int, k: int, staged: dict,
                          snapshot: bool = False):
        """One cohort chunk: the window's rows gathered (after the previous
        chunk's scatter: same thread), its rounds dispatched, one pull of
        the outputs and the window, the device draws checked against the
        host's, the window's rows stored in the registry, and the shared
        chunked epilogue with each round's cohort facts and registry ids."""
        obs = self.observability
        compiles_before, compile_s_before = self._compile_counts()
        t_start = time.time()
        chunk = self._make_cohort_chunk()
        reg = self.registry
        with obs.span("cohort_gather", start_round=start_round,
                      window=int(staged["w_real"])) as gather_span:
            g0 = time.perf_counter()
            w_client_h, w_srows_h = reg.gather_window(staged["window_ids"])
            w_client = rows_to_device(w_client_h, reg.client_dtypes, self.device)
            w_srows = (rows_to_device(w_srows_h, reg.strategy_dtypes, self.device)
                       if w_srows_h is not None else None)
            gather_ms = (time.perf_counter() - g0) * 1e3
            gather_span.set(gather_ms=gather_ms)
        with obs.span("fit_cohort_chunk", cat="fit", rounds=k,
                      start_round=start_round) as chunk_span:
            self.server_state, self.client_states, w_client, w_srows, outs = chunk(
                self.server_state, self.client_states, w_client, w_srows, self.rng,
                staged["window_ids_dev"], staged["batches"], staged["mask"],
                staged["sample_counts"], staged["val_batches"], staged["val_counts"],
                start_round)
            self.rounds_dispatched += k
            device_wait = obs.fence((outs["fit_losses"], outs["eval_losses"]))[1]
            tree = {"outs": outs, "client_rows": w_client, "strategy_rows": w_srows}
            if snapshot:
                tree["_state_trees"] = self._snapshot_trees()
                dtypes = _dtypes(tree["_state_trees"])
            pull = HostPull(tree)
            host = pull.result()  # the chunk's one pull
            chunk_span.set(device_wait_s=device_wait)
        self._count_cohort_roundtrip()
        trees = host_snapshot(host.pop("_state_trees"), dtypes) if snapshot else None
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
        with obs.span("registry_scatter", start_round=start_round,
                      valid=int(staged["w_real"])) as sc_span:
            s0 = time.perf_counter()
            reg.scatter(staged["window_ids"], int(staged["w_real"]), host["client_rows"],
                        host["strategy_rows"] if w_srows_h is not None else None)
            scatter_ms = (time.perf_counter() - s0) * 1e3
            sc_span.set(scatter_ms=scatter_ms)
        compiles_after, compile_s_after = self._compile_counts()
        per_round_s = (time.time() - t_start) / max(k, 1)
        meta = {"stage_ms": staged["stage_ms"], "gather_ms": gather_ms,
                "staged_bytes": staged["staged_bytes"], "rounds_per_dispatch": k,
                "cohort_draw": "in_graph"}
        infos = [self._cohort_info({**meta, "valid": int(valid_host[i])}, scatter_ms, pull)
                 for i in range(k)]
        self._chunked_epilogue(k, stacked, np.asarray(staged["mask_np"]), per_round_s,
                               start_round=start_round, cohort_infos=infos,
                               registry_ids=ids_host,
                               compiles=(compiles_before, compile_s_before, compiles_after,
                                         compile_s_after),
                               device_wait_round=device_wait / max(k, 1))
        return trees

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
        0-d CPU tensor: torch reads it as a scalar on the card, no copy. A
        bound 0-d tensor (a sweep cell's hoisted scalar) is passed as it is,
        never read on the host."""
        value = getattr(self.strategy, "staleness_exponent", 0.0)
        if isinstance(value, torch.Tensor):
            return value.to(torch.float32)
        return torch.tensor(float(value), dtype=torch.float32)

    def _fit_async(self, plan, mode: str, first: int, start_event: int = 1) -> None:
        """``fit``'s buffered-async route over this call's static plan (the
        async config's seed, the fault plan's stragglers, the cohort):
        events ``start_event..`` (from a new prologue at 1, else from the
        restored ``pending``), event ``e`` recorded as number
        ``first + e - 1``."""
        obs = self.observability
        if obs.enabled:
            obs.log_event(
                "async_plan", events=plan.n_events,
                buffer_size=self.async_config.buffer_size,
                staleness_mean=float(plan.staleness[plan.arrivals > 0].mean())
                if plan.n_events else 0.0,
                virtual_wall_s=float(plan.event_times[-1]),
                mean_cadence_vs=float(plan.cadences().mean()))
        self._async_prefix_fps = None
        if start_event > plan.n_events:
            return  # the restored state covers every event asked for
        if self._ckpt_every() is not None:
            self._async_prefix_fps = plan_prefix_fingerprints(plan)
        if self._cohort_active:
            # seat swaps are host work between events: pipelined only
            self._fit_async_registry(plan, first)
        elif mode == EXEC_CHUNKED:
            self._fit_async_chunked(plan, first, start_event)
        else:
            self._fit_async_pipelined(plan, first, start_event)

    def _fit_async_pipelined(self, plan, first: int, start_event: int = 1) -> None:
        """Per-event route: the prologue fills ``pending`` (a resumed run
        has it restored instead), then each event dispatches consume, eval
        and restart while the ``RoundConsumer`` runs the previous event's
        epilogue and the ``RoundPrefetcher`` stages the next event's restart
        batches (data plan ``e+2``)."""
        obs = self.observability
        prologue, _ = self._async_programs()
        with obs.span("setup", cat="fit"):
            val_batches, val_counts = self._val_batches()
        self._fit_last_round = plan.n_events
        with self._ckpt_writer_scope(self._ckpt_every() is not None):
            consumer = self._consumer = RoundConsumer(maxsize=self.pipeline_depth)
            prefetcher = self._prefetcher = RoundPrefetcher(self)
            try:
                if start_event == 1:
                    with obs.span("async_prologue", cat="fit"):
                        self.client_states, self._async_pending = prologue(
                            self.server_state, self.client_states, self._round_batches(1),
                            val_batches)
                prefetcher.schedule(start_event + 1)  # event e restarts on plan e+1
                for e in range(start_event, plan.n_events + 1):
                    consumer.raise_pending()
                    with obs.maybe_profile(e):
                        self._run_async_event(e, plan, first, val_batches, val_counts)
                consumer.flush()
            finally:
                consumer.close()
                prefetcher.close()
                self._last_epilogue_round = consumer.last_completed_round
                self._consumer = self._prefetcher = None
                self._async_pending = None

    def _run_async_event(self, e: int, plan, first: int, val_batches, val_counts) -> None:
        """The producer's half of event ``e``: its plan row and the staged
        restart batches in, one dispatch of consume, eval and restart, the
        pull started and the epilogue handed to the consumer. Nothing here
        waits for the device, unless observability fences it."""
        obs = self.observability
        consumer, prefetcher = self._consumer, self._prefetcher
        _, event = self._async_programs()
        compiles_before, compile_s_before = self._compile_counts()
        t0 = time.time()
        # the event boundary: state-kind retunes rebind server_state; a
        # staleness_exponent setattr reaches this very event's dispatch input
        self._apply_admin_retunes(e)
        with obs.span("round", round=e, kind="async_event"):
            arrivals = engine.host_to_device(plan.arrivals[e - 1], self.device)
            staleness = engine.host_to_device(plan.staleness[e - 1], self.device)
            batches_next = (prefetcher.take(e + 1) if prefetcher is not None
                            else self._round_batches(e + 1))
            if prefetcher is not None and e < self._fit_last_round:
                prefetcher.schedule(e + 2)
            with obs.span("async_event", round=e) as ev_span:
                (self.server_state, self.client_states, self._async_pending, out) = event(
                    self.server_state, self.client_states, self._async_pending,
                    batches_next, arrivals, staleness, e, val_batches, val_counts,
                    self._staleness_exponent_input(), *(self._test_batches() or ()))
                device_wait_s = obs.fence((out["fit_losses"], out["eval_losses"]))[1]
                ev_span.set(device_wait_s=device_wait_s)
            compiles_after, compile_s_after = self._compile_counts()
            results = {"mask": arrivals, **out}
            if "quarantine" in results:  # the consumer's key for the mask
                results["_quarantine"] = results.pop("quarantine")
            with self._snapshot_span(e, "async"):
                snap = self._round_snapshots(results, e, with_pending=True)
            resume_meta = None
            if snap is not None:
                # the frame proves its plan: the consumed prefix's
                # fingerprint and the virtual clock
                resume_meta = {"plan_fingerprint": self._async_prefix_fps[e - 1],
                               "virtual_time_s": float(plan.event_times[e - 1])}
            work = _RoundWork(round=first + e - 1, pull=HostPull(results),
                              fit_elapsed_s=time.time() - t0,
                              eval_elapsed_s=0.0,  # eval is fused into the event
                              async_info=self._async_event_info(plan, e - 1), event=e,
                              snapshot_dtypes=snap, resume_meta=resume_meta,
                              device_wait_s=device_wait_s, compiles_before=compiles_before,
                              compile_s_before=compile_s_before,
                              compiles_after=compiles_after, compile_s_after=compile_s_after)
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

    def _fit_async_chunked(self, plan, first: int, start_event: int = 1) -> None:
        """The chunked route: the prologue (or the restored ``pending``),
        then chunks of events (every event that remains, or
        ``checkpoint_every`` under a state checkpointer, which saves server,
        clients and ``pending`` at each boundary), each one pull and the
        shared epilogue with each event's facts. Event ``e`` restarts on
        data plan ``e+1``."""
        obs = self.observability
        sc = self.state_checkpointer
        chunk_ckpt = self._ckpt_every() is not None
        prologue, _ = self._async_programs()
        val_batches, val_counts = self._val_batches()
        n = plan.n_events
        self._fit_last_round = n
        if start_event == 1:
            with obs.span("async_prologue", cat="fit"):
                self.client_states, pending = prologue(
                    self.server_state, self.client_states, self._round_batches(1),
                    val_batches)
        else:
            pending = self._async_pending  # restored mid-plan
        self._async_pending = None
        with self._ckpt_writer_scope(chunk_ckpt) as writer:
            s = start_event
            while s <= n:
                k = self._rounds_per_dispatch(n, s)
                compiles_before, compile_s_before = self._compile_counts()
                t_start = time.time()
                plans = [self._round_plan(e + 1) for e in range(s, s + k)]
                idx, em, sm = (engine.host_to_device(
                    np.stack([p[j] for p in plans]).astype(dtype), self.device)
                    for j, dtype in enumerate((np.int64, np.float32, np.float32)))
                arrivals = engine.host_to_device(plan.arrivals[s - 1:s - 1 + k], self.device)
                staleness = engine.host_to_device(plan.staleness[s - 1:s - 1 + k],
                                                  self.device)
                with obs.span("fit_async_chunk", cat="fit", rounds=k,
                              start_event=s) as chunk_span:
                    self.server_state, self.client_states, pending, outs = (
                        self._make_async_chunked()(
                            self.server_state, self.client_states, pending,
                            self._x_train_stack, self._y_train_stack, idx, em, sm, arrivals,
                            staleness, s, val_batches, val_counts,
                            self._staleness_exponent_input(), *(self._test_batches() or ())))
                    device_wait = obs.fence(outs)[1]
                    tree = {"outs": outs}
                    if chunk_ckpt:
                        # (under a mesh, every rank's blocks gathered)
                        tree["_state_trees"] = self._snapshot_trees(pending)
                        dtypes = _dtypes(tree["_state_trees"])
                    host = HostPull(tree).result()  # the chunk's one pull
                    chunk_span.set(device_wait_s=device_wait)
                compiles_after, compile_s_after = self._compile_counts()
                self._chunked_epilogue(k, host["outs"], plan.arrivals[s - 1:s - 1 + k],
                                       (time.time() - t_start) / k,
                                       start_round=first + s - 1, async_plan=plan,
                                       first_event=s,
                                       compiles=(compiles_before, compile_s_before,
                                                 compiles_after, compile_s_after),
                                       device_wait_round=device_wait / k)
                if chunk_ckpt and self._is_leader:
                    e_done = s + k - 1
                    sc.save_async_snapshot(
                        host_snapshot(host["_state_trees"], dtypes), e_done, self.n_clients,
                        list(self.history),
                        plan_fingerprint=self._async_prefix_fps[e_done - 1],
                        virtual_time_s=float(plan.event_times[e_done - 1]), writer=writer,
                        fleet=self._fleet_snapshot_doc())
                s += k

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
        obs = self.observability
        prologue, _ = self._async_programs()
        slots, reg = self.n_clients, self.registry
        occ = np.asarray(plan.slot_ids[0])
        with obs.span("cohort_gather", round=0, valid=slots):
            self._gather_cohort_rows(occ)
        consumer = self._consumer = RoundConsumer(maxsize=self.pipeline_depth)
        try:
            with obs.span("async_prologue", cat="fit"):
                staged = reg.stage_round(occ, slots, self._base_entropy, 1)
                self.client_states, self._async_pending = prologue(
                    self.server_state, self.client_states,
                    self._to_device(staged["batches"]),
                    self._to_device(staged["val_batches"]),
                    self._to_device(staged["sample_counts"]))
            self._count_cohort_roundtrip()
            for e in range(1, plan.n_events + 1):
                consumer.raise_pending()
                with obs.maybe_profile(e):
                    occ = self._run_async_registry_event(e, plan, occ, first)
            consumer.flush()
            # the end of the plan: the seats' live rows persist
            host = HostPull({"client_states": self.client_states,
                             "strategy_rows": self.strategy.state_rows(self.server_state)
                             if reg.has_strategy_rows else None}).result()
            reg.scatter(occ, slots, host["client_states"], host["strategy_rows"])
        finally:
            consumer.close()
            self._last_epilogue_round = consumer.last_completed_round
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
        obs = self.observability
        consumer = self._consumer
        _, event = self._async_programs()
        slots, reg = self.n_clients, self.registry
        compiles_before, compile_s_before = self._compile_counts()
        t0 = time.time()
        self._apply_admin_retunes(e)  # the dense async route's boundary
        with obs.span("round", round=e, kind="async_event"):
            occ_next = np.asarray(plan.slot_ids[e])
            changed = np.nonzero(occ_prev != occ_next)[0]
            scatter_ms = gather_ms = 0.0
            if changed.size:
                with obs.span("registry_swap", round=e,
                              swapped=int(changed.size)) as swap_span:
                    scatter_ms, gather_ms = self._swap_seats(changed, occ_prev[changed],
                                                             occ_next[changed])
                    swap_span.set(scatter_ms=scatter_ms, gather_ms=gather_ms)
            st0 = time.perf_counter()
            staged = reg.stage_round(occ_next, slots, self._base_entropy, e + 1)
            batches_next, val_batches, val_counts, wave_counts = (
                self._to_device(staged[k]) for k in ("batches", "val_batches", "val_counts",
                                                     "sample_counts"))
            stage_ms = (time.perf_counter() - st0) * 1e3
            arrivals = engine.host_to_device(plan.arrivals[e - 1], self.device)
            with obs.span("async_event", round=e) as ev_span:
                (self.server_state, self.client_states, self._async_pending, out) = event(
                    self.server_state, self.client_states, self._async_pending, batches_next,
                    arrivals, engine.host_to_device(plan.staleness[e - 1], self.device), e,
                    val_batches, val_counts, self._staleness_exponent_input(),
                    None, None, wave_counts)  # no test split under a cohort
                device_wait_s = obs.fence((out["fit_losses"], out["eval_losses"]))[1]
                ev_span.set(device_wait_s=device_wait_s)
            self._count_cohort_roundtrip()
            compiles_after, compile_s_after = self._compile_counts()
        results = {"mask": arrivals, **out}
        if "quarantine" in results:  # the consumer's key for the mask
            results["_quarantine"] = results.pop("quarantine")
        work = _RoundWork(
            round=first + e - 1, pull=HostPull(results),
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
            async_info=self._async_event_info(plan, e - 1), event=e,
            device_wait_s=device_wait_s, compiles_before=compiles_before,
            compile_s_before=compile_s_before, compiles_after=compiles_after,
            compile_s_after=compile_s_after)
        consumer.submit_round(work.round, functools.partial(self._finish_round, work))
        if not self.failure_policy.accept_failures:
            consumer.flush()
        return occ_next
