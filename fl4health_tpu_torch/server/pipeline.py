"""The round pipeline's host half (counterpart of
``fl4health_tpu/server/pipeline.py``, its dense per-round path): the host
work of round r overlaps the device's work on round r+1.

- ``RoundConsumer``: a bounded single-worker queue that runs each round's
  host epilogue (the result pull, the failure screen, the ``RoundRecord``,
  the reporters) on a background thread, in round order, while the
  producer (the caller of ``fit``) already dispatches the next round.
  ``flush()`` is a barrier; the first exception an epilogue raises (a
  ``ClientFailuresError``) is re-raised in the producer at its next
  ``submit``/``flush``.
- ``RoundPrefetcher``: builds round r+1's index plan (numpy) and enqueues
  its batch gather on a worker thread while round r runs. If
  ``set_train_data`` swapped the train stacks after staging (a
  ``train_data_provider`` refresh), the plan is reused and the gather
  issued again against the new stacks (compared by identity).
- ``HostPull``: the one device->host transfer of a round's results.

Under a cohort (``CohortConfig``) the prefetcher stages the next round's
slot tensors instead (``sim._stage_cohort_round``: the host draw, the
registry's numpy staging, the copies to the device), and on the chunked
cohort route the next chunk's (``schedule_chunk``/``take_chunk``). The
clients' state rows are never staged here: they depend on the previous
round's registry scatter, so the producer gathers them.

Streams and syncs: every thread enqueues on the device's legacy default
stream, so the prefetcher's gather is ordered behind the kernels enqueued
before it, and the producer consumes its batches on that same stream: no
event, ``wait_stream`` or ``record_stream`` is needed. The gather's index
and mask copies go host-to-device from pinned memory without blocking, and
``HostPull`` copies device-to-host into pinned memory without blocking and
records an event that only the consumer waits on: the producer never waits
for the device. Neither worker runs a ``torch.func`` transform; only the
producer does.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch
import torch.utils._pytree as torch_pytree

from fl4health_tpu_torch.clients import engine
from fl4health_tpu_torch.core.workqueue import SingleWorkerQueue


class RoundConsumer(SingleWorkerQueue):
    """Single-worker FIFO executor for per-round host epilogues.

    ``maxsize`` bounds how many rounds of host work may be pending: the
    producer blocks on ``submit`` once the device is that far ahead. Queue,
    ordering, barrier and exception contracts come from
    ``core.workqueue.SingleWorkerQueue``."""

    def __init__(self, maxsize: int = 2, name: str = "fl-round-consumer"):
        super().__init__(maxsize=maxsize, name=name)
        # newest round whose epilogue FINISHED (not merely was submitted)
        self.last_completed_round: int | None = None

    def submit_round(self, round_idx: int, job) -> None:
        """Submit one round's host epilogue; ``last_completed_round`` moves
        once the job ran (worker thread, FIFO: the value is monotone)."""

        def _job():
            job()
            self.last_completed_round = int(round_idx)

        self.submit(_job)


class RoundPrefetcher:
    """Stage round r+1's batches while round r executes.

    ``schedule(r)`` computes the host index plan and enqueues the device
    gather on a worker thread; ``take(r)`` returns the staged batches, or
    builds them on the caller's thread on a miss (nothing staged for ``r``).
    Staleness rule: if the simulation's train stacks were swapped between
    staging and ``take``, the plan is gathered again from the new stacks."""

    def __init__(self, sim: Any):
        self._sim = sim
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="fl-round-prefetch")
        self._pending = None

    def schedule(self, round_idx: int) -> None:
        sim = self._sim
        if getattr(sim, "_cohort_active", False):
            # a cohort round's slot data: its draw, staging and copies are
            # a function of (key, round, registry data) alone
            self._pending = (round_idx, self._pool.submit(sim._stage_cohort_round, round_idx))
            return
        # the stacks as of NOW: take() compares them by identity
        x_stack, y_stack = sim._x_train_stack, sim._y_train_stack

        def build():
            plan = sim._round_plan(round_idx)
            return (x_stack, y_stack), plan, engine.gather_batches(x_stack, y_stack,
                                                                   *plan)

        self._pending = (round_idx, self._pool.submit(build))

    def schedule_chunk(self, start_round: int, k: int) -> None:
        """The chunked cohort route: stage chunk ``[start_round, start_round
        + k)``'s draws, stacked slot tensors and window ids on the worker
        while the previous chunk runs. The window's state rows are left to
        ``_run_cohort_chunk``: they depend on the previous chunk's scatter."""
        self._pending = (("chunk", start_round),
                         self._pool.submit(self._sim._stage_cohort_chunk, start_round, k))

    def take_chunk(self, start_round: int, k: int):
        """The staged chunk, or the chunk staged on this thread on a miss."""
        pending, self._pending = self._pending, None
        if pending is not None and pending[0] == ("chunk", start_round):
            return pending[1].result()
        return self._sim._stage_cohort_chunk(start_round, k)

    def take(self, round_idx: int):
        sim = self._sim
        pending, self._pending = self._pending, None
        if getattr(sim, "_cohort_active", False):
            if pending is not None and pending[0] == round_idx:
                return pending[1].result()
            return sim._stage_cohort_round(round_idx)
        if pending is None or pending[0] != round_idx:
            return sim._round_batches(round_idx)
        (x_stack, y_stack), plan, batches = pending[1].result()
        if x_stack is sim._x_train_stack and y_stack is sim._y_train_stack:
            return batches
        # data refreshed after staging: same plan, fresh gather
        return engine.gather_batches(sim._x_train_stack, sim._y_train_stack, *plan)

    def close(self) -> None:
        """Drop what is staged and join the worker."""
        self._pending = None
        self._pool.shutdown(wait=True, cancel_futures=True)


class HostPull:
    """One device->host transfer of a tree of tensors (dicts of scalars and
    per-client rows).

    Built on the producer's thread: the leaves are flattened into one buffer
    a dtype on their device (bf16 widened to f32, exactly) and, on a card,
    copied into pinned host memory without a host sync, behind one event.
    ``result()``, on any thread, waits for that event alone and returns the
    tree with numpy leaves of the same shapes, each in its own dtype, so
    state rows go back into a registry as they are. On a card,
    ``device_ms`` is the device time of the flatten and the copies (CUDA
    events around them), once ``result()`` has returned; None on the CPU."""

    def __init__(self, tree: Any):
        leaves, self._spec = torch_pytree.tree_flatten(tree)
        # None is a leaf to torch's pytree (an empty field of a state): it
        # comes back as None
        self._none = [x is None for x in leaves]
        leaves = [x.detach() for x in leaves if x is not None]
        on_card = bool(leaves) and leaves[0].device.type == "cuda"
        self._start = self._done = self.device_ms = None
        if on_card:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        leaves = [x.float() if x.dtype == torch.bfloat16 else x for x in leaves]
        self._shapes = [tuple(x.shape) for x in leaves]
        self._dtypes = [x.dtype for x in leaves]
        self._buffers: dict[torch.dtype, torch.Tensor] = {}
        for dtype in dict.fromkeys(self._dtypes):
            flat = torch.cat([x.reshape(-1) for x in leaves if x.dtype == dtype])
            if flat.device.type == "cuda":
                host = torch.empty(flat.shape, dtype=dtype, pin_memory=True)
                host.copy_(flat, non_blocking=True)
                flat = host
            self._buffers[dtype] = flat
        self.nbytes = sum(b.numel() * b.element_size() for b in self._buffers.values())
        if on_card:
            self._done = torch.cuda.Event(enable_timing=True)
            self._done.record()

    def result(self) -> Any:
        if self._done is not None:
            self._done.synchronize()
            self.device_ms = self._start.elapsed_time(self._done)
        flats = {d: b.numpy() for d, b in self._buffers.items()}
        starts = dict.fromkeys(flats, 0)
        out = []
        for shape, dtype in zip(self._shapes, self._dtypes):
            n, start = math.prod(shape), starts[dtype]
            out.append(flats[dtype][start:start + n].reshape(shape))
            starts[dtype] = start + n
        it = iter(out)
        out = [None if none else next(it) for none in self._none]
        return torch_pytree.tree_unflatten(out, self._spec)
