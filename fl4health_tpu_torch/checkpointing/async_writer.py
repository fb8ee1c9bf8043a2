"""Async checkpoint writer (counterpart of
``fl4health_tpu/checkpointing/async_writer.py``): the serialize and write
of a checkpoint run off the round loop, on one worker thread.

The decision (best-loss, best-metric, the state checkpointer's cadence)
stays in round order where the round's epilogue runs; only the persist
lands here. A job gets host data (the round's pull), never live state.
The single worker keeps writes ordered, so a "latest" policy ends with the
last round's artifact on disk. Queue, flush-barrier and first-exception
contracts come from ``core.workqueue.SingleWorkerQueue``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

from fl4health_tpu_torch.checkpointing.checkpointer import save_params
from fl4health_tpu_torch.core.workqueue import SingleWorkerQueue


class AsyncCheckpointWriter(SingleWorkerQueue):
    """Bounded single-worker queue for checkpoint persists."""

    def __init__(self, maxsize: int = 4, name: str = "fl-ckpt-writer"):
        super().__init__(maxsize=maxsize, name=name)

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> None:
        """Enqueue a persist; blocks while ``maxsize`` writes are pending (a
        disk slower than the rounds throttles the run instead of piling up
        host copies). Re-raises a stored failure first."""
        super().submit(functools.partial(fn, *args, **kwargs) if (args or kwargs) else fn)

    def submit_save(self, path: str, params: Any) -> None:
        """Persist a params tree (flax's msgpack bytes) off-thread; ``params``
        must already be host data."""
        self.submit(save_params, path, params)
