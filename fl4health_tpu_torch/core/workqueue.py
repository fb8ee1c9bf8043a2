"""Single-worker FIFO job queue with cross-thread exception propagation
(counterpart of ``fl4health_tpu/core/workqueue.py``).

The round pipeline's background consumer (``server.pipeline.RoundConsumer``)
is one of these: a bounded FIFO run by ONE daemon thread, so jobs run
strictly in submission order, with these contracts:

- ``submit`` blocks once ``maxsize`` jobs are pending (backpressure instead
  of unbounded host memory);
- the FIRST exception a job raises is stored, later jobs are skipped
  (drained, not run), and ``submit``/``flush``/``raise_pending`` re-raise it
  exactly once in the caller's thread;
- ``flush()`` is a completion barrier;
- ``close()`` drains, stops, joins, never raises: safe in ``finally``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable


class SingleWorkerQueue:
    _STOP = object()

    def __init__(self, maxsize: int = 2, name: str = "fl-worker"):
        # maxsize <= 0 would make the queue unbounded; the pipeline is
        # bounded, so clamp to at least one job in flight
        self._queue: queue.Queue = queue.Queue(max(1, int(maxsize)))
        self._exc: BaseException | None = None
        self._raised = False
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    @property
    def maxsize(self) -> int:
        return self._queue.maxsize

    def _loop(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is self._STOP:
                    return
                if self._exc is None:  # after a failure, drain without running
                    try:
                        job()
                    except BaseException as e:  # noqa: BLE001 (crosses threads)
                        self._exc = e
            finally:
                self._queue.task_done()

    def submit(self, job: Callable[[], None]) -> None:
        """Enqueue one job; blocks while ``maxsize`` jobs are pending.
        Re-raises a prior job's stored exception first, so the producer
        stops promptly after a failure."""
        if self._closed:
            raise RuntimeError(f"{type(self).__name__} is closed")
        self.raise_pending()
        self._queue.put(job)

    def flush(self) -> None:
        """Barrier: returns once every submitted job has finished (or been
        skipped after a failure); re-raises the stored exception."""
        self._queue.join()
        self.raise_pending()

    def raise_pending(self) -> None:
        """Re-raise the first worker exception (once)."""
        if self._exc is not None and not self._raised:
            self._raised = True
            raise self._exc

    def close(self) -> None:
        """Stop the worker and join it. Idempotent; never raises: callers
        check ``raise_pending``/``flush`` for errors before or instead."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(self._STOP)
        self._thread.join()
