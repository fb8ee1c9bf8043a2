"""CUDA hooks of the observability layer (counterpart of
``fl4health_tpu/observability/jaxmon.py``).

1. **Compile accounting.** The port compiles nothing at run time but its
   kernel extensions (``kernels/build.py``: one ``nvcc`` build of a
   ``kernels/csrc`` extension at first use). ``CompileMonitor`` counts those
   builds under JAX's names, ``jax_backend_compiles_total`` and
   ``jax_backend_compiles_seconds_total``, so the ``round`` event's
   ``compiles``/``compile_s`` and the tools that read them work unchanged
   (a departure: JAX counts XLA backend compiles; ``ROADMAP.md`` §C).
   ``kernels/build.py`` reports each build through ``note_build``, which
   fans out to every installed monitor; ``uninstall()`` detaches one.

2. **Honest device time.** A CUDA launch returns before the device
   finishes, so a host clock around a dispatch measures the enqueue.
   ``synced()`` waits for the device (``torch.cuda.synchronize()``) and
   returns the wall it waited, only when enabled and only for a tree that
   holds a CUDA tensor: a disabled handle adds no sync, and a CPU run has
   nothing to wait for.

3. **Round profiling.** ``profile_round(dir)`` wraps one chosen round in
   ``torch.profiler`` (CPU and CUDA activities) and writes its Chrome trace
   under ``dir`` (JAX writes an XProf trace there).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any

import torch
import torch.utils._pytree as torch_pytree

from fl4health_tpu_torch.observability.registry import MetricsRegistry

_monitors_lock = threading.Lock()
_monitors: list["CompileMonitor"] = []


def note_build(name: str, seconds: float) -> None:
    """One kernel-extension build of ``seconds`` (``kernels/build.py``),
    fanned out to every installed monitor."""
    with _monitors_lock:
        targets = list(_monitors)
    for mon in targets:
        mon._on_build(name, seconds)


class CompileMonitor:
    """Counts kernel-extension builds into a registry, as JAX's monitor
    counts backend compiles: ``jax_backend_compiles_total`` and
    ``jax_backend_compiles_seconds_total``."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._installed = False

    def install(self) -> "CompileMonitor":
        with _monitors_lock:
            if not self._installed:
                _monitors.append(self)
                self._installed = True
        return self

    def uninstall(self) -> None:
        with _monitors_lock:
            if self._installed:
                _monitors.remove(self)
                self._installed = False

    @property
    def installed(self) -> bool:
        return self._installed

    def _on_build(self, name: str, seconds: float) -> None:
        self.registry.counter(
            "jax_backend_compiles_total",
            help="kernel-extension builds (kernels/build.py)").inc()
        self.registry.counter(
            "jax_backend_compiles_seconds_total",
            help="seconds in kernel-extension builds (kernels/build.py)",
        ).inc(max(0.0, float(seconds)))

    def compile_count(self) -> float:
        return self.registry.counter("jax_backend_compiles_total").value

    def __enter__(self) -> "CompileMonitor":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False


def _on_card(tree: Any) -> bool:
    return any(isinstance(x, torch.Tensor) and x.device.type == "cuda"
               for x in torch_pytree.tree_leaves(tree))


def synced(tree: Any, enabled: bool = True) -> tuple[Any, float]:
    """Wait for the device and return ``(tree, wait_seconds)``. Disabled, or
    for a tree with no CUDA tensor, a pure pass-through (``(tree, 0.0)``):
    no sync, no clock read."""
    if not enabled or not _on_card(tree):
        return tree, 0.0
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    return tree, time.perf_counter() - t0


@contextlib.contextmanager
def profile_round(profile_dir: str | None):
    """``torch.profiler`` capture of one block (one round), its Chrome trace
    written under ``profile_dir``; None is a no-op, so the call site stays
    unconditional."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"round_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json"))
