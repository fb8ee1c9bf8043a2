"""Run manifest (counterpart of ``fl4health_tpu/observability/manifest.py``):
the provenance record served next to the metrics, and ``config_hash``, the
experiment identity a state checkpoint's frame binds to.

A scraped ``/metrics`` page is interpretable only with its context: which
torch and CUDA, which device and how many, which execution mode ``fit()``
chose (and why), and a stable hash of the run configuration. Where JAX's
manifest names jax/jaxlib and the XLA backend, this one names torch, its
CUDA and the card. Everything is a plain-JSON dict of host facts.
"""

from __future__ import annotations

import hashlib
import json
import platform
from typing import Any, Mapping


def config_hash(config: Mapping[str, Any]) -> str:
    """Short stable digest of a JSON-able config mapping (sorted keys,
    non-JSON leaves stringified): equal configs hash equal in either
    package and across processes."""
    canonical = json.dumps(config, sort_keys=True, default=str,
                           separators=(",", ":"))
    return hashlib.sha256(canonical.encode("utf-8")).hexdigest()[:16]


def device_facts(device: Any = None) -> dict[str, Any]:
    """The device a run computes on: its backend (``cuda`` or ``cpu``), and
    on a card its name, count and memory. Reads no tensor."""
    import torch

    backend = getattr(device, "type", None) or (str(device) if device else None)
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    facts: dict[str, Any] = {"backend": backend}
    if backend == "cuda" and torch.cuda.is_available():
        index = getattr(device, "index", None) or 0
        facts.update(device_kind=torch.cuda.get_device_name(index),
                     device_count=torch.cuda.device_count(),
                     device_memory_bytes=int(torch.cuda.get_device_properties(index)
                                             .total_memory))
    else:
        facts.update(device_kind="cpu", device_count=1)
    return facts


def run_manifest(
    *,
    execution_mode: str | None = None,
    execution_mode_reason: str | None = None,
    device: Any = None,
    mesh: Mapping[str, Any] | None = None,
    config: Mapping[str, Any] | None = None,
    extra: Mapping[str, Any] | None = None,
) -> dict[str, Any]:
    """Assemble the run manifest dict. ``config``: the JSON-able run config,
    stored inline and hashed (``config_hash``). ``mesh``: the round
    programs' mesh descriptor (``RoundProgramBuilder.descriptor()``)."""
    import torch

    mani: dict[str, Any] = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python_version": platform.python_version(),
        **device_facts(device),
    }
    if execution_mode is not None:
        mani["execution_mode"] = execution_mode
    if execution_mode_reason is not None:
        mani["execution_mode_reason"] = execution_mode_reason
    if mesh is not None:
        mani["mesh"] = dict(mesh)
    if config is not None:
        mani["config"] = dict(config)
        mani["config_hash"] = config_hash(config)
    if extra:
        mani.update(extra)
    return mani
