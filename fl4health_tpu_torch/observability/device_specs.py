"""Published per-device peaks (counterpart of
``fl4health_tpu/observability/device_specs.py``): the denominators for MFU
and roofline positions.

The table is keyed by the device name ``torch.cuda.get_device_name()``
reports. Its one entry is NVIDIA's data sheet for the H100 SXM part (dense
rates, the full 700 W power limit): 989 TFLOP/s in bf16, 80 GB of HBM3 at
3.35 TB/s. A card set below 700 W (``nvidia-smi``'s ``power.limit``) runs
slower under load, so a share of these peaks is stated beside the card's
limit. An unknown name has no peaks: callers treat them as unavailable
rather than guessing.

Capacity prefers the live number, ``torch.cuda.mem_get_info``'s total; the
table is the fallback. Nothing here touches the device at import.
"""

from __future__ import annotations

import dataclasses

GB = 1000**3


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Published per-device peaks (dense)."""

    peak_bf16_flops: float  # tensor-core bf16 peak, FLOP/s
    hbm_bytes: int          # device memory capacity
    hbm_bw_bytes_per_s: float  # memory bandwidth (roofline ridge denominator)


DEVICE_SPECS: dict[str, DeviceSpec] = {
    "NVIDIA H100 80GB HBM3": DeviceSpec(989e12, 80 * GB, 3.35e12),
}


def lookup(device_kind: str | None) -> DeviceSpec | None:
    """Spec for a device name, or None when unknown (the CPU, a card the
    table has not learned)."""
    return DEVICE_SPECS.get(device_kind.strip()) if device_kind else None


def peak_bf16_flops(device_kind: str | None) -> float | None:
    spec = lookup(device_kind)
    return spec.peak_bf16_flops if spec else None


def device_memory_bytes(device: int = 0) -> int | None:
    """Device memory in bytes: the live total on a card, else None (the
    CPU)."""
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        return int(torch.cuda.mem_get_info(device)[1])
    except RuntimeError:
        spec = lookup(torch.cuda.get_device_name(device))
        return spec.hbm_bytes if spec else None


def mfu_pct(achieved_flops_per_s: float, device_kind: str | None) -> float | None:
    """Achieved FLOP/s as a percent of the device's bf16 peak; None when the
    peak is unknown (never a made-up MFU)."""
    peak = peak_bf16_flops(device_kind)
    if not peak or achieved_flops_per_s is None:
        return None
    return 100.0 * achieved_flops_per_s / peak


def roofline(flops: float | None, bytes_accessed: float | None,
             device_kind: str | None) -> dict | None:
    """Roofline position of one program: arithmetic intensity (FLOPs per
    memory byte) against the device's ridge point (peak FLOP/s over memory
    bandwidth). None without both numerators."""
    if not flops or not bytes_accessed:
        return None
    intensity = flops / bytes_accessed
    spec = lookup(device_kind)
    out = {"intensity_flops_per_byte": intensity}
    if spec:
        ridge = spec.peak_bf16_flops / spec.hbm_bw_bytes_per_s
        out["ridge_flops_per_byte"] = ridge
        out["compute_bound"] = intensity >= ridge
    return out
