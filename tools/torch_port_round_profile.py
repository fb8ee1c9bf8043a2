#!/usr/bin/env python3
"""Where one round of the port's main path spends its device time.

Builds the full-width transformer_long federated run of ``chip_smoke.py``
on the card, runs one warm-up round, then profiles the next round with
``torch.profiler`` (CPU + CUDA activities) and prints one JSON line: the
round's host wall time, the summed device time by kernel group (the three
flash kernels, GEMMs, everything else), the top kernels by device time and
the device busy share (summed kernel time over the profiled wall; a single
stream, so kernels do not overlap).

Run on the card from the repository root:
    python3 tools/torch_port_round_profile.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "flash_bwd_dq_kernel" in name:
        return "flash_bwd_dq"
    if "flash_bwd_dkv_kernel" in name:
        return "flash_bwd_dkv"
    if any(s in low for s in ("gemm", "sm90_xmma", "cutlass", "cublas", "nvjet")):
        return "gemm"
    return "other"


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    cfg = dict(vocab_size=8192, n_classes=4, d_model=512, n_heads=8, n_layers=4,
               d_ff=2048, max_len=cs.T)
    data = cs.text_datasets(8192, cs.T, cs.BATCH * cs.LOCAL_STEPS + 16,
                            cs.BATCH * cs.LOCAL_STEPS)
    sim = cs.build_sim(cfg, data, torch.bfloat16, "cuda", seed=0)
    sim.fit(1)  # warm-up: kernel build, cuBLAS handles, allocator
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        sim.fit(1)
        torch.cuda.synchronize()
        wall = time.time() - t0
    groups: dict[str, float] = {}
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        g = kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + dev_us / 1e6
        kernels.append((dev_us / 1e6, evt.count, evt.key[:90]))
    busy = sum(groups.values())
    kernels.sort(reverse=True)
    rec = sim.history[-1]
    print(json.dumps({
        "profiled_round": rec.round, "round_wall_s": wall,
        "fit_s": rec.fit_elapsed_s, "eval_s": rec.eval_elapsed_s,
        "device_s_by_group": groups, "device_busy_s": busy,
        "device_busy_share": busy / wall,
        "top_kernels": [{"s": s, "count": c, "name": n} for s, c, n in kernels[:12]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
