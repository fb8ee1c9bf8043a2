#!/usr/bin/env python3
"""Where one round of a port path spends its device time.

Builds one of ``chip_smoke.py``'s full-width federated runs on the card, runs
one warm-up round, then profiles the next round with ``torch.profiler`` (CPU
+ CUDA activities) and prints one JSON line: the round's host wall time, the
summed device time by kernel group, the top kernels by device time and the
device busy share (summed kernel time over the profiled wall; a single
stream, so kernels do not overlap).

  --config transformer_long  (default) the flash-attention path; groups: the
      three flash kernels (by name, so each group holds both routes: the
      tensor-core ``wgmma_flash_*_kernel`` and the CUDA-core kernels), GEMMs,
      everything else.
  --config dp_cifar_cnn  the DP-FedAvg CifarNet path; the round is split by
      ``record_function`` ranges the tool wraps around the client's
      ``value_and_grads``, the DP clip-and-noise call inside it and the
      evaluation phase: per-example grads (value_and_grads less the DP call),
      the K1/K2 kernels, the rest of the DP call (norms, clip factor, noise),
      the SGD update and engine glue (the rest of fit), evaluation, and host
      idle (wall less busy). A device op belongs to the range in which the
      host launched it (the trace links each kernel, copy or fill to its
      launch call); the host time spent in each range is given beside it.

Run on the card from the repository root:
    python3 tools/torch_port_round_profile.py [--config dp_cifar_cnn]
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

RANGES = ("profile::value_and_grads", "profile::dp_clip_noise", "profile::eval")


def kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "flash_bwd_dq_kernel" in name:
        return "flash_bwd_dq"
    if "flash_bwd_dkv_kernel" in name:
        return "flash_bwd_dkv"
    if "sq_norm_partial_kernel" in name or "sq_norm_finish_kernel" in name:
        return "dp_sq_norms"
    if "scaled_sum_kernel" in name:
        return "dp_scaled_sum"
    if any(s in low for s in ("gemm", "sm90_xmma", "cutlass", "cublas", "nvjet")):
        return "gemm"
    if any(s in low for s in ("conv", "cudnn", "wgrad", "dgrad")):
        return "conv"
    return "other"


def transformer_sim():
    import chip_smoke as cs

    cfg = dict(vocab_size=8192, n_classes=4, d_model=512, n_heads=8, n_layers=4,
               d_ff=2048, max_len=cs.T)
    data = cs.text_datasets(8192, cs.T, cs.BATCH * cs.LOCAL_STEPS + 16,
                            cs.BATCH * cs.LOCAL_STEPS)
    return cs.build_sim(cfg, data, torch.bfloat16, "cuda", seed=0)


def dp_sim():
    """chip_smoke's DP path, with profiler ranges around the client's
    gradient computation, its DP call and the evaluation phase."""
    import chip_smoke as cs
    from fl4health_tpu_torch.clients import instance_level_dp
    from fl4health_tpu_torch.privacy import dpsgd

    data = cs.image_datasets(cs.DP_CLIENTS, cs.DP_TRAIN, cs.DP_VAL, (32, 32, 3))
    sim = cs.build_dp_sim(data, torch.bfloat16, "cuda", cs.DP_SIGMA, seed=0)

    def ranged(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call

    logic = sim.logic
    logic.value_and_grads = ranged(RANGES[0], logic.value_and_grads)
    dpsgd_call = dpsgd.noisy_clipped_mean_grads
    instance_level_dp.dpsgd.noisy_clipped_mean_grads = ranged(RANGES[1], dpsgd_call)
    sim._eval_round = ranged(RANGES[2], sim._eval_round)
    return sim


def device_time_by_range(prof, names) -> tuple[dict, dict, dict]:
    """(device s, host s, calls) per range name, from the profiler's trace:
    a device op (kernel, copy, fill) counts for the range whose host
    interval holds the op's launch call."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    launched_at = {e["args"]["correlation"]: e["ts"] for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {})}
    spans = {n: sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") == "user_annotation" and e.get("name") == n)
             for n in names}
    starts = {n: [a for a, _ in iv] for n, iv in spans.items()}
    device = {n: 0.0 for n in names}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t = launched_at.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        for n in names:
            i = bisect.bisect_right(starts[n], t) - 1
            if i >= 0 and t <= spans[n][i][1]:
                device[n] += e["dur"] / 1e6
    host = {n: sum(b - a for a, b in iv) / 1e6 for n, iv in spans.items()}
    return device, host, {n: len(iv) for n, iv in spans.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", choices=("transformer_long", "dp_cifar_cnn"),
                        default="transformer_long")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    sim = dp_sim() if args.config == "dp_cifar_cnn" else transformer_sim()
    sim.fit(1)  # warm-up: kernel build, cuBLAS/cuDNN handles, allocator
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
        if evt.key in RANGES:  # a range's span on the device timeline, not a kernel
            continue
        g = kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + dev_us / 1e6
        kernels.append((dev_us / 1e6, evt.count, evt.key[:90]))
    busy = sum(groups.values())
    kernels.sort(reverse=True)
    rec = sim.history[-1]
    out = {
        "config": args.config, "profiled_round": rec.round, "round_wall_s": wall,
        "fit_s": rec.fit_elapsed_s, "eval_s": rec.eval_elapsed_s,
        "device_s_by_group": groups, "device_busy_s": busy,
        "device_busy_share": busy / wall,
        "top_kernels": [{"s": s, "count": c, "name": n} for s, c, n in kernels[:12]],
    }
    if args.config == "dp_cifar_cnn":
        device, host, calls = device_time_by_range(prof, RANGES)
        vg, dpc, ev = (device[n] for n in RANGES)
        k12 = groups.get("dp_sq_norms", 0.0) + groups.get("dp_scaled_sum", 0.0)
        out["split_s"] = {
            "per_example_grads": vg - dpc,
            "dp_kernels_k1_k2": k12,
            "dp_norms_clip_noise_glue": dpc - k12,
            "sgd_update_and_engine_glue": busy - vg - ev,
            "eval": ev,
            "host_idle": wall - busy,
        }
        out["range_device_s"], out["range_host_s"], out["range_calls"] = device, host, calls
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
