#!/usr/bin/env python3
"""Where one round of a port path spends its device time.

Builds one of ``chip_smoke.py``'s full-width federated runs on the card, runs
one warm-up round, then profiles the next round (``--rounds N``: the next N,
in one pipelined ``fit``, so the producer runs ahead across them) with
``torch.profiler`` (CPU + CUDA activities) and prints one JSON line: the
rounds' host wall time, the summed device time by kernel group, the top
kernels by device time, the device busy share (summed kernel time over the
profiled wall; a single stream, so kernels do not overlap), the rounds' peak
device memory, and the host pipeline's share (``pipeline``: the host time
of the consumer's epilogues, of the index plans and of the batch gathers,
each on the thread that ran it, and the bytes of a round's one
device-to-host pull).

The rounds run every client in one ``torch.func.vmap`` (the simulation's
``vmap_clients``), so each range below opens once a local step (or once a
round) for all clients at once; ``range_calls`` counts them.

  --config transformer_long  (default) the flash-attention path; groups: the
      three flash kernels (by name, so each group holds both routes: the
      tensor-core ``wgmma_flash_*_kernel`` and the CUDA-core kernels), GEMMs,
      everything else.
  --config dp_cifar_cnn  the DP-FedAvg CifarNet path; the round is split by
      ``record_function`` ranges the tool wraps around the clients'
      ``value_and_grads``, the DP clip-and-noise call inside it and the
      evaluation phase: per-example grads (value_and_grads less the DP call),
      the K1/K2 kernels, the rest of the DP call (norms, clip factor, noise),
      the SGD update and engine glue (the rest of fit), evaluation, and host
      idle (wall less busy). A device op belongs to the range in which the
      host launched it (the trace links each kernel, copy or fill to its
      launch call); the host time spent in each range is given beside it.
  --config client_dp_cifar_cnn  the client-level DP-FedAvgM CifarNet path
      (64 uneven clients, Poisson sampling at q = 0.25); ranges around the
      clients' ``value_and_grads`` (forward and backward), their
      ``finalize_round`` (the update's clip), the manager's ``sample``, the
      strategy's ``aggregate`` (weighted sums, server noise, momentum,
      bound update) and the evaluation phase; the rest of fit is the SGD
      update and engine glue. The path launches none of the port's kernels.
  --config scaffold_cifar_cnn | fedprox_cifar_cnn  BASELINE.json config 2
      (16 non-IID clients, one local epoch padded to the longest client's
      12 steps; SCAFFOLD after its warm start); ranges around the clients'
      ``value_and_grads`` (forward and backward, FedProx's penalty
      included), ``transform_gradients`` (SCAFFOLD's correction),
      ``finalize_round`` (its variate update), the strategy's ``aggregate``
      and the evaluation phase; the rest of fit is the SGD update and
      engine glue. No kernel of the port's.
  --config dp_scaffold_cifar_cnn  DP-SCAFFOLD on the DP path (after its
      warm start): the dp_cifar_cnn split, with the correction and the
      variate update split out as above.
  --config bert_lora_fedopt_base  BASELINE.json config 3 at BERT-base width
      (LoRA rank 4, 4 clients, bf16, flash attention); ranges around the
      clients' ``value_and_grads`` (forward and backward, every leaf's
      gradient, as JAX computes them), their masked Adam (``tx.update``),
      the server's ``aggregate`` (the weighted mean and FedOpt's Adam over
      the whole tree) and the evaluation phase; groups: K3-K5 by name,
      GEMMs, the rest. Then a second profiled round in which the clients
      differentiate only the trainable leaves (a measurement variant, not
      the port's path): the forward-backward's device time that goes is
      the frozen leaves' gradients (``frozen_leaf_grads_s``).

Run on the card from the repository root:
    python3 tools/torch_port_round_profile.py [--config dp_cifar_cnn]
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

RANGES = ("profile::value_and_grads", "profile::dp_clip_noise", "profile::eval")

CDP_RANGES = ("profile::value_and_grads", "profile::finalize_round", "profile::sample",
              "profile::aggregate", "profile::eval")

ALG_RANGES = ("profile::value_and_grads", "profile::transform_gradients",
              "profile::finalize_round", "profile::aggregate", "profile::eval",
              "profile::dp_clip_noise")

BERT_RANGES = ("profile::value_and_grads", "profile::client_adam", "profile::aggregate",
               "profile::eval")


def kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "flash_fwd"
    if "flash_bwd_dq_kernel" in name:
        return "flash_bwd_dq"
    if "flash_bwd_dkv_kernel" in name:
        return "flash_bwd_dkv"
    if "sq_norms_tree_kernel" in name:
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


def ranged(name, fn):
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


def client_dp_sim():
    """chip_smoke's client-level DP path, with profiler ranges."""
    import chip_smoke as cs
    from fl4health_tpu_torch.models.cnn import CifarNet

    data = cs.hospital_datasets(cs.CDP_CLIENTS, cs.CDP_POOL, (32, 32, 3))
    sim = cs.build_client_dp_sim(data, CifarNet(10, dtype=torch.bfloat16), "cuda",
                                 cs.CDP_FRACTION, seed=0)
    sim.sampled_masks, _ = cs.record_rounds(sim)
    for obj, attr, name in ((sim.logic, "value_and_grads", CDP_RANGES[0]),
                            (sim.logic, "finalize_round", CDP_RANGES[1]),
                            (sim.client_manager, "sample", CDP_RANGES[2]),
                            (sim.strategy, "aggregate", CDP_RANGES[3]),
                            (sim, "_eval_round", CDP_RANGES[4])):
        setattr(obj, attr, ranged(name, getattr(obj, attr)))
    return sim


def dp_sim():
    """chip_smoke's DP path, with profiler ranges around the client's
    gradient computation, its DP call and the evaluation phase."""
    import chip_smoke as cs
    from fl4health_tpu_torch.clients import instance_level_dp
    from fl4health_tpu_torch.privacy import dpsgd

    data = cs.image_datasets(cs.DP_CLIENTS, cs.DP_TRAIN, cs.DP_VAL, (32, 32, 3))
    sim = cs.build_dp_sim(data, torch.bfloat16, "cuda", cs.DP_SIGMA, seed=0)

    logic = sim.logic
    logic.value_and_grads = ranged(RANGES[0], logic.value_and_grads)
    dpsgd_call = dpsgd.noisy_clipped_mean_grads
    instance_level_dp.dpsgd.noisy_clipped_mean_grads = ranged(RANGES[1], dpsgd_call)
    sim._eval_round = ranged(RANGES[2], sim._eval_round)
    return sim


def alg_sim(kind: str):
    """chip_smoke's config-2 path ``kind`` ("scaffold", "fedprox" or
    "dp_scaffold"), warm-started where SCAFFOLD is, with profiler ranges."""
    import chip_smoke as cs
    from fl4health_tpu_torch.clients import instance_level_dp
    from fl4health_tpu_torch.privacy import dpsgd
    from fl4health_tpu_torch.server.servers import scaffold_warm_start

    if kind == "dp_scaffold":
        data = cs.image_datasets(cs.DP_CLIENTS, cs.DP_TRAIN, cs.DP_VAL, (32, 32, 3))
        sim = cs.build_alg_sim(kind, data, "cuda", local_steps=cs.LOCAL_STEPS)
        instance_level_dp.dpsgd.noisy_clipped_mean_grads = ranged(
            ALG_RANGES[5], dpsgd.noisy_clipped_mean_grads)
    else:
        sim = cs.build_alg_sim(kind, cs.dirichlet_cifar_datasets(), "cuda")
    if kind != "fedprox":
        scaffold_warm_start(sim)
    for obj, attr, name in ((sim.logic, "value_and_grads", ALG_RANGES[0]),
                            (sim.logic, "transform_gradients", ALG_RANGES[1]),
                            (sim.logic, "finalize_round", ALG_RANGES[2]),
                            (sim.strategy, "aggregate", ALG_RANGES[3]),
                            (sim, "_eval_round", ALG_RANGES[4])):
        setattr(obj, attr, ranged(name, getattr(obj, attr)))
    return sim


def bert_sim():
    """chip_smoke's config-3 path, with profiler ranges."""
    import dataclasses

    import chip_smoke as cs
    from fl4health_tpu_torch.kernels.flash_attention import flash_attention

    data = cs.bert_datasets(cs.BERT_CFG, cs.BERT_CLIENTS, cs.BERT_TRAIN + cs.BERT_VAL,
                            cs.BERT_TRAIN)
    sim = cs.build_bert_sim(cs.BERT_CFG, data, torch.bfloat16, "cuda", 0, flash_attention,
                            False, cs.BERT_LR, cs.BATCH, cs.LOCAL_STEPS)
    sim.logic.value_and_grads = ranged(BERT_RANGES[0], sim.logic.value_and_grads)
    sim.tx = dataclasses.replace(sim.tx, update=ranged(BERT_RANGES[1], sim.tx.update))
    sim.strategy.aggregate = ranged(BERT_RANGES[2], sim.strategy.aggregate)
    sim._eval_round = ranged(BERT_RANGES[3], sim._eval_round)
    sim._fit_round, _ = sim._build_round_fns()  # the step closes over tx
    return sim


def trainable_only_grads(sim) -> None:
    """Make the clients differentiate only the trainable (LoRA and head)
    leaves, the frozen leaves' gradients zeros: a measurement of what the
    frozen leaves' gradients cost, not the port's path."""
    from fl4health_tpu_torch.utils.peft import lora_trainable_mask

    logic = sim.logic
    mask = lora_trainable_mask(sim.global_params)

    def value_and_grads(state, ctx, batch, step_rng):
        def loss(trainable):
            params = {**state.params, **trainable}
            preds, features = logic.predict(params, batch, train=True, ctx=ctx,
                                            rng=step_rng)
            backward, additional = logic.training_loss(preds, features, batch, params,
                                                       state, ctx)
            return backward, (preds, additional)

        grads, (backward, aux) = torch.func.grad_and_value(loss, has_aux=True)(
            {k: v for k, v in state.params.items() if mask[k]})
        return (backward, aux), {k: grads[k] if mask[k] else torch.zeros_like(v)
                                 for k, v in state.params.items()}

    logic.value_and_grads = ranged(BERT_RANGES[0], value_and_grads)
    sim._fit_round, _ = sim._build_round_fns()


def pipeline_timers(sim) -> dict:
    """Host clocks around the round pipeline's work, on whichever thread runs
    it (the profiler records no ranges on the pipeline's own threads): the
    consumer's epilogue (its one pull included), the index plans and the
    batch gathers (the prefetcher's, on its worker thread). Returns the dict
    the seconds, calls and each round's pull size go into."""
    from fl4health_tpu_torch.clients import engine

    timed = {"host_s": collections.Counter(), "calls": collections.Counter(),
             "pull_bytes": []}

    def clocked(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                timed["host_s"][name] += time.perf_counter() - t0
                timed["calls"][name] += 1
        return call

    finish = clocked("finish_round", sim._finish_round)

    def finish_round(work):
        timed["pull_bytes"].append(work.pull.nbytes)
        return finish(work)

    sim._finish_round = finish_round
    sim._round_plan = clocked("round_plan", sim._round_plan)
    engine.gather_batches = clocked("gather", engine.gather_batches)
    return timed


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
    parser.add_argument("--config", choices=("transformer_long", "dp_cifar_cnn",
                                             "client_dp_cifar_cnn", "scaffold_cifar_cnn",
                                             "fedprox_cifar_cnn", "dp_scaffold_cifar_cnn",
                                             "bert_lora_fedopt_base"),
                        default="transformer_long")
    parser.add_argument("--rounds", type=int, default=1,
                        help="profile this many rounds in one pipelined fit (the "
                             "times are their sums, the busy share over their wall)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    sim = {"dp_cifar_cnn": dp_sim, "client_dp_cifar_cnn": client_dp_sim,
           "transformer_long": transformer_sim,
           "scaffold_cifar_cnn": lambda: alg_sim("scaffold"),
           "fedprox_cifar_cnn": lambda: alg_sim("fedprox"),
           "dp_scaffold_cifar_cnn": lambda: alg_sim("dp_scaffold"),
           "bert_lora_fedopt_base": bert_sim}[args.config]()
    sim.execution_mode = "pipelined"  # the route whose pipeline the clocks read
    timed = pipeline_timers(sim)
    sim.fit(1)  # warm-up: kernel build, cuBLAS/cuDNN handles, allocator
    torch.cuda.synchronize()
    for counter in (timed["host_s"], timed["calls"]):
        counter.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        sim.fit(args.rounds)
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
        if evt.key in RANGES + CDP_RANGES + ALG_RANGES + BERT_RANGES:  # a range's span
            continue
        g = kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + dev_us / 1e6
        kernels.append((dev_us / 1e6, evt.count, evt.key[:90]))
    busy = sum(groups.values())
    kernels.sort(reverse=True)
    recs = sim.history[-args.rounds:]
    out = {
        "config": args.config, "profiled_rounds": [r.round for r in recs],
        "round_wall_s": wall,
        # host time around the dispatches: the pipelined producer never
        # waits for the device
        "fit_dispatch_s": sum(r.fit_elapsed_s for r in recs),
        "eval_dispatch_s": sum(r.eval_elapsed_s for r in recs),
        "device_s_by_group": groups, "device_busy_s": busy,
        "device_busy_share": busy / wall,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels": [{"s": s, "count": c, "name": n} for s, c, n in kernels[:12]],
    }
    out["pipeline"] = {"host_s": dict(timed["host_s"]), "calls": dict(timed["calls"]),
                       "pull_bytes": timed["pull_bytes"][-1]}
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
    if args.config == "client_dp_cifar_cnn":
        device, host, calls = device_time_by_range(prof, CDP_RANGES)
        vg, fin, smp, agg, ev = (device[n] for n in CDP_RANGES)
        out["split_s"] = {
            "forward_backward": vg,
            "update_clip": fin,
            "sampling": smp,
            "server_aggregate_noise": agg,
            "sgd_update_and_engine_glue": busy - vg - fin - smp - agg - ev,
            "eval": ev,
            "host_idle": wall - busy,
        }
        # every client trains and non-participants are masked out, as in JAX
        out["clients_sampled"] = int(sim.sampled_masks[-1].sum())
        out["range_device_s"], out["range_host_s"], out["range_calls"] = device, host, calls
    if args.config in ("scaffold_cifar_cnn", "fedprox_cifar_cnn", "dp_scaffold_cifar_cnn"):
        device, host, calls = device_time_by_range(prof, ALG_RANGES)
        vg, tg, fin, agg, ev, dpc = (device[n] for n in ALG_RANGES)
        split = {"forward_backward": vg - dpc, "correction": tg, "variate_update": fin,
                 "server_aggregate": agg, "sgd_update_and_engine_glue":
                 busy - vg - tg - fin - agg - ev, "eval": ev, "host_idle": wall - busy}
        if dpc:
            k12 = groups.get("dp_sq_norms", 0.0) + groups.get("dp_scaled_sum", 0.0)
            split.update(dp_kernels_k1_k2=k12, dp_norms_clip_noise_glue=dpc - k12)
        out["split_s"] = split
        out["range_device_s"], out["range_host_s"], out["range_calls"] = device, host, calls
    if args.config == "bert_lora_fedopt_base":
        device, host, calls = device_time_by_range(prof, BERT_RANGES)
        vg, adam, agg, ev = (device[n] for n in BERT_RANGES)
        flash = sum(groups.get(k, 0.0) for k in ("flash_fwd", "flash_bwd_dq",
                                                 "flash_bwd_dkv"))
        out["split_s"] = {"forward_backward": vg, "client_masked_adam": adam,
                          "server_aggregate_fedopt_adam": agg,
                          "engine_glue": busy - vg - adam - agg - ev, "eval": ev,
                          "host_idle": wall - busy, "flash_k3_k5": flash,
                          "gemm": groups.get("gemm", 0.0)}
        out["range_device_s"], out["range_host_s"], out["range_calls"] = device, host, calls
        # the same rounds again with the clients differentiating only the
        # trainable leaves: the forward-backward time that goes is the
        # frozen leaves' gradients
        trainable_only_grads(sim)
        sim.fit(1)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof2:
            t0 = time.time()
            sim.fit(args.rounds)
            torch.cuda.synchronize()
            wall2 = time.time() - t0
        device2 = device_time_by_range(prof2, BERT_RANGES)[0]
        out["trainable_only"] = {"round_wall_s": wall2, "range_device_s": device2}
        out["frozen_leaf_grads_s"] = vg - device2[BERT_RANGES[0]]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
