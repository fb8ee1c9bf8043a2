#!/usr/bin/env python3
"""What the mesh slice's collectives and its one-rank flash ring cost on one
card.

Runs on a one-rank NCCL world (a ``torch.distributed.FileStore`` in a
temporary directory; no network) and prints one JSON line a measurement:

- each collective of ``fl4health_tpu_torch/parallel/compat.py`` at the
  shapes the mesh slice gives it: the ring's scatter and gather of the
  sequence axis of a [2·32, 2048, 8, 64] bf16 block (``transformer_long``'s
  q, k, v and out), and the all-reduce and all-gather of config 3's 98.4M-
  parameter f32 vector (the aggregate's sum; ZeRO-1's update), synchronised
  host time a call over 20 calls after a warm-up;
- ``transformer_long``'s warm round with ``flash_attention`` and with
  ``ring_flash_attention`` over the one-rank seq axis, in turns (flash,
  ring, ring, flash; each after 2 cold rounds);
- one ring round under ``torch.profiler`` (CPU and CUDA): its wall, and
  the host time of the collectives' Functions (``_ScatterToBlock``,
  ``_GatherFromBlocks`` and their vmap and backward nodes) with the device
  time they launch.

Run from the repository root: ``python3 tools/torch_port_mesh_probe.py``.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def timed(fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.time() - t0) / n * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_port_mesh_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as c
    # the module: the package exports the function of that name, as JAX's does
    fa = importlib.import_module("fl4health_tpu_torch.kernels.flash_attention")
    from fl4health_tpu_torch.kernels.flash_attention import flash_attention
    from fl4health_tpu_torch.parallel import compat
    from fl4health_tpu_torch.parallel.mesh import make_mesh
    from fl4health_tpu_torch.parallel.ring_attention import ring_flash_attention

    c.deterministic_flags()
    fa.build_extension()
    print(c.card_line())
    root = tempfile.mkdtemp(prefix="mesh_probe_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        seq = make_mesh((1,), ("seq",))
        axis = seq.axis("seq")
        block = torch.randn(2 * c.BATCH, c.T, c.H, c.D, device="cuda").to(torch.bfloat16)
        flat = torch.randn(c.BERT_PARAMS, device="cuda")
        print(json.dumps({"collective_ms": {
            "scatter_seq_block": timed(lambda: compat.scatter_to_block(block, axis, 1)),
            "gather_seq_block": timed(lambda: compat.gather_from_blocks(block, axis, 1)),
            "clone_seq_block": timed(lambda: block.clone()),
            "all_reduce_config3_f32": timed(lambda: compat.reduce_from_axis(flat, axis)),
            "all_gather_config3_f32": timed(lambda: compat.gather_from_blocks(flat, axis, 0)),
        }, "shapes": {"seq_block": list(block.shape), "config3_flat": [c.BERT_PARAMS]}}))
        del block, flat

        cfg = dict(vocab_size=8192, n_classes=4, d_model=512, n_heads=8, n_layers=4,
                   d_ff=2048, max_len=c.T)
        text = c.text_datasets(8192, c.T, c.BATCH * c.LOCAL_STEPS + 16, c.BATCH * c.LOCAL_STEPS)
        arms = {"flash": flash_attention,
                "ring": functools.partial(ring_flash_attention, mesh=seq)}
        sims = {}
        for name, fn in arms.items():
            sims[name] = c.build_sim(cfg, text, torch.bfloat16, "cuda", seed=0,
                                     attention_fn=fn, execution_mode="pipelined")
            sims[name].fit(2)
        walls = {name: [] for name in arms}
        for name in ("flash", "ring", "ring", "flash"):
            torch.cuda.synchronize()
            t0 = time.time()
            sims[name].fit(1)
            torch.cuda.synchronize()
            walls[name].append(time.time() - t0)
        print(json.dumps({"transformer_long_warm_round_s": walls}))

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            sims["ring"].fit(1)
            torch.cuda.synchronize()
            wall = time.time() - t0
        rows = prof.key_averages()
        coll = [r for r in rows if "ScatterToBlock" in r.key or "GatherFromBlocks" in r.key]
        print(json.dumps({
            "ring_round_profiled": {
                "wall_s": wall,
                "collective_functions": {r.key: {"calls": r.count,
                                                 "cpu_total_ms": r.cpu_time_total / 1e3,
                                                 "device_total_ms": r.device_time_total / 1e3}
                                         for r in coll}}}))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
