#!/usr/bin/env python3
"""Warm round walls of the DP path in the tree this script runs from.

Builds ``chip_smoke.py``'s full-width ``dp_cifar_cnn`` (64 clients, bf16,
observability off, cuDNN deterministic) on the card, on the pipelined and
on the chunked route: one warm-up round, then three timed ``fit`` calls of
2 rounds each, each ending in ``torch.cuda.synchronize()``. Prints one JSON
line: the tree's label and the seconds a round of each call.

To compare two commits on one card, unpack the other commit into a
directory (``git archive <commit> | tar -x -C <dir>``), copy this script
into both trees and run it from each tree's root in turns within one call:

    python3 tools/torch_port_round_ab.py --label change
    (cd <dir> && python3 torch_port_round_ab.py --label parent)
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_round_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from fl4health_tpu_torch.kernels import dp_clip as dp

    dp.build_extension()
    cs.deterministic_flags()
    data = cs.image_datasets(cs.DP_CLIENTS, cs.DP_TRAIN, cs.DP_VAL, (32, 32, 3))
    out = {"label": args.label, "card": cs.card_line()}
    for mode in ("pipelined", "chunked"):
        sim = cs.build_dp_sim(data, torch.bfloat16, "cuda", cs.DP_SIGMA, seed=0,
                              execution_mode=mode)
        sim.fit(1)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            sim.fit(2)
            torch.cuda.synchronize()
            walls.append((time.time() - t0) / 2)
        out[f"{mode}_s_per_round"] = walls
        del sim
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
