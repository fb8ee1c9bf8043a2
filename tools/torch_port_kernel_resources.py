#!/usr/bin/env python3
"""Registers, spills and stack of the port's CUDA kernels, as ptxas reports
them for sm_90a.

Compiles each ``fl4health_tpu_torch/kernels/csrc/*.cu`` with
``nvcc -Xptxas -v`` (the sources have plain C interfaces, so no PyTorch
headers are needed) into ``fl4health_tpu_torch/kernels/_build/resources/``
and prints one JSON line per kernel: its entry name as ptxas gives it
(mangled), registers per thread, spill stores and loads, stack frame and
static shared memory (bytes). The tensor-core kernels' dynamic shared
memory is the size of their layouts (``fwd_smem_bytes``,
``dq_smem_bytes``, ``dkv_smem_bytes`` in ``flash_attention_wgmma.cu``).

Run where nvcc is, from the repository root:
    python3 tools/torch_port_kernel_resources.py
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "fl4health_tpu_torch" / "kernels" / "csrc"
OUT = ROOT / "fl4health_tpu_torch" / "kernels" / "_build" / "resources"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def report(source: Path) -> list[dict]:
    obj = OUT / (source.stem + ".o")
    run = subprocess.run(
        [nvcc(), "-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-Xptxas", "-v", "-c", str(source), "-o", str(obj)],
        capture_output=True, text=True, check=True)
    rows, cur = [], None
    for line in run.stderr.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            cur = {"source": source.name, "kernel": entry.group(1)}
            rows.append(cur)
        elif cur is not None:
            for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_store_bytes", r"(\d+) bytes spill stores"),
                             ("spill_load_bytes", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("static_smem_bytes", r"(\d+) bytes smem")):
                hit = re.search(pat, line)
                if hit:
                    cur[key] = int(hit.group(1))
    return rows


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    for source in sorted(CSRC.glob("*.cu")):
        for row in report(source):
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
