"""Core type vocabulary (counterpart of ``fl4health_tpu/core/types.py``).

A client's model is a ``Params`` dict: flax path -> tensor, e.g.
``"layer_0/attn/q_proj/kernel"``, so a reader can match every entry with
the JAX tree. A cohort of simulated clients is the same dict with a leading
``[clients]`` axis on every tensor ("client-stacked").
"""

from __future__ import annotations

from typing import Any

import torch

Params = dict[str, torch.Tensor]
StackedParams = dict[str, torch.Tensor]
PyTree = Any


def num_params(params: Params) -> int:
    return sum(int(x.numel()) for x in params.values())
