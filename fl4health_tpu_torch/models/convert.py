"""flax params <-> the port's ``Params`` (flax path -> tensor).

The port keeps flax names and layouts (Dense kernels ``[in, out]``, embedding
``[vocab, d]``), so conversion is flattening the nested flax dict into
``"a/b/c"`` keys and back; no transposes.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from fl4health_tpu_torch.core.types import Params


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


def flax_to_torch(params: Mapping[str, Any],
                  device: str | torch.device = "cpu") -> Params:
    """Nested (or already path-keyed) flax params of numpy arrays -> Params.
    Keys come out sorted, the order flax flattens a dict in."""
    flat = _flatten(params)
    return {k: torch.tensor(np.asarray(flat[k]), device=device)
            for k in sorted(flat)}


def torch_to_flax(params: Params) -> dict[str, Any]:
    """Params -> the nested flax dict of numpy arrays."""
    out: dict[str, Any] = {}
    for path, val in params.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val.detach().cpu().numpy()
    return out
