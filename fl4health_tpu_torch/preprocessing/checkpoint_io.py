"""Pretrained-checkpoint import (counterpart of
``fl4health_tpu/preprocessing/checkpoint_io.py``): read a checkpoint file
into a flat ``{dotted.path: array}`` namespace, hand it to
``WarmedUpModule``'s name surgery, and start training from weights instead
of noise.

Formats:
- ``.npz``, the native format (``save_checkpoint`` writes it), keyed by
  JAX's dotted tree paths: one file warm-starts both packages alike;
- ``.safetensors`` through the ``safetensors`` package, imported only when
  such a file is read;
- ``.pt`` / ``.bin`` / ``.pth``: torch state dicts (``weights_only=True``:
  data, not code).

Torch's Linear stores ``weight`` as ``[out, in]``; a Dense kernel is ``[in,
out]``. ``torch_linear_convention=True`` adds a transposed ``*.kernel``
alias beside every 2-D ``*.weight`` that is not an embedding table.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from fl4health_tpu_torch.preprocessing.warm_up import WarmedUpModule, flat_paths


def _host(v: Any) -> Any:
    """A host array of the leaf (bfloat16 tensors, which numpy cannot hold,
    stay CPU tensors)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v if v.dtype == torch.bfloat16 else v.numpy()
    return np.asarray(v)


def flatten_params(params: Any) -> dict[str, Any]:
    """A params tree -> ``{dotted.path: host array}``."""
    return {k: _host(v) for k, v in flat_paths(params).items()}


def save_checkpoint(path: str | Path, params: Any) -> Path:
    """Write a params tree as a flat ``.npz`` (bfloat16 leaves widened to
    f32, which ``.npz`` can hold)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {k: v.float().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in flatten_params(params).items()}
    np.savez(path, **flat)
    # np.savez appends .npz where absent
    return path if path.suffix == ".npz" else path.with_suffix(path.suffix + ".npz")


def load_flat_checkpoint(path: str | Path,
                         torch_linear_convention: bool = False) -> dict[str, Any]:
    """A checkpoint file -> flat ``{dotted.path: array}``."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"checkpoint not found: {path}")
    suffix = path.suffix.lower()
    if suffix == ".npz":
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
    elif suffix == ".safetensors":
        try:
            from safetensors.numpy import load_file
        except ImportError as e:
            raise ImportError(
                "reading .safetensors requires the safetensors package; "
                "convert to .npz (save_checkpoint) instead") from e
        flat = dict(load_file(str(path)))
    elif suffix in (".pt", ".bin", ".pth"):
        state = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(state, "state_dict"):
            state = state.state_dict()
        flat = {k: _host(v) for k, v in state.items()}
    else:
        raise ValueError(f"unsupported checkpoint format {suffix!r} "
                         "(expected .npz, .safetensors, .pt, .bin)")
    if torch_linear_convention:
        flat = _torchify_to_flax(flat)
    return flat


def _torchify_to_flax(flat: Mapping[str, Any]) -> dict[str, Any]:
    """Every key keeps its raw torch form, and a 2-D ``*.weight`` also
    appears as a transposed ``*.kernel`` alias, unless its path mentions an
    embedding (``[num, dim]`` in both conventions). A caller's
    ``weights_mapping`` can target either orientation; the warm-up's shape
    check arbitrates a leaf."""
    out: dict[str, Any] = dict(flat)
    for k, v in flat.items():
        if ((k == "weight" or k.endswith(".weight")) and v.ndim == 2
                and "embed" not in k.lower()):
            out[k[:-len("weight")] + "kernel"] = v.T
    return out


def warm_up_from_file(params: Any, path: str | Path,
                      weights_mapping: dict[str, str] | None = None,
                      torch_linear_convention: bool = False) -> Any:
    """One-call warm start: load ``path``, run ``WarmedUpModule``'s
    longest-prefix surgery, and return ``params`` with every matchable,
    shape-compatible leaf replaced (mismatches keep the fresh init, with a
    warning)."""
    flat = load_flat_checkpoint(path, torch_linear_convention)
    return WarmedUpModule(flat, weights_mapping).load_from_pretrained(params)
