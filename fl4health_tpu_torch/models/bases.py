"""Model bases for the algorithm clients (counterpart of the parts of
``fl4health_tpu/models/bases.py`` the port's slices use): ``MoonModel``,
Ditto's ``TwinModel`` and the small dense blocks ``DenseFeatures`` and
``DenseHead``; the other bases wait for the personalisation slice.

Parameters keep the flax tree: a ``MoonModel``'s submodules are named
``base_module``, ``head_module`` and ``projection_module`` as flax names the
module attributes, each block's layers ``Dense_0``, ``Dense_1``, ..., so a
flax init converts with ``models/convert.py`` (e.g.
``base_module/Dense_0/kernel``). flax infers a Dense's input width at
init; here each block takes it at construction. A ``TwinModel``'s two
copies are ``global_model/...`` and ``personal_model/...``, as flax names
them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.models.cnn import _init_params
from fl4health_tpu_torch.models.transformer import LoraDense


class DenseFeatures(nn.Module):
    """Flatten, then a relu Dense per entry of ``features``."""

    def __init__(self, in_features: int, features: Sequence[int] = (64,)):
        super().__init__()
        widths = [in_features, *features]
        self.n_layers = len(features)
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            setattr(self, f"Dense_{i}", LoraDense(a, b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_layers):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return x


class DenseHead(nn.Module):
    """One Dense to ``n_outputs``."""

    def __init__(self, in_features: int, n_outputs: int = 10):
        super().__init__()
        self.Dense_0 = LoraDense(in_features, n_outputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)


class MoonModel(nn.Module):
    """base -> (projection) -> head, exposing the (projected) features as
    the contrastive representation: ``({"prediction": ...}, {"features":
    ...})``."""

    def __init__(self, base_module: nn.Module, head_module: nn.Module,
                 projection_module: nn.Module | None = None):
        super().__init__()
        self.base_module = base_module
        self.head_module = head_module
        self.projection_module = projection_module
        self.init_params(torch.Generator().manual_seed(0))

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor):
        features = self.base_module(x)
        if self.projection_module is not None:
            features = self.projection_module(features)
        return {"prediction": self.head_module(features)}, {"features": features}


def _prediction_of(out):
    """The logits of a submodel's output: ``(preds, features)``, a preds
    dict or a bare tensor."""
    if isinstance(out, tuple):
        out = out[0]
    if isinstance(out, dict):
        return out["prediction"]
    return out


class TwinModel(nn.Module):
    """Two full copies of an architecture, Ditto's layout: an exchanged
    ``global_model`` and a private ``personal_model``. Returns ``{"global",
    "personal", "prediction"}`` (the prediction is the personal model's)
    and each copy's features prefixed ``global_`` / ``personal_``. The
    copies are called on the input alone (the port's CNNs and MLPs take no
    ``train`` or ``rng``)."""

    def __init__(self, global_model: nn.Module, personal_model: nn.Module):
        super().__init__()
        self.global_model = global_model
        self.personal_model = personal_model

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor):
        g_out, p_out = self.global_model(x), self.personal_model(x)
        features = {}
        for prefix, out in (("global", g_out), ("personal", p_out)):
            if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1], dict):
                for k, v in out[1].items():
                    features[f"{prefix}_{k}"] = v
        g, p = _prediction_of(g_out), _prediction_of(p_out)
        return {"global": g, "personal": p, "prediction": p}, features

    @staticmethod
    def exchange_global_model(path: str) -> bool:
        return path.startswith("global_model")
