"""Model bases for the algorithm clients (counterpart of
``fl4health_tpu/models/bases.py``): the split models (``JoinMode``,
``SequentiallySplitModel`` with its alias ``FedRepModel``, ``HeadModule``,
``ParallelSplitModel`` with its aliases ``FendaModel`` and
``PerFclModel``), ``ApflModule``, GPFL's ``Gce``, ``CoV`` and
``GpflModel``, ``MoonModel``, Ditto's ``TwinModel``, ``EnsembleModel``,
``FedSimClrModel`` and the small blocks ``DenseFeatures``, ``DenseHead``
and ``ConvFeatures``.

Parameters keep the flax tree: submodules are named as flax names the
module attributes (``features_module``, ``second_feature_extractor``,
``head_module/head``, ``members_0``, ...), each block's layers ``Dense_0``,
``Conv_0``, ..., and GPFL's named layers ``feature_mapper``, ``cov``,
``gce/embedding`` and ``head``, so a flax init converts with
``models/convert.py`` (e.g. ``head_module/head/Dense_0/kernel``). A
submodule that flax never calls has no params there, and none here
(``FedSimClrModel``'s unused head). flax infers a Dense's input width at
init; here each block takes it at construction, or reads the width a
block before it hands out (``out_features``).

Which subtree crosses the wire is a path predicate for a
``FixedLayerExchanger``; each base carries its own as a staticmethod, as
in JAX.
"""

from __future__ import annotations

import enum
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.models.cnn import Conv, _flatten_hwc, _init_params
from fl4health_tpu_torch.models.transformer import LoraDense


class DenseFeatures(nn.Module):
    """Flatten, then a relu Dense per entry of ``features``."""

    def __init__(self, in_features: int, features: Sequence[int] = (64,)):
        super().__init__()
        widths = [in_features, *features]
        self.n_layers = len(features)
        self.out_features = widths[-1]
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
        self.out_features = n_outputs

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


# ---------------------------------------------------------------------------
# Convolutional block
# ---------------------------------------------------------------------------

class ConvFeatures(nn.Module):
    """flax ``ConvFeatures``: per entry of ``channels`` a 3x3 SAME
    convolution, relu and a 2x2 max-pool, on NHWC inputs of one example's
    shape ``input_shape``; flattened in flax's HWC order. Computes in the
    promoted dtype, as flax's ``nn.Conv`` does (``dtype=None``)."""

    def __init__(self, channels: Sequence[int] = (16, 32),
                 input_shape: tuple[int, int, int] = (32, 32, 3)):
        super().__init__()
        h, w, c = input_shape
        self.n_layers = len(channels)
        for i, (a, b) in enumerate(zip([c, *channels[:-1]], channels)):
            setattr(self, f"Conv_{i}", Conv(a, b, 3, dtype=None))
        scale = 2 ** len(channels)
        self.out_features = (h // scale) * (w // scale) * channels[-1]
        self.init_params(torch.Generator().manual_seed(0))

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_layers):
            x = F.max_pool2d(F.relu(getattr(self, f"Conv_{i}")(x)), 2)
        return _flatten_hwc(x)


# ---------------------------------------------------------------------------
# Sequential and parallel splits
# ---------------------------------------------------------------------------

class JoinMode(enum.Enum):
    """How ``HeadModule`` joins its two feature streams."""

    CONCATENATE = "concatenate"
    SUM = "sum"


class SequentiallySplitModel(nn.Module):
    """features -> head: ``({"prediction": ...}, {"features": ...})``."""

    def __init__(self, features_module: nn.Module, head_module: nn.Module):
        super().__init__()
        self.features_module = features_module
        self.head_module = head_module

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor):
        features = self.features_module(x)
        return {"prediction": self.head_module(features)}, {"features": features}

    @staticmethod
    def exchange_features_only(path: str) -> bool:
        """FedPer's and FedRep's wire: the feature extractor is shared, the
        head stays private."""
        return path.startswith("features_module")


# FedRep's model is the sequential split; its phases are gradient masks in
# FedRepClientLogic.
FedRepModel = SequentiallySplitModel


class HeadModule(nn.Module):
    """The parallel split's head over the two streams, concatenated
    (local first) or summed."""

    def __init__(self, head: nn.Module, join_mode: JoinMode = JoinMode.CONCATENATE):
        super().__init__()
        self.head = head
        self.join_mode = join_mode

    def forward(self, local_features: torch.Tensor, global_features: torch.Tensor):
        if self.join_mode is JoinMode.CONCATENATE:
            joined = torch.cat([local_features, global_features], dim=-1)
        else:
            joined = local_features + global_features
        return self.head(joined)


class ParallelSplitModel(nn.Module):
    """Two feature extractors side by side, joined by a ``HeadModule``; the
    ``second_feature_extractor`` is the globally shared one. Returns
    ``({"prediction"}, {"local_features", "global_features"})``."""

    def __init__(self, first_feature_extractor: nn.Module,
                 second_feature_extractor: nn.Module, head_module: HeadModule):
        super().__init__()
        self.first_feature_extractor = first_feature_extractor
        self.second_feature_extractor = second_feature_extractor
        self.head_module = head_module

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor):
        local_f = self.first_feature_extractor(x)
        global_f = self.second_feature_extractor(x)
        return ({"prediction": self.head_module(local_f, global_f)},
                {"local_features": local_f, "global_features": global_f})

    @staticmethod
    def exchange_global_extractor(path: str) -> bool:
        """FENDA's wire: the second (global) extractor only."""
        return path.startswith("second_feature_extractor")


# FENDA is the parallel split with the global-extractor wire; PerFCL reads
# both feature streams in its loss.
FendaModel = ParallelSplitModel
PerFclModel = ParallelSplitModel


# ---------------------------------------------------------------------------
# APFL
# ---------------------------------------------------------------------------

class ApflModule(nn.Module):
    """APFL's twin models: the personal logits are ``alpha * local + (1 -
    alpha) * global``. ``alpha`` (the client's, from ``extra``) is an
    argument of the forward, so the mixing is differentiable in it; None
    mixes at 0.5. Returns ``{"personal", "global", "local",
    "prediction"}`` (the prediction is the personal mixture), no
    features."""

    def __init__(self, local_model: nn.Module, global_model: nn.Module):
        super().__init__()
        self.local_model = local_model
        self.global_model = global_model

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor, alpha=None):
        if alpha is None:
            alpha = 0.5
        local_logits = _prediction_of(self.local_model(x))
        global_logits = _prediction_of(self.global_model(x))
        personal = alpha * local_logits + (1.0 - alpha) * global_logits
        return ({"personal": personal, "global": global_logits, "local": local_logits,
                 "prediction": personal}, {})

    @staticmethod
    def exchange_global_model(path: str) -> bool:
        return path.startswith("global_model")


# ---------------------------------------------------------------------------
# GPFL
# ---------------------------------------------------------------------------

def _unit_rows(a: torch.Tensor) -> torch.Tensor:
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-8)


class Gce(nn.Module):
    """The global conditional embedding table ``embedding`` [C, D]
    (normal, std 1). Returns the cosine logits of the features against
    the class embeddings and the raw table."""

    def __init__(self, n_classes: int, feature_dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n_classes, feature_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0, generator=generator)

    def forward(self, features: torch.Tensor):
        return _unit_rows(features) @ _unit_rows(self.embedding).T, self.embedding


class CoV(nn.Module):
    """The conditional-value map: gamma and beta from the conditional input
    (``Dense_0`` relu, then ``Dense_1`` and ``Dense_2``) modulate the
    features, ``relu(f * (1 + gamma) + beta)``."""

    def __init__(self, feature_dim: int):
        super().__init__()
        for i in range(3):
            setattr(self, f"Dense_{i}", LoraDense(feature_dim, feature_dim, dtype=None))

    def forward(self, features: torch.Tensor, conditional: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.Dense_0(conditional))
        gamma, beta = self.Dense_1(h), self.Dense_2(h)
        return F.relu(features * (1.0 + gamma) + beta)


class GpflModel(nn.Module):
    """GPFL: the base extractor, a ``feature_mapper`` Dense to
    ``feature_dim``, the ``cov`` map under the personal (``p_cond``) and
    the general (``g_cond``) conditional inputs (zeros when None), the
    ``gce`` table's cosine logits of the general features and a ``head``
    Dense on the personal ones. ``base_features`` is the extractor's output
    width (its ``out_features`` when None)."""

    def __init__(self, base_module: nn.Module, n_classes: int, feature_dim: int,
                 base_features: int | None = None):
        super().__init__()
        if base_features is None:
            base_features = base_module.out_features
        self.feature_dim = feature_dim
        self.base_module = base_module
        self.feature_mapper = LoraDense(base_features, feature_dim, dtype=None)
        self.cov = CoV(feature_dim)
        self.gce = Gce(n_classes, feature_dim)
        self.head = LoraDense(feature_dim, n_classes, dtype=None)
        self.init_params(torch.Generator().manual_seed(0))

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor, p_cond=None, g_cond=None):
        base = self.feature_mapper(self.base_module(x))
        zeros = base.new_zeros((self.feature_dim,))
        p_cond = zeros if p_cond is None else p_cond
        g_cond = zeros if g_cond is None else g_cond
        b = base.shape[0]
        personal_f = self.cov(base, p_cond[None].expand(b, -1))
        general_f = self.cov(base, g_cond[None].expand(b, -1))
        gce_logits, embeddings = self.gce(general_f)
        return ({"prediction": self.head(personal_f), "gce_logits": gce_logits},
                {"personal_features": personal_f, "general_features": general_f,
                 "gce_embeddings": embeddings})

    @staticmethod
    def exchange_shared(path: str) -> bool:
        """Everything but the personalised head crosses the wire."""
        return not path.startswith("head")


# ---------------------------------------------------------------------------
# Ensemble and FedSimCLR
# ---------------------------------------------------------------------------

class EnsembleModel(nn.Module):
    """Members trained together (``members_0``, ``members_1``, ...):
    ``ensemble-pred-i`` per member and their uniform mean as
    ``prediction``."""

    def __init__(self, members: Sequence[nn.Module]):
        super().__init__()
        self.n_members = len(members)
        for i, m in enumerate(members):
            setattr(self, f"members_{i}", m)

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor):
        preds, logits = {}, []
        for i in range(self.n_members):
            out = _prediction_of(getattr(self, f"members_{i}")(x))
            preds[f"ensemble-pred-{i}"] = out
            logits.append(out)
        preds["prediction"] = sum(logits) / float(len(logits))
        return preds, {}


class FedSimClrModel(nn.Module):
    """SimCLR's encoder and projection head (``pretrain``), or the encoder
    and a prediction head (fine-tuning). Only the head in use is a
    submodule, as only it has params in flax."""

    def __init__(self, encoder: nn.Module, projection_head: nn.Module,
                 prediction_head: nn.Module | None = None, pretrain: bool = True):
        super().__init__()
        self.encoder = encoder
        self.pretrain = pretrain
        if pretrain:
            self.projection_head = projection_head
        else:
            if prediction_head is None:
                raise ValueError("FedSimClrModel(pretrain=False) needs a prediction_head")
            self.prediction_head = prediction_head

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor):
        features = self.encoder(x)
        head = self.projection_head if self.pretrain else self.prediction_head
        return {"prediction": head(features)}, {"features": features}
