"""``PrecisionConfig`` and the mechanics of mixed-precision training
(counterpart of ``fl4health_tpu/precision/policy.py``).

- Compute dtype: on a train call, every float param and float input is cast
  to ``compute_dtype`` (``cast_model_def``: a ``.to(dtype)`` of each float
  leaf before the model runs), so the forward and backward run in
  bf16/fp16, and autograd hands the gradients back in f32 at the master
  params (the cast's backward). ``torch.autocast`` picks the dtype op by op
  and is not these semantics; it is not used.
- Master weights: ``TrainState.params`` and the optimizer state stay f32.
- Loss scaling (fp16): the engine seeds the backward with the scale,
  unscales the gradients in f32 and skips the optimizer step where a
  gradient is not finite; the scale, the growth streak and the count of
  skipped steps live in ``TrainState.loss_scale``.

The cast reaches only the layers that compute in the dtype of their
operands (``dtype=None``: ``conv_compute_dtype``'s promotion, as flax's).
A model that pins ``dtype=float32`` (``CifarNet``'s and
``TransformerClassifier``'s default) casts its operands back and computes
in f32 under the policy, in JAX as here: a known defect of the reference.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch

from fl4health_tpu_torch.core.pytree import tree_leaves, tree_map

_DTYPE_ALIASES = {
    "f32": "float32", "fp32": "float32", "float32": "float32",
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "f16": "float16", "fp16": "float16", "float16": "float16",
}
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}
_LOSS_SCALE_MODES = ("auto", "none", "static", "dynamic")


def _canonical_dtype_name(dtype: Any) -> str:
    if isinstance(dtype, str):
        name = _DTYPE_ALIASES.get(dtype.lower())
        if name is None:
            raise ValueError(f"compute_dtype must be one of f32|bf16|fp16 (got {dtype!r})")
        return name
    name = str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype) else str(dtype)
    if name not in _TORCH_DTYPES:
        raise ValueError(f"compute_dtype must be float32, bfloat16 or float16; got {name}")
    return name


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Static mixed-precision recipe.

    - ``compute_dtype``: ``"f32"``/``"bf16"``/``"fp16"`` (or their long
      names, or the torch dtypes). f32 builds the step without the policy.
    - ``keep_master_f32``: only True for low-precision compute; False is
      accepted for the no-op f32 config alone.
    - ``loss_scale``: ``"none"``, ``"static"`` or ``"dynamic"``; ``"auto"``
      is dynamic for fp16 and none otherwise.
    - the scaler's knobs: ``init_scale``, ``growth_interval``,
      ``growth_factor``, ``backoff_factor``, ``min_scale``, ``max_scale``.
    """

    compute_dtype: Any = "bfloat16"
    keep_master_f32: bool = True
    loss_scale: str = "auto"
    init_scale: float = 2.0 ** 15
    growth_interval: int = 200
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24

    def __post_init__(self):
        name = _canonical_dtype_name(self.compute_dtype)
        object.__setattr__(self, "compute_dtype", name)
        if self.loss_scale not in _LOSS_SCALE_MODES:
            raise ValueError(f"loss_scale must be one of {_LOSS_SCALE_MODES}; "
                             f"got {self.loss_scale!r}")
        if name == "float32" and self.loss_scale in ("static", "dynamic"):
            raise ValueError("loss_scale with f32 compute is a no-op that still pays the "
                             "finite-check and skip machinery: pick a low-precision "
                             "compute_dtype or loss_scale='none'")
        if not self.keep_master_f32 and name != "float32":
            raise ValueError("keep_master_f32=False is unsupported for low-precision "
                             "compute: the train state, the optimizer and DP clip->noise "
                             "are contracted to f32 master weights")
        if self.init_scale <= 0 or self.min_scale <= 0:
            raise ValueError("loss scales must be positive")
        if self.growth_interval < 1:
            raise ValueError("growth_interval must be >= 1")
        if self.growth_factor <= 1.0 or not (0.0 < self.backoff_factor < 1.0):
            raise ValueError("growth_factor must exceed 1.0 and backoff_factor lie in "
                             "(0, 1), or the dynamic scale cannot move the right way")

    @property
    def compute_dtype_name(self) -> str:
        return self.compute_dtype

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.compute_dtype]

    @property
    def casts_compute(self) -> bool:
        return self.compute_dtype != "float32"

    @property
    def resolved_loss_scale(self) -> str:
        if self.loss_scale != "auto":
            return self.loss_scale
        return "dynamic" if self.compute_dtype == "float16" else "none"

    @property
    def scaling_active(self) -> bool:
        return self.resolved_loss_scale != "none"

    @property
    def active(self) -> bool:
        """False: the engine builds the step without the policy."""
        return self.casts_compute or self.scaling_active

    def describe(self) -> dict:
        return {"compute_dtype": self.compute_dtype_name,
                "keep_master_f32": self.keep_master_f32,
                "loss_scale": self.resolved_loss_scale}


def resolve(precision: PrecisionConfig | None) -> PrecisionConfig | None:
    """None or an inactive config -> None."""
    if precision is None or not precision.active:
        return None
    return precision


def cast_floats(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating leaf cast to ``dtype``; integer and bool leaves (labels,
    token ids) pass through."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def conv_compute_dtype(x_dtype: torch.dtype, *param_dtypes: torch.dtype) -> torch.dtype:
    """The promotion rule of a ``dtype=None`` layer: the result type of the
    input and every parameter entering the op (flax's ``promote_dtype``,
    the bias included)."""
    out = x_dtype
    for d in param_dtypes:
        out = torch.promote_types(out, d)
    return out


def cast_model_def(model_def: Any, compute_dtype: torch.dtype) -> Any:
    """A ``ModelDef`` whose ``apply`` casts float params and float inputs to
    ``compute_dtype`` on train calls only; evaluation runs on the f32
    master untouched."""
    inner_apply = model_def.apply

    def apply(params, model_state, x, train=True, **kwargs):
        if train:
            params = cast_floats(params, compute_dtype)
            x = cast_floats(x, compute_dtype)
        return inner_apply(params, model_state, x, train=train, **kwargs)

    return dataclasses.replace(model_def, apply=apply)


def wrap_logic_compute(logic: Any, compute_dtype: torch.dtype) -> Any:
    """A shallow copy of a ``ClientLogic`` (same class, same attributes)
    whose ``model`` applies through ``cast_model_def``."""
    wrapped = copy.copy(logic)
    wrapped.model = cast_model_def(logic.model, compute_dtype)
    return wrapped


def loss_scale_init(precision: PrecisionConfig | None,
                    device: str | torch.device = "cpu") -> dict | None:
    """The loss-scale state ``{"scale", "growth", "skipped"}`` carried in
    ``TrainState``, or None where the policy does not scale."""
    precision = resolve(precision)
    if precision is None or not precision.scaling_active:
        return None
    return {"scale": torch.tensor(precision.init_scale, dtype=torch.float32, device=device),
            "growth": torch.zeros((), dtype=torch.int32, device=device),
            "skipped": torch.zeros((), dtype=torch.float32, device=device)}


def tree_all_finite(tree: Any) -> torch.Tensor:
    """1.0 where every floating entry of the tree is finite, else 0.0 (an f32
    scalar, to gate the engine's selects)."""
    checks = [torch.isfinite(x).all() for x in tree_leaves(tree)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not checks:
        return torch.ones((), dtype=torch.float32)
    return torch.stack(checks).all().to(torch.float32)


def loss_scale_step(ls: dict, finite: torch.Tensor, precision: PrecisionConfig) -> dict:
    """One scaler update (torch.cuda.amp's semantics): a non-finite gradient
    backs the scale off and zeroes the growth streak; ``growth_interval``
    finite steps in a row grow it, clamped to ``[min_scale, max_scale]``.
    ``skipped`` counts skipped optimizer steps. A static scale counts its
    skips and never moves."""
    ok = finite > 0
    skipped = ls["skipped"] + (1.0 - finite)
    if precision.resolved_loss_scale == "static":
        return {"scale": ls["scale"], "growth": ls["growth"], "skipped": skipped}
    grown = ls["growth"] + 1
    do_grow = grown >= precision.growth_interval
    new_scale = torch.where(
        ok,
        torch.where(do_grow, torch.clamp(ls["scale"] * precision.growth_factor,
                                         max=precision.max_scale), ls["scale"]),
        torch.clamp(ls["scale"] * precision.backoff_factor, min=precision.min_scale))
    new_growth = torch.where(ok, torch.where(do_grow, torch.zeros_like(grown), grown),
                             torch.zeros_like(grown))
    return {"scale": new_scale, "growth": new_growth, "skipped": skipped}
