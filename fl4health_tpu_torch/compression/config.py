"""CompressionConfig, the static recipe of the compressed exchange
(counterpart of ``fl4health_tpu/compression/config.py``): top-k
sparsification with error feedback, stochastic uniform int8/int4
quantization with one scale a leaf, and an optional seeded randomized
Hadamard rotation (Konečný et al., arXiv:1610.05492). The codecs
(``compression/codecs.py``) read it inside each round's aggregate.
"""

from __future__ import annotations

import dataclasses

#: bits -> max quantization level L of the symmetric signed grid
#: {-L, ..., -1, 0, 1, ..., L}; int8 uses the full signed-byte range less
#: the asymmetric -128, int4 the signed-nibble range less -8.
QUANT_LEVELS = {8: 127, 4: 7}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Static codec recipe for client->server update compression.

    - ``topk_fraction``: keep only this fraction of the update's
      coordinates (global magnitude top-k over the flat update, ties to
      the lowest index); ``None`` disables sparsification.
    - ``error_feedback``: carry each client's unsent mass (sparsification
      + quantization error) in a per-client residual that is added to the
      next round's update before encoding (SEC/EF-SGD memory). Only
      meaningful when a lossy stage is enabled.
    - ``quant_bits``: stochastic uniform quantization of the (selected)
      values to a symmetric signed int8/int4 grid with one scale per
      leaf; ``None`` ships f32 values.
    - ``rotation``: precondition each leaf with a seeded randomized
      Hadamard transform before top-k/quantization (spreads outlier
      coordinates so a uniform grid wastes less range); the decode side
      applies the inverse rotation with the same seed.
    - ``seed``: base seed for every stochastic draw (rotation signs,
      quantization rounding); folded with the round index and client index
      so both execution modes draw identically.
    """

    topk_fraction: float | None = None
    error_feedback: bool = True
    quant_bits: int | None = None
    rotation: bool = False
    seed: int = 0
    #: Optional per-round adaptive kept-fraction schedule
    #: ``("linear", f_start, f_end, over_rounds)``: the EFFECTIVE kept
    #: fraction interpolates f_start -> f_end over the first
    #: ``over_rounds`` rounds (then holds f_end), as a TRACED function of
    #: the round index. ``topk_fraction`` stays the
    #: STATIC ceiling: it fixes the selection shape (k = top-k slots, the
    #: wire sidecar size), so both endpoints must be <= it; coordinates
    #: ranked past the effective fraction are zeroed (their mass lands in
    #: the EF residual like any unsent mass). ``None`` = constant
    #: ``topk_fraction``, bit-identical to the pre-schedule codec.
    topk_schedule: tuple | None = None

    def __post_init__(self):
        if self.topk_fraction is not None and not (
            0.0 < self.topk_fraction <= 1.0
        ):
            raise ValueError(
                f"topk_fraction must be in (0, 1]; got {self.topk_fraction}"
            )
        if self.topk_schedule is not None:
            if self.topk_fraction is None:
                raise ValueError(
                    "topk_schedule needs topk_fraction as its static "
                    "ceiling (the selection shape and wire sidecar are "
                    "sized by it)"
                )
            s = self.topk_schedule
            if (len(s) != 4 or s[0] != "linear"):
                raise ValueError(
                    "topk_schedule must be ('linear', f_start, f_end, "
                    f"over_rounds); got {s!r}"
                )
            _, f0, f1, over = s
            for name, f in (("f_start", f0), ("f_end", f1)):
                if not 0.0 < float(f) <= self.topk_fraction:
                    raise ValueError(
                        f"topk_schedule {name}={f} must be in (0, "
                        f"topk_fraction={self.topk_fraction}] — the static "
                        "ceiling fixes the compiled selection shape"
                    )
            if int(over) < 1:
                raise ValueError(
                    f"topk_schedule over_rounds must be >= 1; got {over}"
                )
        if self.quant_bits is not None and self.quant_bits not in QUANT_LEVELS:
            raise ValueError(
                f"quant_bits must be one of {sorted(QUANT_LEVELS)}; "
                f"got {self.quant_bits}"
            )
        if self.rotation and self.quant_bits is None:
            raise ValueError(
                "rotation is a quantization preconditioner; enable "
                "quant_bits with it (rotation alone is lossless and only "
                "spends compute)"
            )

    @property
    def enabled(self) -> bool:
        """True when any lossy stage is configured."""
        return self.topk_fraction is not None or self.quant_bits is not None

    @property
    def uses_error_feedback(self) -> bool:
        return self.error_feedback and self.enabled

    def describe(self) -> dict:
        """JSON-able config facts (run manifest / bench artifacts)."""
        out = {
            "topk_fraction": self.topk_fraction,
            "error_feedback": self.uses_error_feedback,
            "quant_bits": self.quant_bits,
            "rotation": self.rotation,
            "seed": self.seed,
        }
        if self.topk_schedule is not None:
            # absent on constant-fraction configs so legacy manifest
            # config hashes stay stable
            out["topk_schedule"] = list(self.topk_schedule)
        return out
