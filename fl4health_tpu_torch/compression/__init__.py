"""The compressed exchange (counterpart of ``fl4health_tpu/compression``):
``CompressionConfig`` (``config.py``), the codecs (``codecs.py``: top-k,
stochastic quantization, randomized Hadamard rotation, error feedback,
wire-byte arithmetic) and ``CompressingStrategy`` (``strategy.py``), which
runs the channel inside ``aggregate``. Enable with
``FederatedSimulation(compression=CompressionConfig(...))``."""

from fl4health_tpu_torch.compression.codecs import (
    compress_update,
    estimate_wire_nbytes,
    logical_nbytes,
    stochastic_quantize_leaf,
    topk_count,
    topk_mask,
)
from fl4health_tpu_torch.compression.config import QUANT_LEVELS, CompressionConfig
from fl4health_tpu_torch.compression.strategy import (
    CompressedExchangeState,
    CompressingStrategy,
)

__all__ = [
    "CompressionConfig",
    "QUANT_LEVELS",
    "CompressingStrategy",
    "CompressedExchangeState",
    "compress_update",
    "estimate_wire_nbytes",
    "logical_nbytes",
    "stochastic_quantize_leaf",
    "topk_count",
    "topk_mask",
]
