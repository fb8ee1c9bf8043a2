"""Cross-silo transport (counterpart of ``fl4health_tpu/transport/``): the
wire codec (native C++ framing and JSON/array payloads, byte for byte
JAX's), the COO and compressed boundaries, a host RPC loopback and the
coordinator's concurrent rounds.

The in-process simulation runs on the card; this package is the host seam
for deployments whose silos cannot share a process. See ``codec.py`` for
the wire contract.
"""

from fl4health_tpu_torch.transport.codec import (
    decode,
    decode_sparse,
    encode,
    encode_sparse,
)
from fl4health_tpu_torch.transport.coordinator import (
    AsyncReply,
    BroadcastReport,
    QuorumError,
    SiloResult,
    SiloUpdateBuffer,
    broadcast_round,
    broadcast_round_detailed,
    weighted_merge,
)
from fl4health_tpu_torch.transport.loopback import LoopbackServer, call
from fl4health_tpu_torch.transport.native import FrameError, get_framing

__all__ = [
    "encode", "decode", "encode_sparse", "decode_sparse",
    "LoopbackServer", "call", "FrameError", "get_framing",
    "broadcast_round", "broadcast_round_detailed", "weighted_merge",
    "BroadcastReport", "QuorumError", "SiloResult",
    "SiloUpdateBuffer", "AsyncReply",
]
