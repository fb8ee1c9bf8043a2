"""Checkpointing (counterpart of ``fl4health_tpu/checkpointing``): model
artifacts with latest and best policies in pre- and post-aggregation modes
(``checkpointer``), crash-consistent resumable run state (``state``), the
off-loop writer (``async_writer``), and flax's msgpack format without flax
(``serialization``)."""

from fl4health_tpu_torch.checkpointing.async_writer import AsyncCheckpointWriter
from fl4health_tpu_torch.checkpointing.checkpointer import (BestLossCheckpointer,
                                                            BestMetricCheckpointer,
                                                            CheckpointMode,
                                                            FunctionCheckpointer,
                                                            LatestCheckpointer,
                                                            ParamsCheckpointer, load_params,
                                                            save_params)
from fl4health_tpu_torch.checkpointing.state import (CheckpointConfigMismatchError,
                                                     CheckpointCorruptError, RestoreInfo,
                                                     SimulationStateCheckpointer, Snapshotter,
                                                     StateCheckpointer)

__all__ = [
    "AsyncCheckpointWriter",
    "BestLossCheckpointer",
    "BestMetricCheckpointer",
    "CheckpointConfigMismatchError",
    "CheckpointCorruptError",
    "CheckpointMode",
    "FunctionCheckpointer",
    "LatestCheckpointer",
    "ParamsCheckpointer",
    "RestoreInfo",
    "SimulationStateCheckpointer",
    "Snapshotter",
    "StateCheckpointer",
    "load_params",
    "save_params",
]
