"""The kernel wrappers' branch for fake tensors.

Round-program introspection (``observability/introspect.py``) runs a round
function once under ``FakeTensorMode``: no memory, no launch. A
hand-written kernel is a pybind call that a dispatch mode cannot see, so
each wrapper answers fake tensors itself: outputs of the right shape and
dtype, and a report of the call to the op counter
(``observability/hloscan.py``), which charges it as JAX charges a Pallas
call (0 flops, its boundary bytes, one custom call). The branch is taken
only when the tensors are fake: on real tensors a wrapper launches its
kernel or raises, as before.
"""

from __future__ import annotations

import torch


def is_fake(x: torch.Tensor) -> bool:
    """True for a ``FakeTensor`` (shape and dtype, no data)."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake

    return _is_fake(x)


def report(name: str, inputs, outputs):
    """Report one kernel call to the op counters active on this thread and
    return ``outputs``."""
    from fl4health_tpu_torch.observability.hloscan import note_custom_call

    note_custom_call(name, inputs, outputs)
    return outputs
