"""The single analytic-FLOP numerator rule (counterpart of
``fl4health_tpu/observability/flops.py``, the same code).

The op counter of ``observability/hloscan.py`` and any analytic MFU must
never disagree about the same matmul. This module is the one place the
counting convention lives:

- a dot/matmul of result shape ``M x N`` contracting over ``K`` costs
  ``2*M*N*K`` flops (multiply + add, the ``FL4HEALTH_BENCH_ANALYTIC_FLOPS``
  convention and XLA ``HloCostAnalysis``'s rule);
- a training step costs 3x the forward pass (forward + ~2x backward).

No torch import: tools import this without a device.
"""

from __future__ import annotations

from math import prod
from typing import Sequence

# Backward pass ~= 2x forward for dense nets (dL/dx and dL/dW each cost a
# forward-sized matmul), so train = 3x forward.
TRAIN_STEP_FLOP_MULTIPLIER = 3.0


def dot_flops(result_shape: Sequence[int], contracted: Sequence[int]) -> float:
    """Flops of one dot: 2 * prod(result dims) * prod(contracted dims)."""
    return 2.0 * prod(result_shape) * prod(contracted)


def matmul_flops(m: int, k: int, n: int) -> float:
    """Flops of one ``[m,k] @ [k,n]`` matmul: ``2*m*k*n``."""
    return dot_flops((m, n), (k,))


def transformer_fwd_flops_per_token(
    d_model: int, d_ff: int, n_layers: int, seq: int
) -> float:
    """Forward flops per token of a standard pre-LN transformer block stack.

    Per layer: QKV+out projections ``8*d^2``, attention scores+values
    ``4*seq*d`` (two ``[seq,d]x[d,seq]``-shaped contractions per token),
    and the two MLP matmuls ``4*d*d_ff``.
    """
    return (8.0 * d_model * d_model + 4.0 * seq * d_model + 4.0 * d_model * d_ff) * n_layers


def transformer_round_flops(
    d_model: int,
    d_ff: int,
    n_layers: int,
    seq: int,
    n_clients: int,
    batch: int,
    local_steps: int,
) -> float:
    """Analytic flops of one federated round of transformer local training:
    train-step multiplier x per-token forward x tokens per step x steps x
    clients."""
    per_tok_fwd = transformer_fwd_flops_per_token(d_model, d_ff, n_layers, seq)
    return TRAIN_STEP_FLOP_MULTIPLIER * per_tok_fwd * seq * batch * local_steps * n_clients
