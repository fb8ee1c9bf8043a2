"""FedBuff, staleness-discounted buffered-async aggregation as a wrapper
(counterpart of ``fl4health_tpu/strategies/fedbuff.py``; Nguyen et al.,
arXiv:2106.06639).

The asynchrony itself is resolved to a static event plan
(``server/async_schedule.py``), so the strategy's job is one function: turn
an event's ``(arrivals, staleness)`` row into the aggregation mask the inner
strategy consumes. Aggregation weights already flow through
``FitResults.mask`` as floats (``w_i = n_i * mask_i / sum``), so a
fractional mask entry is a per-client weight multiplier, and ``FedBuff``
keeps the inner strategy's state and math untouched: its state is the inner
state. It composes with ``RobustFedAvg``, ``CompressingStrategy``,
``FedOpt``, SCAFFOLD: anything whose ``aggregate`` honours the mask. Its
per-client rows are the inner strategy's, so over a client registry they
gather and scatter unchanged.

At staleness 0 the discount is exactly 1.0 and the mask is the synchronous
one, bit for bit.
"""

from __future__ import annotations

from typing import Any

import torch

from fl4health_tpu_torch.server.async_schedule import staleness_discount
from fl4health_tpu_torch.strategies.base import (FitResults, Strategy,
                                                 inner_state_sharding_spec)


class FedBuff(Strategy):
    """Wrap any strategy with staleness-discounted async aggregation.

    ``async_aggregation_mask(arrivals, staleness)`` is the one async-only
    hook; everything else delegates, so a FedBuff-wrapped strategy run
    synchronously is the bare inner strategy bit for bit.

    staleness_exponent: discount ``1/(1+s)^exponent`` (0.5 = FedBuff's
        ``1/sqrt(1+s)``).
    max_staleness: updates staler than this get weight 0 (their client
        still restarts); None = no cap.
    """

    # its server state is the inner strategy's (replace_global_params)
    state_passthrough = True

    def __init__(self, inner: Strategy, staleness_exponent: float = 0.5,
                 max_staleness: int | None = None):
        if staleness_exponent < 0:
            raise ValueError("staleness_exponent must be >= 0")
        if max_staleness is not None and max_staleness < 0:
            raise ValueError("max_staleness must be >= 0 (or None)")
        self.inner = inner
        self.staleness_exponent = float(staleness_exponent)
        self.max_staleness = max_staleness
        self.weighted_aggregation = getattr(inner, "weighted_aggregation", True)
        # the chunked route's eligibility reads this, as for the other
        # wrappers
        inner_overrides = getattr(inner, "overrides_update_after_eval", None)
        if inner_overrides is None:
            inner_overrides = (type(inner).update_after_eval
                               is not Strategy.update_after_eval)
        self.overrides_update_after_eval = inner_overrides
        inner_qmask = getattr(inner, "quarantine_mask", None)
        if inner_qmask is not None:
            # state passthrough: FedBuff's state is the inner state
            self.quarantine_mask = inner_qmask

    # -- the async hook -------------------------------------------------
    def async_aggregation_mask(self, arrivals: torch.Tensor, staleness: torch.Tensor,
                               exponent=None) -> torch.Tensor:
        """[C] fractional aggregation mask for one buffer-fill event:
        ``arrivals * 1/(1+staleness)^exponent`` (0 past ``max_staleness``);
        a staleness-0 row returns ``arrivals`` bit for bit. ``exponent``
        (default: this wrapper's ``staleness_exponent``) may be a tensor:
        the async event programs pass the live ``staleness_exponent`` at
        each dispatch."""
        arrivals = torch.as_tensor(arrivals, dtype=torch.float32)
        staleness = torch.as_tensor(staleness, dtype=torch.float32, device=arrivals.device)
        disc = staleness_discount(
            staleness, self.staleness_exponent if exponent is None else exponent,
            self.max_staleness)
        return arrivals * disc

    # -- pure delegation (state passthrough) ----------------------------
    @property
    def evaluate_after_fit(self) -> bool:
        return bool(getattr(self.inner, "evaluate_after_fit", False))

    def bind_client_manager(self, client_manager: Any) -> None:
        self.inner.bind_client_manager(client_manager)

    def init(self, params) -> Any:
        return self.inner.init(params)

    def global_params(self, server_state: Any):
        return self.inner.global_params(server_state)

    def state_sharding_spec(self, server_state: Any, clients_axis: str):
        return inner_state_sharding_spec(self.inner, server_state, clients_axis)

    def divergence_reference(self, server_state: Any):
        return self.inner.divergence_reference(server_state)

    def state_rows(self, server_state: Any):
        # FedBuff's state is the inner state, so its rows are the inner rows
        return self.inner.state_rows(server_state)

    def scatter_state_rows(self, server_state: Any, rows):
        return self.inner.scatter_state_rows(server_state, rows)

    def client_payload(self, server_state: Any, round_idx):
        return self.inner.client_payload(server_state, round_idx)

    def aggregate(self, server_state: Any, results: FitResults, round_idx):
        # the event's discount is already folded into results.mask by the
        # async event program (and absent on a synchronous run)
        return self.inner.aggregate(server_state, results, round_idx)

    def update_after_eval(self, server_state, eval_losses, eval_metrics, mask):
        return self.inner.update_after_eval(server_state, eval_losses, eval_metrics, mask)
