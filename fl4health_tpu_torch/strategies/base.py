"""Strategy abstraction (counterpart of ``fl4health_tpu/strategies/base.py``):
a strategy owns a server state and two functions, ``client_payload`` (what
every client receives) and ``aggregate`` (stacked client packets -> new
server state). A strategy that keeps per-client server rows exposes them
through ``state_rows``/``scatter_state_rows`` (cohort-slot execution moves
them through the client registry); a wrapper strategy (``.inner`` on the
strategy and its state) installs params through ``replace_global_params``."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from fl4health_tpu_torch.core.pytree import tree_leaves
from fl4health_tpu_torch.core.types import Params


@dataclasses.dataclass(frozen=True)
class FitResults:
    """Stacked results of one fit round.

    packets:       client-stacked packets (params, or a logic's packet)
    sample_counts: [clients] train-set sizes
    train_losses:  dict of [clients] losses
    train_metrics: dict of [clients] metric values
    mask:          [clients] 1.0 = participated (and finished finite)
    """

    packets: Any
    sample_counts: torch.Tensor
    train_losses: Any
    train_metrics: Any
    mask: torch.Tensor


def replace_global_params(strategy: "Strategy", server_state: Any, params) -> Any:
    """``server_state`` with the innermost strategy's params replaced,
    through any nesting of wrappers (``CompressingStrategy``: ``.inner`` on
    the strategy and on its state; ``FedBuff``: ``.inner`` on the strategy
    alone, ``state_passthrough``). Every path that installs params goes
    through this: ``dataclasses.replace(state, params=...)`` works on an
    unwrapped state only."""
    if getattr(strategy, "state_passthrough", False):
        # a wrapper whose state is its inner strategy's (FedBuff)
        return replace_global_params(strategy.inner, server_state, params)
    if hasattr(strategy, "inner") and hasattr(server_state, "inner"):
        return dataclasses.replace(server_state, inner=replace_global_params(
            strategy.inner, server_state.inner, params))
    return dataclasses.replace(server_state, params=params)


def inner_state_sharding_spec(inner: "Strategy", server_state: Any, clients_axis: str):
    """A wrapped strategy's ``state_sharding_spec`` for use inside a
    wrapper's own spec tree: the inner strategy's "no preference" (no hook,
    or None) becomes an explicit replicate-everything ``P()``."""
    from fl4health_tpu_torch.parallel.mesh import P

    hook = getattr(inner, "state_sharding_spec", None)
    spec = hook(server_state, clients_axis) if hook else None
    return P() if spec is None else spec


class Strategy:
    def bind_client_manager(self, client_manager: Any) -> None:
        """Setup-time hook: the simulation calls it once with its client
        manager, so a strategy can derive or check its sampling assumptions
        (DP-FedAvgM's ``fraction_fit``). Default: nothing."""

    def init(self, params: Params) -> Any:
        raise NotImplementedError

    def state_sharding_spec(self, server_state: Any, clients_axis: str):
        """Optional per-leaf ``PartitionSpec`` tree (or prefix) for the
        server state on a client mesh (``parallel/mesh.py``); None: fully
        replicated."""
        return None

    def state_rows(self, server_state: Any) -> Any:
        """The server state's per-client rows, a tree whose every leaf has a
        leading ``[C]`` clients axis (error-feedback residuals), or None
        when the strategy keeps none. Cohort-slot execution gathers the
        sampled cohort's rows into ``[K]`` slots before a round and stores
        the updated rows afterwards, so a strategy with rows must start
        every client's row the same in ``init`` and keep client i's row a
        function of client i's participation only. A wrapper puts the inner
        strategy's rows under ``"inner"``."""
        return None

    def scatter_state_rows(self, server_state: Any, rows: Any) -> Any:
        """The inverse of ``state_rows``: the state with its per-client
        rows replaced by ``rows``; tree surgery only, so a gather and
        scatter round-trips bit for bit."""
        if tree_leaves(rows):
            raise ValueError(
                f"{type(self).__name__} has no per-client state rows to "
                "scatter into (state_rows() is None)")
        return server_state

    def global_params(self, server_state: Any) -> Params:
        return server_state.params

    def divergence_reference(self, server_state: Any) -> Params:
        """The point the round telemetry's weight divergence is measured
        from after aggregation (``observability/telemetry.py``): the global
        model by default; a wrapper answers for its inner strategy."""
        return self.global_params(server_state)

    def client_payload(self, server_state: Any, round_idx: int) -> Any:
        return server_state.params

    def aggregate(self, server_state: Any, results: FitResults, round_idx: int) -> Any:
        raise NotImplementedError

    def update_after_eval(self, server_state: Any, eval_losses: Any,
                          eval_metrics: Any, mask: torch.Tensor) -> Any:
        return server_state
