"""Parameter exchangers (counterpart of ``fl4health_tpu/exchange/exchanger.py``;
``FullExchanger`` only)."""

from __future__ import annotations

from fl4health_tpu_torch.core.types import Params


class FullExchanger:
    """Exchange every leaf: ``push`` sends the params, ``pull`` takes the
    payload whole."""

    def push(self, params: Params, initial_params: Params | None = None) -> Params:
        del initial_params
        return params

    def pull(self, payload: Params, local: Params) -> Params:
        del local
        return payload
