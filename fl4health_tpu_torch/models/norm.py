"""flax's ``nn.BatchNorm`` with its running statistics as model state.

``torch.nn.BatchNorm*`` writes ``running_mean`` and ``running_var`` in
place, which neither ``torch.func.functional_call`` nor the simulation's
client ``vmap`` allows (the update would fail, or leak from one client into
the next). Here the statistics are an input and the new statistics an
output, as flax's ``batch_stats`` collection is: a model that holds a
:class:`BatchNorm` keeps them in ``TrainState.model_state`` under
``{"batch_stats": {<module path>: {"mean", "var"}}}`` (``engine.from_module``
threads the state through its forward).

flax's numbers, not torch's: the running averages decay by ``momentum``
0.99 (torch's momentum 0.1 is decay 0.9), the variance is the biased
``E[x^2] - E[x]^2`` clamped at 0 (flax's ``use_fast_variance``), epsilon is
1e-5, and the statistics reduce over every row of the batch (padding rows
included, as flax reduces them). The forward is
``(x - mean) * (rsqrt(var + eps) * scale) + bias``, flax's order.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis (``use_running_average``
    picks the stored statistics over the batch's). Params ``scale`` (ones)
    and ``bias`` (zeros); statistics ``mean`` (zeros) and ``var`` (ones)."""

    keeps_batch_stats = True

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def init_stats(self) -> dict:
        n = self.scale.shape[0]
        return {"mean": torch.zeros(n), "var": torch.ones(n)}

    def forward(self, x: torch.Tensor, stats: dict, use_running_average: bool):
        """-> (y, new_stats); the stats come back as they were where the
        stored ones are used."""
        if use_running_average:
            mean, var, new = stats["mean"], stats["var"], stats
        else:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(dim=axes)
            var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
            m = self.momentum
            new = {"mean": m * stats["mean"] + (1.0 - m) * mean,
                   "var": m * stats["var"] + (1.0 - m) * var}
        y = (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return y, new
