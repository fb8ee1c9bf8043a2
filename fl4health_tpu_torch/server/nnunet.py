"""``NnunetServer``: plans negotiation, then the federated segmentation job
(counterpart of ``fl4health_tpu/server/nnunet.py``).

Before round 1, with no ``nnunet_plans`` in its config, the server polls
one client, drawn from ``seed``, for its properties (``poll_clients``):
the plans as JSON bytes and the channel and class counts. It keeps the
plans in its config for the clients, builds the global architecture from
them, and hands them to ``sim_builder``, which builds the
``FederatedSimulation`` that ``fit`` runs.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from fl4health_tpu_torch.models.unet import unet_from_plans
from fl4health_tpu_torch.nnunet.plans import plans_from_bytes
from fl4health_tpu_torch.server.servers import poll_clients
from fl4health_tpu_torch.server.simulation import FederatedSimulation

logger = logging.getLogger(__name__)


class NnunetServer:
    """Negotiates plans, then runs the federated segmentation job.
    ``property_providers`` are the clients' ``get_properties`` handlers
    (``clients.nnunet.make_nnunet_properties_provider``);
    ``sim_builder(plans, num_input_channels, num_segmentation_heads)``
    builds the simulation once the architecture is known."""

    def __init__(self, config: dict[str, Any],
                 property_providers: Sequence[Callable[[Mapping[str, Any]], Mapping[str, Any]]],
                 sim_builder: Callable[[dict[str, Any], int, int], FederatedSimulation],
                 seed: int = 0):
        self.config = dict(config)
        self.property_providers = list(property_providers)
        self.sim_builder = sim_builder
        self.seed = seed
        self.plans: dict[str, Any] | None = None
        self.num_input_channels: int | None = None
        self.num_segmentation_heads: int | None = None
        self.global_model = None
        self.sim: FederatedSimulation | None = None

    def update_before_fit(self) -> None:
        """The pre-round-1 handshake."""
        plans_bytes = self.config.get("nnunet_plans")
        if plans_bytes is None:
            logger.info("[PRE-INIT] no nnunet_plans in config — requesting properties "
                        "from one random client via get_properties")
            idx = int(np.random.default_rng(self.seed).integers(len(self.property_providers)))
            props = poll_clients([self.property_providers[idx]], dict(self.config))[0]
            plans_bytes = props["nnunet_plans"]
            self.num_input_channels = int(props["num_input_channels"])
            self.num_segmentation_heads = int(props["num_segmentation_heads"])
            logger.info("Received plans from client %d", idx)
        elif "num_input_channels" in self.config and "num_segmentation_heads" in self.config:
            self.num_input_channels = int(self.config["num_input_channels"])
            self.num_segmentation_heads = int(self.config["num_segmentation_heads"])
        else:
            props = poll_clients([self.property_providers[0]], dict(self.config))[0]
            self.num_input_channels = int(props["num_input_channels"])
            self.num_segmentation_heads = int(props["num_segmentation_heads"])
        self.plans = plans_from_bytes(plans_bytes)
        self.config["nnunet_plans"] = plans_bytes  # later rounds' client config
        self.global_model = unet_from_plans(self.plans, self.num_input_channels,
                                            self.num_segmentation_heads)

    def fit(self, n_rounds: int):
        if self.plans is None:
            self.update_before_fit()
        self.sim = self.sim_builder(self.plans, self.num_input_channels,
                                    self.num_segmentation_heads)
        return self.sim.fit(n_rounds)

    @property
    def global_params(self):
        if self.sim is None:
            raise RuntimeError("fit() has not run")
        return self.sim.global_params
