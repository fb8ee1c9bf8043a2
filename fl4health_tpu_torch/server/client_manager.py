"""Client sampling (counterpart of ``fl4health_tpu/server/client_manager.py``;
``FullParticipationManager`` only): a manager maps a round to a [clients]
0/1 participation mask."""

from __future__ import annotations

import torch


class ClientManager:
    def __init__(self, n_clients: int):
        self.n_clients = n_clients

    def sample(self, round_idx: int, device: torch.device | str = "cpu") -> torch.Tensor:
        raise NotImplementedError

    def sample_all(self, device: torch.device | str = "cpu") -> torch.Tensor:
        return torch.ones((self.n_clients,), dtype=torch.float32, device=device)


class FullParticipationManager(ClientManager):
    """Every client every round."""

    def sample(self, round_idx: int, device: torch.device | str = "cpu") -> torch.Tensor:
        return self.sample_all(device)
