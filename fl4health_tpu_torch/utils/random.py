"""Reproducibility helpers (counterpart of ``fl4health_tpu/utils/random.py``):
seed Python's and NumPy's global generators, which host-side code
(partitioners, batch order) draws from, and return the root threefry key
(``rng.py``), as JAX returns its ``PRNGKey``; save and restore the host
generators' states."""

from __future__ import annotations

import random as _random

import numpy as np
import torch

from fl4health_tpu_torch import rng


def set_all_random_seeds(seed: int = 42) -> torch.Tensor:
    """Seed Python's and NumPy's global generators and return
    ``rng.PRNGKey(seed)`` (a CPU key: move it where it draws)."""
    _random.seed(seed)
    np.random.seed(seed)
    return rng.PRNGKey(seed)


def save_random_state() -> tuple:
    return (_random.getstate(), np.random.get_state())


def restore_random_state(state: tuple) -> None:
    py_state, np_state = state
    _random.setstate(py_state)
    np.random.set_state(np_state)
