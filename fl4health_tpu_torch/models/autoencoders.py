"""Autoencoder bases, the VAE loss and the PCA module (counterpart of
``fl4health_tpu/models/autoencoders.py``).

- ``BasicAe``, ``VariationalAe``, ``ConditionalVae``: an encoder and a
  decoder (modules whose ``forward`` takes ``train``; a conditional pair
  also takes the condition). The VAEs' forward packs ``[logvar | mu | flat
  reconstruction]`` on the last axis so the packed output rides the
  prediction pipe and ``make_vae_loss`` unpacks it.
- The reparameterisation noise draws from flax's ``"sampling"`` stream:
  on a train call with a key, ``fold_in(rng, 2)``, and the root scope's
  first ``make_rng`` folds in the SHA-1 word of ``(1,)``; any other call
  draws from ``PRNGKey(0)``, so evaluation is deterministic, as in JAX.
- ``PcaModule`` is SVD-based PCA returning an immutable ``PcaState``. A
  singular vector's sign is the solver's choice (LAPACK, cuSOLVER and XLA
  may each flip one): compare components after aligning each column's
  sign; projections' norms, errors and variances do not depend on it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from fl4health_tpu_torch import rng as jrng
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.models.cnn import _init_params
from fl4health_tpu_torch.models.transformer import flax_scope_hash

# the root scope's first make_rng("sampling") (counter 1)
_SAMPLING_SCOPE_WORD = flax_scope_hash((1,))


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """``mu + eps * exp(0.5 * logvar)``, ``eps ~ N(0, I)`` from ``key``."""
    std = torch.exp(0.5 * logvar)
    return mu + jrng.normal(key, tuple(std.shape)).to(std.dtype) * std


def _sampling_key(x: torch.Tensor, train: bool, key: torch.Tensor | None) -> torch.Tensor:
    """The key the VAE's noise draws from: the model's ``"sampling"``
    stream on train calls with a key, ``PRNGKey(0)`` otherwise."""
    if train and key is not None:
        return jrng.fold_in(jrng.fold_in(key, 2), _SAMPLING_SCOPE_WORD)
    return torch.zeros(2, dtype=torch.int64, device=x.device)  # PRNGKey(0)


class BasicAe(nn.Module):
    """A standard autoencoder: ``({"prediction": recon}, {"latent": z})``."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def encode(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.encoder(x, train=train)

    def decode(self, z: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.decoder(z, train=train)

    def forward(self, x: torch.Tensor, train: bool = True):
        z = self.encode(x, train=train)
        return {"prediction": self.decode(z, train=train)}, {"latent": z}


class VariationalAe(nn.Module):
    """A VAE: the encoder returns ``(mu, logvar)``; the forward packs
    ``[logvar | mu | flat reconstruction]``."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def sampling(self, mu: torch.Tensor, logvar: torch.Tensor,
                 key: torch.Tensor) -> torch.Tensor:
        return reparameterize(mu, logvar, key)

    def forward(self, x: torch.Tensor, train: bool = True, rng: torch.Tensor | None = None):
        mu, logvar = self.encoder(x, train=train)
        z = reparameterize(mu, logvar, _sampling_key(x, train, rng))
        recon = self.decoder(z, train=train)
        packed = torch.cat([logvar, mu, recon.reshape(recon.shape[0], -1)], dim=1)
        return {"prediction": packed}, {"latent": z, "mu": mu, "logvar": logvar}


class ConditionalVae(nn.Module):
    """A conditional VAE: ``unpack_input_condition`` splits the packed
    input into (input, condition), which the encoder and the decoder take
    as their second argument."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 unpack_input_condition: Callable | None = None):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder
        self.unpack_input_condition = unpack_input_condition

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def sampling(self, mu: torch.Tensor, logvar: torch.Tensor,
                 key: torch.Tensor) -> torch.Tensor:
        return reparameterize(mu, logvar, key)

    def forward(self, x: torch.Tensor, train: bool = True, rng: torch.Tensor | None = None):
        if self.unpack_input_condition is not None:
            inputs, condition = self.unpack_input_condition(x)
        else:
            inputs, condition = x, None
        mu, logvar = self.encoder(inputs, condition, train=train)
        z = reparameterize(mu, logvar, _sampling_key(x, train, rng))
        recon = self.decoder(z, condition, train=train)
        packed = torch.cat([logvar, mu, recon.reshape(recon.shape[0], -1)], dim=1)
        return {"prediction": packed}, {"latent": z, "mu": mu, "logvar": logvar}


def unpack_vae_output(packed: torch.Tensor, latent_dim: int):
    """``[logvar | mu | flat recon]`` -> (recon, mu, logvar)."""
    logvar = packed[:, :latent_dim]
    mu = packed[:, latent_dim:2 * latent_dim]
    return packed[:, 2 * latent_dim:], mu, logvar


def kl_to_standard_normal(mu: torch.Tensor, logvar: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """``-0.5 * sum(1 + logvar - mu^2 - e^logvar)``, summed over the
    (valid) examples."""
    per_example = -0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar)).sum(dim=-1)
    if mask is not None:
        per_example = per_example * mask
    return per_example.sum()


def make_vae_loss(latent_dim: int, base_loss: Callable) -> Callable:
    """The VAE criterion ``(packed, targets, mask) -> base_loss(recon,
    targets, mask) + KL``; ``base_loss`` follows the engine's criterion
    contract."""

    def criterion(packed: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
        recon, mu, logvar = unpack_vae_output(packed, latent_dim)
        recon = recon.reshape(targets.shape)
        return base_loss(recon, targets, mask) + kl_to_standard_normal(mu, logvar, mask)

    return criterion


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------

@tree_dataclass
@dataclasses.dataclass(frozen=True)
class PcaState:
    components: torch.Tensor  # [d, k], the principal directions as columns
    singular_values: torch.Tensor  # [k]
    data_mean: torch.Tensor  # [d]


class PcaModule:
    """SVD-based PCA. ``low_rank`` keeps ``rank_estimation`` components
    after the (full) SVD, as JAX's does."""

    def __init__(self, low_rank: bool = False, full_svd: bool = False,
                 rank_estimation: int = 6):
        self.low_rank = low_rank
        self.full_svd = full_svd
        self.rank_estimation = rank_estimation

    @staticmethod
    def maybe_reshape(x: torch.Tensor) -> torch.Tensor:
        """Trailing axes flattened: ``[N, d]``."""
        return x.reshape(x.shape[0], -1)

    def fit(self, x: torch.Tensor, center_data: bool = True) -> PcaState:
        """The SVD of the (centred) data matrix."""
        x = self.maybe_reshape(x)
        mean = x.mean(dim=0)
        if center_data:
            x = x - mean
        _, s, vt = torch.linalg.svd(x, full_matrices=self.full_svd)
        components = vt.T
        if self.low_rank:
            k = min(self.rank_estimation, components.shape[1])
            components, s = components[:, :k], s[:k]
        return PcaState(components=components, singular_values=s, data_mean=mean)

    def project_lower_dim(self, state: PcaState, x: torch.Tensor,
                          k: int | None = None, center_data: bool = False) -> torch.Tensor:
        """``x @ U_k``."""
        x = self.maybe_reshape(x)
        if center_data:
            x = x - state.data_mean
        u = state.components if k is None else state.components[:, :k]
        return x @ u

    def project_back(self, state: PcaState, x_low: torch.Tensor,
                     add_mean: bool = False) -> torch.Tensor:
        """``x_low @ U_k^T`` (+ the mean)."""
        out = x_low @ state.components[:, :x_low.shape[1]].T
        return out + state.data_mean if add_mean else out

    def reconstruction_error(self, state: PcaState, x: torch.Tensor,
                             k: int | None = None, center_data: bool = False) -> torch.Tensor:
        """The mean squared reconstruction error an example."""
        x2d = self.maybe_reshape(x)
        back = self.project_back(state, self.project_lower_dim(state, x, k, center_data),
                                 add_mean=center_data)
        return ((x2d - back) ** 2).sum() / x2d.shape[0]

    def projection_variance(self, state: PcaState, x: torch.Tensor,
                            k: int | None = None, center_data: bool = False) -> torch.Tensor:
        """``||X U_k||_F^2 / N``."""
        low = self.project_lower_dim(state, x, k, center_data)
        return (low ** 2).sum() / low.shape[0]

    @staticmethod
    def explained_variance_ratios(state: PcaState) -> torch.Tensor:
        s2 = state.singular_values ** 2
        return s2 / s2.sum()

    @staticmethod
    def cumulative_explained_variance(state: PcaState) -> torch.Tensor:
        return (state.singular_values ** 2).sum()
