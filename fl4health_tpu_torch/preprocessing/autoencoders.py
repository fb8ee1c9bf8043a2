"""Autoencoder data plumbing (counterpart of
``fl4health_tpu/preprocessing/autoencoders.py``): the dataset converter and
the dimensionality-reduction processors.

- ``AutoEncoderDatasetConverter`` rewires a supervised ``(x, y)`` dataset
  for self-supervised training: the target becomes the input, and an
  optional condition (a fixed vector, or the label, optionally one-hot) is
  packed into the input; ``get_unpacking_function`` gives the matching
  split for ``ConditionalVae``.
- ``AeProcessor``, ``VaeProcessor``, ``CvaeFixedConditionProcessor`` and
  ``CvaeVariableConditionProcessor`` map samples into a trained encoder's
  latent space; the VAE processors draw their noise from a threefry key
  ``rng.PRNGKey(seed)``, split once a call as JAX's processors split theirs
  (``models/autoencoders.py`` ``reparameterize``).
- ``PcaPreprocessor`` reduces dimension through saved principal components.

Whole stacked datasets go through one tensor op each.
"""

from __future__ import annotations

from typing import Callable

import torch

from fl4health_tpu_torch import rng
from fl4health_tpu_torch.models.autoencoders import PcaModule, PcaState, reparameterize


class AutoEncoderDatasetConverter:
    """Pack ``(x, y)`` into autoencoder training form. ``condition``: None
    (AE, VAE), ``"label"`` (the label as condition, optionally one-hot) or a
    fixed 1-D tensor shared by every sample."""

    def __init__(self, condition: str | torch.Tensor | None = None,
                 do_one_hot_encoding: bool = False,
                 custom_converter: Callable | None = None,
                 condition_vector_size: int | None = None):
        self.condition = condition
        self.do_one_hot_encoding = do_one_hot_encoding
        self.custom_converter = custom_converter
        self._condition_vector_size = condition_vector_size
        self.data_shape: tuple[int, ...] | None = None
        self._n_classes: int | None = None
        if custom_converter is not None and condition_vector_size is None:
            raise ValueError("condition_vector_size is required with a custom converter")

    def get_condition_vector_size(self) -> int:
        if self._condition_vector_size is not None:
            return self._condition_vector_size
        if self.condition is None:
            return 0
        if isinstance(self.condition, str) and self.condition == "label":
            if self._n_classes is None:
                raise RuntimeError("convert_dataset must run before the size is known")
            return self._n_classes
        return int(torch.as_tensor(self.condition).shape[0])

    def convert_dataset(self, x: torch.Tensor, y: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (packed inputs, targets = the original ``x``)."""
        self.data_shape = tuple(x.shape[1:])
        if self.custom_converter is not None:
            return self.custom_converter(x, y)
        flat = x.reshape(x.shape[0], -1)
        if self.condition is None:
            return x, x
        if isinstance(self.condition, str) and self.condition == "label":
            if self.do_one_hot_encoding:
                self._n_classes = int(y.max()) + 1
                cond = (y[:, None] == torch.arange(self._n_classes, device=y.device)).float()
            else:
                cond = y.reshape(y.shape[0], -1)
                self._n_classes = cond.shape[1]
        else:
            c = torch.as_tensor(self.condition, device=x.device)
            cond = c[None, :].expand(x.shape[0], c.shape[0])
        dtype = torch.result_type(flat, cond)
        return torch.cat([flat.to(dtype), cond.to(dtype)], dim=1), x

    def get_unpacking_function(self) -> Callable[[torch.Tensor],
                                                 tuple[torch.Tensor, torch.Tensor]]:
        """The split of packed inputs into (data, condition)."""
        cond_size = self.get_condition_vector_size()
        data_shape = self.data_shape

        def unpack(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
            if cond_size == 0:
                return packed, torch.zeros((packed.shape[0], 0), dtype=packed.dtype,
                                           device=packed.device)
            data = packed[:, :-cond_size].reshape(packed.shape[0], *data_shape)
            return data, packed[:, -cond_size:]

        return unpack


class _Sampler:
    """A threefry key split once a sampling call."""

    def __init__(self, return_mu_only: bool, seed: int):
        self.return_mu_only = return_mu_only
        self._rng = rng.PRNGKey(seed)

    def _latent(self, mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
        if self.return_mu_only:
            return mu
        self._rng, sub = rng.split(self._rng)
        return reparameterize(mu, logvar, sub.to(mu.device))


class AeProcessor:
    """A sample -> ``encoder(sample)``."""

    def __init__(self, encode_fn: Callable[[torch.Tensor], torch.Tensor]):
        self.encode_fn = encode_fn

    def __call__(self, sample: torch.Tensor) -> torch.Tensor:
        return self.encode_fn(sample)


class VaeProcessor(_Sampler):
    """A VAE's latent: mu, or ``mu + eps * std`` where not
    ``return_mu_only``."""

    def __init__(self, encode_fn: Callable, return_mu_only: bool = False, seed: int = 0):
        super().__init__(return_mu_only, seed)
        self.encode_fn = encode_fn

    def __call__(self, sample: torch.Tensor) -> torch.Tensor:
        return self._latent(*self.encode_fn(sample))


class CvaeFixedConditionProcessor(_Sampler):
    """A CVAE's latent under one condition for every sample."""

    def __init__(self, encode_fn: Callable, condition: torch.Tensor,
                 return_mu_only: bool = False, seed: int = 0):
        super().__init__(return_mu_only, seed)
        self.encode_fn = encode_fn
        self.condition = condition

    def __call__(self, sample: torch.Tensor) -> torch.Tensor:
        cond = self.condition[None, :].expand(sample.shape[0], self.condition.shape[0])
        return self._latent(*self.encode_fn(sample, cond))


class CvaeVariableConditionProcessor(_Sampler):
    """A CVAE's latent under a condition a sample."""

    def __init__(self, encode_fn: Callable, return_mu_only: bool = False, seed: int = 0):
        super().__init__(return_mu_only, seed)
        self.encode_fn = encode_fn

    def __call__(self, sample: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        return self._latent(*self.encode_fn(sample, condition))


class PcaPreprocessor:
    """Dimensionality reduction through saved principal components."""

    def __init__(self, pca_state: PcaState, pca_module: PcaModule | None = None):
        self.state = pca_state
        self.module = pca_module or PcaModule()

    def reduce_dimension(self, x: torch.Tensor, new_dimension: int,
                         center_data: bool = False) -> torch.Tensor:
        return self.module.project_lower_dim(self.state, x, new_dimension, center_data)
