"""Maximum-mean-discrepancy losses (counterpart of
``fl4health_tpu/losses/mmd.py``): multi-kernel MK-MMD with its beta QP, and
the deep-kernel MMD with its learned featurizer.

- MK-MMD is ``betas . hat_d`` over a bank of 19 RBF kernels; the kernel
  weights are re-optimised by JAX's on-device QP: one linear solve as the
  warm start, then 100 projected-gradient steps, each projected onto ``{b
  >= 0, d^T b = 1}`` by 40 alternating projections, and the reference's
  clamp-and-normalise tail. Every branch is a ``torch.where``, so the QP
  runs unchanged under the client vmap (JAX computes it under a batched
  ``lax.cond`` there, both branches, and selects).
- The deep-kernel MMD keeps its featurizer, ``log_epsilon`` and the two
  bandwidth roots in a ``DeepMmdState`` (a ``Params`` dict keyed by flax
  path, ``featurizer/Dense_0/kernel``, and ``optim.adamw``'s state);
  ``train_step`` ascends the MMD t-statistic on a permuted pairing drawn
  from ``rng.permutation``.

Every statistic takes an optional ``[n]`` example mask: padded rows of a
ragged batch contribute nothing. The featurizer's init draws from a
``torch.Generator`` seeded from the key's words, not flax's init: parity
tests install the converted flax state (``models/convert.py``
``deep_mmd_state_to_torch``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from fl4health_tpu_torch import optim, rng
from fl4health_tpu_torch.core.pytree import tree_dataclass
from fl4health_tpu_torch.core.types import Params
from fl4health_tpu_torch.models.cnn import _init_params
from fl4health_tpu_torch.models.transformer import LoraDense


def default_gammas(device: str | torch.device = "cpu") -> torch.Tensor:
    """``2^[-3.5 : 1 : 0.25]``, the reference's 19-kernel bank."""
    return torch.pow(2.0, torch.arange(-3.5, 1.25, 0.25, dtype=torch.float32,
                                       device=device))


def uniform_betas(n_kernels: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Unit-sum kernel weights, ``1 / n_kernels`` each."""
    return torch.full((n_kernels,), 1.0 / n_kernels, dtype=torch.float32, device=device)


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``||a_i - b_j||^2``, clamped at 0."""
    d = ((a ** 2).sum(dim=1)[:, None] + (b ** 2).sum(dim=1)[None, :]
         - 2.0 * (a @ b.T))
    return torch.clamp(d, min=0.0)


def _normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=eps)


def _all_h_u(x: torch.Tensor, y: torch.Tensor, gammas: torch.Tensor) -> torch.Tensor:
    """The h-statistic per kernel over all sample pairs -> ``[K, n, n]``:
    ``u(x_j, x_k) + u(y_j, y_k) - u(x_j, y_k) - u(y_j, x_k)``, ``u =
    exp(-||.||^2 / gamma)``."""
    ip = torch.stack([_sq_dists(x, x), _sq_dists(y, y), _sq_dists(x, y), _sq_dists(y, x)])
    e = torch.exp(-ip[None] / gammas[:, None, None, None])  # [K, 4, n, n]
    return e[:, 0] + e[:, 1] - e[:, 2] - e[:, 3]


def _all_h_u_linear(x: torch.Tensor, y: torch.Tensor, gammas: torch.Tensor) -> torch.Tensor:
    """The linear-time h-statistic over quadruples ``[x_{2i-1}, x_{2i},
    y_{2i-1}, y_{2i}]`` -> ``[K, n // 2]``."""
    n = (x.shape[0] // 2) * 2
    x, y = x[:n], y[:n]
    x0, x1, y0, y1 = x[0::2], x[1::2], y[0::2], y[1::2]
    ip = torch.stack([((x0 - x1) ** 2).sum(dim=1), ((y0 - y1) ** 2).sum(dim=1),
                      ((x0 - y1) ** 2).sum(dim=1), ((x1 - y0) ** 2).sum(dim=1)])
    e = torch.exp(-ip[None] / gammas[:, None, None])  # [K, 4, n // 2]
    return e[:, 0] + e[:, 1] - e[:, 2] - e[:, 3]


def _pair_weights(mask: torch.Tensor | None, n: int, device=None) -> torch.Tensor:
    """``[n, n]`` pair validity from an ``[n]`` example mask (all ones when
    None)."""
    if mask is None:
        return torch.ones((n, n), dtype=torch.float32, device=device)
    m = mask.to(torch.float32)
    return m[:, None] * m[None, :]


def _quad_weights(mask: torch.Tensor | None, n_half: int, device=None) -> torch.Tensor:
    """``[n // 2]`` quadruple validity: all four members real samples."""
    if mask is None:
        return torch.ones((n_half,), dtype=torch.float32, device=device)
    m = mask.to(torch.float32)
    n = n_half * 2
    return m[:n:2] * m[1:n:2]


def _hat_d(all_h_u: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Per-kernel MMD estimate, the (weighted) mean over the sample axes ->
    ``[K]``."""
    flat = all_h_u.reshape(all_h_u.shape[0], -1)
    if weights is None:
        return flat.mean(dim=1)
    w = weights.reshape(-1)
    return (flat @ w) / torch.clamp(w.sum(), min=1e-12)


def _hat_q_full(all_h_u: torch.Tensor, hat_d: torch.Tensor,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """The kernels' covariance ``Q`` ``[K, K]`` from the full h-statistic,
    with the ``n^2 - 1`` correction."""
    k, n, _ = all_h_u.shape
    flat = (all_h_u - hat_d[:, None, None]).reshape(k, -1)
    if weights is None:
        return (flat @ flat.T) / (n * n - 1.0)
    w = weights.reshape(-1)
    flat = flat * w[None, :]
    return (flat @ flat.T) / torch.clamp(w.sum() - 1.0, min=1.0)


def _hat_q_linear(all_h_u_lin: torch.Tensor,
                  quad_w: torch.Tensor | None = None) -> torch.Tensor:
    """``Q`` from paired quadruple differences (the linear variant)."""
    k, n_vi = all_h_u_lin.shape
    w = (n_vi // 2) * 2
    pairs = all_h_u_lin[:, :w].reshape(k, w // 2, 2)
    delta = pairs[:, :, 0] - pairs[:, :, 1]  # [K, W]
    if quad_w is None:
        return (delta @ delta.T) / delta.shape[1]
    qw = quad_w[:w].reshape(w // 2, 2)
    pw = qw[:, 0] * qw[:, 1]
    delta = delta * pw[None, :]
    return (delta @ delta.T) / torch.clamp(pw.sum(), min=1.0)


def _statistics(x: torch.Tensor, y: torch.Tensor, gammas: torch.Tensor,
                normalize_features: bool, linear: bool, mask: torch.Tensor | None):
    """(h, weights) of the full or the linear estimator."""
    if normalize_features:
        x, y = _normalize_rows(x), _normalize_rows(y)
    if linear:
        h_u = _all_h_u_linear(x, y, gammas)
        return h_u, (_quad_weights(mask, h_u.shape[1]) if mask is not None else None)
    h_u = _all_h_u(x, y, gammas)
    return h_u, (_pair_weights(mask, x.shape[0]) if mask is not None else None)


def mkmmd(
    x: torch.Tensor,
    y: torch.Tensor,
    betas: torch.Tensor,
    gammas: torch.Tensor | None = None,
    normalize_features: bool = False,
    linear: bool = False,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """MK-MMD(x, y) = ``betas . hat_d``. ``mask`` is a 0/1 example validity
    shared by the paired batches ``x`` and ``y``."""
    gammas = default_gammas(x.device) if gammas is None else gammas
    h_u, w = _statistics(x, y, gammas, normalize_features, linear, mask)
    return (betas * _hat_d(h_u, w)).sum()


def _one_hot(idx: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot`` of a 0-d index, as a comparison (vmappable)."""
    return (torch.arange(k, device=idx.device) == idx).to(dtype)


def _project_simplex_like(z: torch.Tensor, d: torch.Tensor, iters: int = 40) -> torch.Tensor:
    """``z`` projected onto ``{b >= 0, d^T b = 1}`` by ``iters`` alternating
    projections (the hyperplane, then the orthant)."""
    dd = torch.clamp(torch.dot(d, d), min=1e-12)
    for _ in range(iters):
        z = torch.clamp(z + (1.0 - torch.dot(d, z)) / dd * d, min=0.0)
    return z


def optimize_betas(
    x: torch.Tensor,
    y: torch.Tensor,
    gammas: torch.Tensor | None = None,
    lambda_m: float = 1e-5,
    minimize_type_two_error: bool = True,
    normalize_features: bool = False,
    linear: bool = False,
    pg_steps: int = 100,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Re-optimised kernel weights, on the tensors' device.

    ``minimize_type_two_error``: the QP ``min b^T (2Q + lambda I) b`` s.t.
    ``b^T d = 1, b >= 0``, warm-started at the equality-constrained closed
    form; otherwise the best vertex ``e_i / d_i`` of the polytope. With no
    positive ``hat_d``, one-hot at the extreme ``d_k / R_kk``. The result is
    clamped at 0 and normalised to unit sum."""
    gammas = default_gammas(x.device) if gammas is None else gammas
    h_u, w = _statistics(x, y, gammas, normalize_features, linear, mask)
    d = _hat_d(h_u, w)
    q_k = _hat_q_linear(h_u, w) if linear else _hat_q_full(h_u, d, w)
    k = d.shape[0]
    reg_q = 2.0 * q_k + lambda_m * torch.eye(k, dtype=q_k.dtype, device=q_k.device)

    # the fallback: no positive hat_d -> a single extreme kernel
    base_values = d / torch.clamp(torch.diagonal(reg_q), min=1e-12)
    extreme = (torch.argmax(base_values) if minimize_type_two_error
               else torch.argmin(base_values))
    beta_extreme = _one_hot(extreme, k, d.dtype)

    if minimize_type_two_error:
        # the equality-constrained closed form as the warm start, b ∝ R^{-1} d
        b0 = torch.linalg.solve(reg_q, d)
        denom = torch.dot(d, b0)
        b0 = torch.where(denom.abs() > 1e-12, b0 / denom, torch.full_like(b0, 1.0 / k))
        b = _project_simplex_like(b0, d)
        eta = 1.0 / (torch.linalg.matrix_norm(reg_q) + 1e-12)
        for _ in range(pg_steps):
            b = _project_simplex_like(b - eta * (reg_q @ b), d)
        beta_opt = b
    else:
        # the best vertex e_i / d_i for the convex maximisation
        verts = 1.0 / torch.where(d.abs() > 1e-12, d, torch.full_like(d, 1e-12))
        best = torch.argmax(torch.diagonal(reg_q) * verts ** 2)
        beta_opt = _one_hot(best, k, d.dtype) * verts

    raw = torch.where((d > 0).any(), beta_opt, beta_extreme)
    # the reference's tail: clamp at 0, normalise to unit sum
    raw = torch.clamp(raw, min=0.0)
    total = raw.sum()
    return torch.where(total > 1e-12, raw / total, torch.full_like(raw, 1.0 / k))


# ---------------------------------------------------------------------------
# Deep-kernel MMD
# ---------------------------------------------------------------------------

class DeepKernelNet(nn.Module):
    """The learned kernel's featurizer: three softplus Dense layers of
    ``hidden_size``, then a linear Dense of ``output_size`` (flax names
    ``Dense_0``..``Dense_3``, kernels ``[in, out]``)."""

    def __init__(self, input_size: int, hidden_size: int = 10, output_size: int = 50):
        super().__init__()
        widths = [input_size, hidden_size, hidden_size, hidden_size, output_size]
        for i in range(4):
            setattr(self, f"Dense_{i}", LoraDense(widths[i], widths[i + 1], dtype=None))

    def init_params(self, generator: torch.Generator) -> Params:
        return _init_params(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = F.softplus(getattr(self, f"Dense_{i}")(x))
        return self.Dense_3(x)


@tree_dataclass
@dataclasses.dataclass(frozen=True)
class DeepMmdState:
    """The learned kernel in a client's persistent state: ``params`` keyed
    ``featurizer/...``, ``log_epsilon``, ``sigma_q_root``,
    ``sigma_phi_root``; ``opt_state`` is ``optim.adamw``'s."""

    params: Params
    opt_state: Any


def _key_generator(key: torch.Tensor) -> torch.Generator:
    """A CPU generator seeded from a threefry key's two words."""
    words = [int(w) for w in key.cpu()]
    return torch.Generator().manual_seed((words[0] << 32) | words[1])


class DeepMmd:
    """Deep-kernel MMD with the reference's training protocol: ``value`` is
    the unbiased MMD estimate through the current kernel (a constant to the
    gradient), ``train_step`` one adamw step ascending ``MMD^2 /
    sqrt(Var)``, ``train`` ``optimization_steps`` of them."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int = 10,
        output_size: int = 50,
        lr: float = 0.001,
        is_unbiased: bool = True,
        gaussian_degree: int = 1,
        optimization_steps: int = 5,
    ):
        self.net = DeepKernelNet(input_size, hidden_size, output_size)
        self.input_size = input_size
        self.tx = optim.adamw(lr)
        self.is_unbiased = is_unbiased
        self.gaussian_degree = gaussian_degree
        self.optimization_steps = optimization_steps

    def init(self, key: torch.Tensor) -> DeepMmdState:
        """A fresh kernel on the key's device: the featurizer from a
        generator seeded by the first split key's words, ``log_epsilon`` as
        JAX draws it (``log(U(0,1) * 1e-10 + 1e-30)`` from the second)."""
        k_net, k_eps = rng.split(key)
        device = key.device
        featurizer = self.net.init_params(_key_generator(k_net))
        params = {f"featurizer/{k}": v.to(device) for k, v in featurizer.items()}
        params["log_epsilon"] = torch.log(rng.uniform(k_eps, (1,)) * 1e-10 + 1e-30)
        params["sigma_q_root"] = torch.sqrt(torch.tensor([2.0 * 32 * 32], device=device))
        params["sigma_phi_root"] = torch.sqrt(torch.tensor([0.005], device=device))
        return DeepMmdState(params=params, opt_state=self.tx.init(params))

    def _featurize(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        named = {k[len("featurizer/"):].replace("/", "."): v for k, v in params.items()
                 if k.startswith("featurizer/")}
        return functional_call(self.net, named, (x,))

    def _mmd_and_var(self, params: Params, x: torch.Tensor, y: torch.Tensor,
                     with_var: bool, mask: torch.Tensor | None = None):
        """The deep-kernel MMD estimate (and its variance); ``mask``
        excludes padded rows, shared by the paired batches."""
        nx = x.shape[0]
        feats = self._featurize(params, torch.cat([x, y], dim=0))
        fx, fy = feats[:nx], feats[nx:]
        eps = torch.sigmoid(params["log_epsilon"][0])
        sigma_q = params["sigma_q_root"][0] ** 2
        sigma_phi = params["sigma_phi_root"][0] ** 2

        def kernel(da, db):
            # da: deep-feature distances, db: input distances
            smooth = (1.0 - eps) * torch.exp(
                -((da / sigma_phi) ** self.gaussian_degree) - db / sigma_q)
            return smooth + eps * torch.exp(-db / sigma_q)

        pw = _pair_weights(mask, nx, x.device)
        m = (torch.ones((nx,), dtype=torch.float32, device=x.device) if mask is None
             else mask.to(torch.float32))
        n_valid = torch.clamp(m.sum(), min=2.0)

        k_x = kernel(_sq_dists(fx, fx), _sq_dists(x, x)) * pw
        k_y = kernel(_sq_dists(fy, fy), _sq_dists(y, y)) * pw
        k_xy = kernel(_sq_dists(fx, fy), _sq_dists(x, y)) * pw
        if self.is_unbiased:
            denom = n_valid * (n_valid - 1)
            xx = (k_x.sum() - torch.diagonal(k_x).sum()) / denom
            yy = (k_y.sum() - torch.diagonal(k_y).sum()) / denom
            xy = (k_xy.sum() - torch.diagonal(k_xy).sum()) / denom
        else:
            denom = n_valid * n_valid
            xx, yy, xy = k_x.sum() / denom, k_y.sum() / denom, k_xy.sum() / denom
        mmd2 = xx - 2.0 * xy + yy
        if not with_var:
            return mmd2, None
        h = k_x + k_y - k_xy - k_xy.T
        row = h.sum(dim=1)
        v1 = (4.0 / n_valid ** 3) * torch.dot(row, row)
        v2 = (4.0 / n_valid ** 4) * h.sum() ** 2
        return mmd2, v1 - v2 + 1e-8

    def value(self, state: DeepMmdState, x: torch.Tensor, y: torch.Tensor,
              mask: torch.Tensor | None = None) -> torch.Tensor:
        """The MMD through the current kernel; gradients reach ``x`` and
        ``y`` only."""
        params = {k: v.detach() for k, v in state.params.items()}
        return self._mmd_and_var(params, x, y, with_var=False, mask=mask)[0]

    def train_step(self, state: DeepMmdState, x: torch.Tensor, y: torch.Tensor,
                   key: torch.Tensor, mask: torch.Tensor | None = None) -> DeepMmdState:
        """One ascent step on ``J = MMD^2 / sqrt(Var)``, ``y`` (and its mask
        row for row) permuted by ``rng.permutation(key, n)``."""
        x, y = x.detach(), y.detach()
        perm = rng.permutation(key, y.shape[0])
        y = y[perm]
        joint = None if mask is None else mask * mask[perm]  # rows valid on both sides

        def stat(params):
            mmd2, var = self._mmd_and_var(params, x, y, with_var=True, mask=joint)
            return -mmd2 / torch.sqrt(torch.clamp(var, min=1e-12))

        grads = torch.func.grad(stat)(state.params)
        updates, new_opt = self.tx.update(grads, state.opt_state, state.params)
        return DeepMmdState(params=optim.apply_updates(state.params, updates),
                            opt_state=new_opt)

    def train(self, state: DeepMmdState, x: torch.Tensor, y: torch.Tensor,
              key: torch.Tensor, mask: torch.Tensor | None = None) -> DeepMmdState:
        """``optimization_steps`` kernel updates, one key each from
        ``split(key, optimization_steps)``."""
        keys = rng.split(key, self.optimization_steps)
        for i in range(self.optimization_steps):
            state = self.train_step(state, x, y, keys[i], mask)
        return state
