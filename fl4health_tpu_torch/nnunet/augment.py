"""On-device nnU-Net augmentation, per step and per example (counterpart of
``fl4health_tpu/nnunet/augment.py``).

The transform family and its defaults are the JAX package's (nnunetv2's
defaults): free-angle rotation (±30°, p 0.2) and isotropic scaling (0.7 to
1.4, p 0.2) as one resample of the patch grid, optional elastic
deformation (off), per-axis mirroring (p 0.5), a 90° rotation on a pair of
equal axes (p 0.5), Gaussian noise (variance U(0, 0.1), p 0.1), Gaussian
blur (p 0.2), brightness and contrast (0.75 to 1.25, p 0.15 each), low
resolution simulation (p 0.25) and gamma (0.7 to 1.5, retain stats; p 0.1
inverted, p 0.3 plain). Spatial transforms move the image and labels
together; the others touch the image only.

Every draw comes from ``rng.py`` under the keys JAX folds and splits, so
each decision is JAX's bit for bit; the noise goes through ``rng.normal``
(about 2 ulp from JAX's). The examples run under ``torch.func.vmap``
(inside the client vmap in the engine's step). JAX's ``lax.switch``
branches (the 90° rotations, the four low-resolution zooms) are
data-dependent under a vmap, so, as JAX's vmap does, every branch is
computed and one is selected with ``torch.where``.

The interpolation is written out as JAX's, not through ``grid_sample``
(whose normalisation of coordinates adds rounding):
- ``map_coordinates(order=1, mode="nearest")``: floor, the two taps'
  weights ``1 - f`` and ``f``, the indices (not the coordinates) clipped
  to the edge, the corners summed in ``itertools.product`` order;
  ``order=0`` rounds half away from zero, as ``lax.round`` does (not half
  to even, as ``torch.round``);
- ``jax.image.resize``: ``"nearest"`` takes ``floor((i + 0.5) * in / out)``
  (torch's ``nearest-exact``); ``"cubic"`` is Keys' kernel with a = -0.5
  at half-pixel centres, taps past the edge dropped and the weights
  renormalised (torch's bicubic is a = -0.75 with clamped edges, another
  function), applied a weight matrix an axis by ``tensordot``.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch

from fl4health_tpu_torch import rng


def _mirror_one(x, y, key, spatial_axes, p):
    """Flip each spatial axis w.p. ``p``, image and labels together (x
    ``[*spatial, C]``, y ``[*spatial]``)."""
    for i, ax in enumerate(spatial_axes):
        do = rng.bernoulli(rng.fold_in(key, i), p)
        x = torch.where(do, torch.flip(x, dims=(ax,)), x)
        y = torch.where(do, torch.flip(y, dims=(ax,)), y)
    return x, y


def _select(branches: list, index: torch.Tensor) -> torch.Tensor:
    """``branches[index]`` as a chain of selects."""
    out = branches[0]
    for j in range(1, len(branches)):
        out = torch.where(index == j, branches[j], out)
    return out


def _rot90_one(x, y, key, pairs, p):
    """A 90° rotation (k in 1..3) on a random pair of equal axes, w.p.
    ``p``."""
    if not pairs:
        return x, y
    do = rng.bernoulli(rng.fold_in(key, 0), p)
    pair_idx = rng.randint(rng.fold_in(key, 1), (), 0, len(pairs))
    k = rng.randint(rng.fold_in(key, 2), (), 1, 4)
    sel = pair_idx * 3 + (k - 1)
    xs = [torch.rot90(x, kk, dims=ax) for ax in pairs for kk in (1, 2, 3)]
    ys = [torch.rot90(y, kk, dims=ax) for ax in pairs for kk in (1, 2, 3)]
    return torch.where(do, _select(xs, sel), x), torch.where(do, _select(ys, sel), y)


def _noise_one(x, key, p, variance_max):
    """Additive Gaussian noise whose variance is drawn from U(0,
    ``variance_max``)."""
    do = rng.bernoulli(rng.fold_in(key, 0), p)
    var = rng.uniform(rng.fold_in(key, 1), (), 0.0, variance_max)
    noise = torch.sqrt(var) * rng.normal(rng.fold_in(key, 2), tuple(x.shape)).to(x.dtype)
    return torch.where(do, x + noise, x)


def _blur_one(x, key, p, sigma_lo=0.5, sigma_hi=1.0, radius=2):
    """Separable Gaussian blur, sigma ~ U(``sigma_lo``, ``sigma_hi``), a
    ``2 * radius + 1`` tap kernel, edges replicated."""
    do = rng.bernoulli(rng.fold_in(key, 0), p)
    sigma = rng.uniform(rng.fold_in(key, 1), (), sigma_lo, sigma_hi)
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=x.device)
    w = torch.exp(-0.5 * torch.square(offs / sigma))
    w = w / w.sum()
    out = x
    for ax in range(x.ndim - 1):  # spatial axes of [*spatial, C]
        n = x.shape[ax]
        acc = torch.zeros_like(out, dtype=torch.float32)
        for i in range(2 * radius + 1):
            idx = torch.clamp(torch.arange(n, device=x.device) + (i - radius), 0, n - 1)
            acc = acc + w[i] * out.index_select(ax, idx).float()
        out = acc
    return torch.where(do, out.to(x.dtype), x)


def _brightness_one(x, key, p, lo, hi):
    do = rng.bernoulli(rng.fold_in(key, 0), p)
    mult = rng.uniform(rng.fold_in(key, 1), (), lo, hi)
    return torch.where(do, x * mult, x)


def _amin(x, dims):
    return torch.amin(x, dim=dims, keepdim=True)


def _amax(x, dims):
    return torch.amax(x, dim=dims, keepdim=True)


def _contrast_one(x, key, p, lo, hi):
    """Scale about the per-channel mean, clipped to the channel's range."""
    do = rng.bernoulli(rng.fold_in(key, 0), p)
    factor = rng.uniform(rng.fold_in(key, 1), (), lo, hi)
    spatial = tuple(range(x.ndim - 1))
    mean = x.mean(dim=spatial, keepdim=True)
    scaled = torch.minimum(torch.maximum(mean + (x - mean) * factor, _amin(x, spatial)),
                           _amax(x, spatial))
    return torch.where(do, scaled, x)


def _gamma_one(x, key, p, lo, hi, invert):
    """Gamma on the patch rescaled to [0, 1] a channel and mapped back, the
    channel's mean and std restored (retain stats); ``invert`` applies it
    to the negated image."""
    do = rng.bernoulli(rng.fold_in(key, 0), p)
    gamma = rng.uniform(rng.fold_in(key, 1), (), lo, hi)
    spatial = tuple(range(x.ndim - 1))
    mean0 = x.mean(dim=spatial, keepdim=True)
    std0 = x.std(dim=spatial, keepdim=True, correction=0)
    xin = -x if invert else x
    mn, mx = _amin(xin, spatial), _amax(xin, spatial)
    span = torch.clamp(mx - mn, min=1e-7)
    out = torch.pow(torch.clamp((xin - mn) / span, min=1e-7), gamma) * span + mn
    if invert:
        out = -out
    mean1 = out.mean(dim=spatial, keepdim=True)
    std1 = out.std(dim=spatial, keepdim=True, correction=0)
    out = (out - mean1) / torch.clamp(std1, min=1e-7) * std0 + mean0
    return torch.where(do, out, x)


def _rotation_matrix(angles: torch.Tensor, nd: int) -> torch.Tensor:
    """``[nd, nd]`` rotation: one angle in 2-D; in 3-D ``Rz @ Ry @ Rx`` of
    three per-axis angles."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])
    mat = lambda rows: torch.stack([torch.stack(r) for r in rows])  # noqa: E731
    if nd == 2:
        return mat([[c[0], -s[0]], [s[0], c[0]]])
    rx = mat([[one, zero, zero], [zero, c[0], -s[0]], [zero, s[0], c[0]]])
    ry = mat([[c[1], zero, s[1]], [zero, one, zero], [-s[1], zero, c[1]]])
    rz = mat([[c[2], -s[2], zero], [s[2], c[2], zero], [zero, zero, one]])
    return rz @ ry @ rx


def _round_half_away(c: torch.Tensor) -> torch.Tensor:
    """``lax.round``: to the nearest integer, ties away from zero."""
    t = torch.trunc(c)
    return torch.where(torch.abs(c - t) == 0.5, t + torch.sign(c), torch.round(c))


def map_coordinates(x: torch.Tensor, coords: Sequence[torch.Tensor], order: int) -> torch.Tensor:
    """``jax.scipy.ndimage.map_coordinates(x, coords, order,
    mode="nearest")`` for ``order`` 0 or 1: ``x`` sampled at ``coords`` (a
    coordinate array an axis of ``x``), the indices clipped to the edge."""
    taps = []
    for c, size in zip(coords, x.shape):
        if order == 0:
            taps.append([(_round_half_away(c).to(torch.int64), None)])
        else:
            lower = torch.floor(c)
            upper_w = c - lower
            i = lower.to(torch.int64)
            taps.append([(i, 1 - upper_w), (i + 1, upper_w)])
        taps[-1] = [(torch.clamp(i, 0, size - 1), w) for i, w in taps[-1]]
    out = None
    for corner in itertools.product(*taps):
        value = x[tuple(i for i, _ in corner)]
        weights = [w for _, w in corner if w is not None]
        if weights:
            prod = weights[0]
            for w in weights[1:]:
                prod = prod * w
            value = prod * value
        out = value if out is None else out + value
    if not x.is_floating_point():
        out = _round_half_away(out) if out.is_floating_point() else out
    return out.to(x.dtype)


def _spatial_resample_one(x, y, key, p_rotation, p_scaling, rot_max_rad, scale_lo, scale_hi,
                          p_elastic, elastic_alpha):
    """Free-angle rotation and isotropic scaling (and the optional elastic
    field) of one example by one resample of the patch grid: output voxel
    ``p`` samples the input at ``center + s R (p - center)``; the image
    linearly (order 1), the labels by nearest (order 0)."""
    spatial = tuple(y.shape)
    nd = len(spatial)
    do_rot = rng.bernoulli(rng.fold_in(key, 0), p_rotation)
    do_scale = rng.bernoulli(rng.fold_in(key, 1), p_scaling)
    angles = rng.uniform(rng.fold_in(key, 2), (1 if nd == 2 else 3,),
                         -rot_max_rad, rot_max_rad) * do_rot
    scale = torch.where(do_scale, rng.uniform(rng.fold_in(key, 3), (), scale_lo, scale_hi),
                        1.0)
    rot = _rotation_matrix(angles, nd)
    dev = x.device
    center = torch.tensor([(s - 1) / 2.0 for s in spatial], dtype=torch.float32,
                          device=dev).reshape((nd,) + (1,) * nd)
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=dev) for s in spatial], indexing="ij"))
    mapped = scale * torch.tensordot(rot, grid - center, dims=1) + center
    do_elastic = rng.bernoulli(rng.fold_in(key, 4), p_elastic)
    if p_elastic > 0.0:
        coarse = rng.normal(rng.fold_in(key, 5), (nd,) + (4,) * nd)
        alpha = rng.uniform(rng.fold_in(key, 6), (), 0.0, elastic_alpha)
        disp = resize(coarse, (nd, *spatial), "linear")
        mapped = mapped + do_elastic * alpha * disp
    coords = [mapped[i] for i in range(nd)]
    x_out = torch.stack([map_coordinates(x[..., c], coords, 1) for c in range(x.shape[-1])],
                        dim=-1).to(x.dtype)
    y_out = map_coordinates(y, coords, 0)
    fired = do_rot | do_scale
    if p_elastic > 0.0:
        fired = fired | do_elastic
    return torch.where(fired, x_out, x), torch.where(fired, y_out, y)


def _keys_cubic(t: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5, as ``jax.image``'s."""
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, 0.0, out)


def _triangle(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - t, min=0.0)


def _weight_matrix(in_size: int, out_size: int, kernel, device) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` ``[in, out]`` in f32 for a
    resize with no translation, upsampling or downsampling (antialiased: the
    kernel widened by the scale when shrinking)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(float(inv_scale), 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
        * float(inv_scale) - 0.5
    t = torch.abs(sample[None, :] - torch.arange(in_size, dtype=torch.float32,
                                                 device=device)[:, None]) / kernel_scale
    w = kernel(t)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for ``"nearest"``,
    ``"linear"`` and ``"cubic"`` (antialiased, as its default)."""
    shape = tuple(int(s) for s in shape)
    if method == "nearest":
        for d, (m, n) in enumerate(zip(x.shape, shape)):
            if m != n:
                idx = torch.floor((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5)
                                  * m / n).to(torch.int64)
                x = x.index_select(d, idx)
        return x
    kernel = {"cubic": _keys_cubic, "linear": _triangle}[method]
    out = x.float() if not x.is_floating_point() else x
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m != n:
            w = _weight_matrix(m, n, kernel, x.device).to(out.dtype)
            out = torch.movedim(torch.tensordot(out, w, dims=([d], [0])), -1, d)
    return out


# The low-resolution simulation's zooms: JAX's lax.switch needs static
# shapes, so the continuous U(0.5, 1) zoom is a choice from this set
_LOWRES_ZOOMS = (0.5, 0.65, 0.8, 0.95)


def _lowres_one(x, key, p):
    """Nearest-downsample by a random zoom and cubic-upsample back (image
    only), each zoom a branch, one selected."""
    do = rng.bernoulli(rng.fold_in(key, 0), p)
    zi = rng.randint(rng.fold_in(key, 1), (), 0, len(_LOWRES_ZOOMS))
    spatial = x.shape[:-1]
    branches = []
    for z in _LOWRES_ZOOMS:
        small = tuple(max(int(round(s * z)), 1) for s in spatial)
        down = resize(x, small + (x.shape[-1],), "nearest")
        branches.append(resize(down, tuple(x.shape), "cubic").to(x.dtype))
    return torch.where(do, _select(branches, zi), x)


def _isotropic_pairs(spatial_shape: Sequence[int]) -> tuple:
    """Pairs of spatial axes of equal size."""
    nd = len(spatial_shape)
    return tuple((i, j) for i in range(nd) for j in range(i + 1, nd)
                 if spatial_shape[i] == spatial_shape[j])


def augment_patch_batch(
    x: torch.Tensor, y: torch.Tensor, key: torch.Tensor,
    p_mirror: float = 0.5, p_rot90: float = 0.5, p_noise: float = 0.1,
    p_brightness: float = 0.15, p_contrast: float = 0.15, p_gamma: float = 0.3,
    p_gamma_invert: float = 0.1, p_rotation: float = 0.2, p_scaling: float = 0.2,
    rot_max_deg: float = 30.0, scale_lo: float = 0.7, scale_hi: float = 1.4,
    p_elastic: float = 0.0, elastic_alpha: float = 8.0, p_lowres: float = 0.25,
    p_blur: float = 0.2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Augment one batch, x ``[B, *spatial, C]`` float and y ``[B,
    *spatial]`` int, every decision drawn per example from ``split(key,
    B)``, in nnunetv2's order: the resample, mirror, 90° rotation, noise,
    blur, brightness, contrast, low resolution, inverted gamma, gamma."""
    spatial = tuple(x.shape[1:-1])
    pairs = _isotropic_pairs(spatial)
    spatial_axes = tuple(range(len(spatial)))
    interp_on = p_rotation > 0.0 or p_scaling > 0.0 or p_elastic > 0.0
    rot_max_rad = rot_max_deg * math.pi / 180.0

    def one(xe, ye, k):
        keys = rng.split(k, 10)
        if interp_on:
            xe, ye = _spatial_resample_one(xe, ye, keys[7], p_rotation, p_scaling,
                                           rot_max_rad, scale_lo, scale_hi, p_elastic,
                                           elastic_alpha)
        xe, ye = _mirror_one(xe, ye, keys[0], spatial_axes, p_mirror)
        xe, ye = _rot90_one(xe, ye, keys[1], pairs, p_rot90)
        xe = _noise_one(xe, keys[2], p_noise, 0.1)
        xe = _blur_one(xe, keys[9], p_blur)
        xe = _brightness_one(xe, keys[3], p_brightness, 0.75, 1.25)
        xe = _contrast_one(xe, keys[4], p_contrast, 0.75, 1.25)
        if p_lowres > 0.0:
            xe = _lowres_one(xe, keys[8], p_lowres)
        xe = _gamma_one(xe, keys[5], p_gamma_invert, 0.7, 1.5, invert=True)
        xe = _gamma_one(xe, keys[6], p_gamma, 0.7, 1.5, invert=False)
        return xe, ye

    return torch.func.vmap(one)(x, y, rng.split(key, x.shape[0]))
