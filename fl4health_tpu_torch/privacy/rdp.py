"""Renyi-DP accounting for the Poisson-subsampled Gaussian mechanism — pure
math (the port's own copy of ``fl4health_tpu/privacy/rdp.py``, the parts the
instance-level accountant uses; float64 numpy/scipy on the host).

- RDP of the Poisson-subsampled Gaussian mechanism at integer and fractional
  orders alpha, per Mironov, Talwar & Zhang, "Renyi Differential Privacy of the
  Sampled Gaussian Mechanism" (2019), Sec. 3.3 (the stable log-space series).
- Conversion RDP -> (epsilon, delta) with the improved bound of
  Canonne-Kairouz-Steinke / Balle et al., and RDP -> delta at fixed epsilon.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np
from scipy import special


def default_orders() -> list[float]:
    """Reference default moment orders (moments_accountant.py:85-88)."""
    low = [1.25, 1.5, 1.75, 2.0, 2.25, 2.5, 3.0, 3.5, 4.0, 4.5]
    medium = [float(x) for x in range(5, 64)]
    high = [128.0, 256.0, 512.0]
    return low + medium + high


# ---------------------------------------------------------------------------
# log-space helpers
# ---------------------------------------------------------------------------

def _log_add(a: float, b: float) -> float:
    if a == -np.inf:
        return b
    if b == -np.inf:
        return a
    hi, lo = max(a, b), min(a, b)
    return hi + math.log1p(math.exp(lo - hi))


def _log_sub(a: float, b: float) -> float:
    """log(exp(a) - exp(b)); requires a >= b."""
    if b == -np.inf:
        return a
    if a == b:
        return -np.inf
    return a + math.log1p(-math.exp(b - a))


def _log_erfc(x: float) -> float:
    """log(erfc(x)), stable for large x: erfc(x) = 2 * Phi(-sqrt(2) x)."""
    return math.log(2.0) + special.log_ndtr(-x * math.sqrt(2.0))


def _log_comb(n: float, k: int) -> float:
    return (
        special.gammaln(n + 1) - special.gammaln(k + 1) - special.gammaln(n - k + 1)
    )


# ---------------------------------------------------------------------------
# RDP of the sampled Gaussian mechanism
# ---------------------------------------------------------------------------

def _log_a_int(q: float, sigma: float, alpha: int) -> float:
    """log E_{k~Bin(alpha,q)}[exp(k(k-1)/(2 sigma^2))] — exact for integer alpha."""
    log_a = -np.inf
    for i in range(alpha + 1):
        log_coef = (
            _log_comb(alpha, i)
            + i * math.log(q)
            + (alpha - i) * math.log1p(-q)
        )
        log_a = _log_add(log_a, log_coef + (i * i - i) / (2.0 * sigma**2))
    return log_a


def _log_a_frac(q: float, sigma: float, alpha: float) -> float:
    """Fractional-order series (Mironov et al. 2019, Sec 3.3), log-space."""
    log_a0, log_a1 = -np.inf, -np.inf
    z0 = sigma**2 * math.log(1.0 / q - 1.0) + 0.5
    i = 0
    while True:
        coef = special.binom(alpha, i)
        log_coef = math.log(abs(coef)) if coef != 0 else -np.inf
        j = alpha - i

        log_t0 = log_coef + i * math.log(q) + j * math.log1p(-q)
        log_t1 = log_coef + j * math.log(q) + i * math.log1p(-q)

        log_e0 = math.log(0.5) + _log_erfc((i - z0) / (math.sqrt(2.0) * sigma))
        log_e1 = math.log(0.5) + _log_erfc((z0 - j) / (math.sqrt(2.0) * sigma))

        log_s0 = log_t0 + (i * i - i) / (2.0 * sigma**2) + log_e0
        log_s1 = log_t1 + (j * j - j) / (2.0 * sigma**2) + log_e1

        if coef > 0:
            log_a0 = _log_add(log_a0, log_s0)
            log_a1 = _log_add(log_a1, log_s1)
        else:
            log_a0 = _log_sub(log_a0, log_s0)
            log_a1 = _log_sub(log_a1, log_s1)

        i += 1
        if max(log_s0, log_s1) < -30 and i > alpha:
            break
    return _log_add(log_a0, log_a1)


def rdp_poisson_subsampled_gaussian(
    q: float, noise_multiplier: float, orders: Sequence[float]
) -> np.ndarray:
    """RDP(alpha) of ONE step of the Poisson-subsampled Gaussian mechanism.

    add-or-remove-one adjacency; ``q`` is the Poisson inclusion probability,
    ``noise_multiplier`` the sigma on a sensitivity-1 sum.
    """
    sigma = float(noise_multiplier)
    out = np.zeros(len(orders), dtype=np.float64)
    for idx, alpha in enumerate(orders):
        if q == 0.0:
            out[idx] = 0.0
        elif sigma == 0.0 or alpha <= 1.0:
            out[idx] = np.inf
        elif q == 1.0:
            out[idx] = alpha / (2.0 * sigma**2)
        else:
            if float(alpha).is_integer():
                log_a = _log_a_int(q, sigma, int(alpha))
            else:
                log_a = _log_a_frac(q, sigma, float(alpha))
            out[idx] = log_a / (alpha - 1.0)
    return out


# ---------------------------------------------------------------------------
# RDP -> (epsilon, delta)
# ---------------------------------------------------------------------------

def epsilon_from_rdp(
    orders: Sequence[float], rdp: Iterable[float], delta: float
) -> float:
    """min over alpha of the CKS/Balle conversion:
    eps = rdp + log((alpha-1)/alpha) - (log(delta) + log(alpha)) / (alpha - 1).
    """
    if delta <= 0 or delta >= 1:
        raise ValueError("delta must be in (0, 1)")
    best = np.inf
    for alpha, r in zip(orders, rdp):
        if alpha <= 1 or not np.isfinite(r):
            continue
        eps = (
            r
            + math.log1p(-1.0 / alpha)
            - (math.log(delta) + math.log(alpha)) / (alpha - 1.0)
        )
        best = min(best, max(eps, 0.0))
    return float(best)


def delta_from_rdp(
    orders: Sequence[float], rdp: Iterable[float], epsilon: float
) -> float:
    """min over alpha of delta = exp((alpha-1)(rdp - eps)) (Mironov Prop. 3),
    with the sharper log(alpha)/(alpha-1) refinement applied when favorable."""
    if epsilon < 0:
        raise ValueError("epsilon must be >= 0")
    best_log = 0.0  # delta <= 1
    for alpha, r in zip(orders, rdp):
        if alpha <= 1 or not np.isfinite(r):
            continue
        log_delta = (alpha - 1.0) * (r - epsilon)
        # refinement from the CKS conversion, valid for the same mechanism:
        refined = (alpha - 1.0) * (
            r - epsilon + math.log1p(-1.0 / alpha)
        ) - math.log(alpha)
        log_delta = min(log_delta, refined)
        best_log = min(best_log, log_delta)
    return float(min(1.0, math.exp(best_log)))
