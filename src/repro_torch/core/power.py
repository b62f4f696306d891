"""The average transmit-power constraint (paper eq. 4) and H_th
calibration.

Port of ``repro.core.power``. Under channel inversion (eq. 3) the IS
transmits x = Σ_i (p_i/H)·g_i on the entries with |H|² ≥ H_th. For
H ~ N(0, σ²) the expected power per entry of one client's signal is

    E[ p² g² / H² ; |H|² ≥ t ]  =  p² E[g²] · (2/σ²) ( φ(a)/a − Q(a) ),
    a = √t / σ,   φ = the standard normal pdf,   Q(a) = 1 − Φ(a).

It grows without bound as t → 0 (inverting deep fades costs without
limit), which is why the threshold exists. ``calibrate_h_threshold``
solves eq. (4) for H_th under a power budget P̄ by bisection (the
expected power falls as t grows). Arguments may be floats or tensors.
"""
from __future__ import annotations

import math

import torch

SQRT2 = math.sqrt(2.0)


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _phi(x):
    return torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def _q(x):
    return 0.5 * torch.special.erfc(x / SQRT2)


def inv_h2_truncated_mean(h_th, sigma2):
    """E[ 1/H² ; |H|² ≥ H_th ] for H ~ N(0, σ²)."""
    sigma2 = _t(sigma2)
    a = torch.sqrt(_t(h_th) / sigma2)
    return (2.0 / sigma2) * (_phi(a) / torch.clamp(a, min=1e-12) - _q(a))


def expected_entry_power(p_weight, grad_second_moment, h_th, sigma2):
    """E‖x‖² per entry of one client's channel-inverted signal (eqs. 3-4)."""
    return (_t(p_weight) ** 2) * _t(grad_second_moment) * \
        inv_h2_truncated_mean(h_th, sigma2)


def expected_transmit_power(p_weights, grad_second_moments, h_th, sigma2,
                            n_entries):
    """A cluster's E‖x_k^(l)‖² ≈ n_entries · Σ_i the per-entry power
    (entries faded independently, zero-mean: the cross terms vanish)."""
    per = sum(expected_entry_power(p, g2, h_th, sigma2)
              for p, g2 in zip(p_weights, grad_second_moments))
    return n_entries * per


def calibrate_h_threshold(power_budget, p_weights, grad_second_moments,
                          sigma2, n_entries, *, iters: int = 80):
    """eq. (4): the smallest H_th whose expected power is at most P̄, by
    ``iters`` steps of geometric bisection over [1e-12, 1e3]."""
    lo, hi = _t(1e-12), _t(1e3)
    budget = _t(power_budget)
    for _ in range(iters):
        mid = torch.sqrt(lo * hi)          # geometric: spans decades
        too_hot = expected_transmit_power(
            p_weights, grad_second_moments, mid, sigma2, n_entries) > budget
        lo = torch.where(too_hot, mid, lo)
        hi = torch.where(too_hot, hi, mid)
    return hi


def pass_rate(h_th, sigma2):
    """P(|H|² ≥ H_th) = 2Q(√H_th / σ): the share of entries transmitted."""
    return 2.0 * _q(torch.sqrt(_t(h_th) / _t(sigma2)))
