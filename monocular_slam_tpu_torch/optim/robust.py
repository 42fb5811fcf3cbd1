"""Robust loss kernels as IRLS weights (counterpart of
`monocular_slam_tpu/optim/robust.py`, g2o's robust kernel family). Each
maps a squared error e2 to (rho, w = rho'(e2))."""

from __future__ import annotations

import torch

# the chi-square 95% quantile for 2 degrees of freedom, the inlier gate
CHI2_2DOF_95 = 5.991


def huber(e2: torch.Tensor, delta: float):
    """rho = e2 if e2 <= d^2 else 2 d sqrt(e2) - d^2."""
    d2 = delta * delta
    e = torch.sqrt(torch.clamp(e2, min=1e-18))
    inside = e2 <= d2
    rho = torch.where(inside, e2, 2.0 * delta * e - d2)
    w = torch.where(inside, torch.ones_like(e2), delta / e)
    return rho, w


def cauchy(e2: torch.Tensor, delta: float):
    """rho = d^2 log(1 + e2 / d^2)."""
    d2 = delta * delta
    x = e2 / d2
    return d2 * torch.log1p(x), 1.0 / (1.0 + x)


def tukey(e2: torch.Tensor, delta: float):
    """Tukey biweight: redescending, zero weight beyond delta."""
    d2 = delta * delta
    one_m = 1.0 - torch.clamp(e2 / d2, max=1.0)
    rho = (d2 / 3.0) * (1.0 - one_m**3)
    return rho, torch.where(e2 <= d2, one_m**2, torch.zeros_like(e2))


def pseudo_huber(e2: torch.Tensor, delta: float):
    """Pseudo-Huber: smooth everywhere."""
    d2 = delta * delta
    s = torch.sqrt(1.0 + e2 / d2)
    return 2.0 * d2 * (s - 1.0), 1.0 / s


def saturated(e2: torch.Tensor, delta: float):
    """Cost clamped at d^2 (a hard outlier cut)."""
    d2 = delta * delta
    return torch.clamp(e2, max=d2), torch.where(e2 <= d2, torch.ones_like(e2), torch.zeros_like(e2))


def dcs(e2: torch.Tensor, delta: float):
    """Dynamic Covariance Scaling with phi = delta: s = min(1, 2 phi /
    (phi + e2)), rho = s^2 e2, w = s^2 (g2o's `RobustKernelDCS`)."""
    s = torch.clamp(2.0 * delta / (delta + e2), max=1.0)
    return s * e2 * s, s * s


def scale_delta(inner, e2: torch.Tensor, delta: float, inner_delta: float = 1.0):
    """`inner` evaluated at e2 / d^2 with its cost scaled back by d^2; the
    IRLS weight passes through (g2o's `RobustKernelScaleDelta`)."""
    d2 = delta * delta
    rho_i, w_i = inner(e2 / d2, inner_delta)
    return d2 * rho_i, w_i


def none_(e2: torch.Tensor, delta: float = 0.0):
    """No robustification (quadratic loss)."""
    return e2, torch.ones_like(e2)


KERNELS = {
    "huber": huber,
    "cauchy": cauchy,
    "tukey": tukey,
    "pseudo_huber": pseudo_huber,
    "saturated": saturated,
    "dcs": dcs,
    "none": none_,
}
