"""Sim(3) similarity transforms (counterpart of
`monocular_slam_tpu/geometry/sim3.py`).

A Sim3 is a packed (..., 3, 5) tensor: columns 0:3 = R, column 3 = t,
column 4 row 0 = s (rows 1, 2 of column 4 are zero). exp/log use the
(omega, upsilon, sigma = log s) tangent and share `_V_matrix`, whose
small-angle and small-scale branches follow the reference's dtype-aware
thresholds. Everything is branch-free tensor math, so `torch.func.jacfwd`
and `vmap` differentiate it (the pose graph's Jacobians).
"""

from __future__ import annotations

import torch

from monocular_slam_tpu_torch.geometry import so3

_EPS = 1e-8


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (..., 3) as broadcast multiply + sum."""
    return (M * v[..., None, :]).sum(-1)


def pack(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3), (...,) -> (..., 3, 5)."""
    z = torch.zeros_like(s)
    s_col = torch.stack([s, z, z], dim=-1)
    return torch.cat([R, t[..., None], s_col[..., None]], dim=-1)


def unpack(S: torch.Tensor):
    return S[..., :3, :3], S[..., :3, 3], S[..., 0, 4]


def identity(dtype=torch.float32, batch_shape=(), device=None) -> torch.Tensor:
    shape = tuple(batch_shape)
    R = torch.eye(3, dtype=dtype, device=device).expand(shape + (3, 3))
    return pack(R, torch.zeros(shape + (3,), dtype=dtype, device=device),
                torch.ones(shape, dtype=dtype, device=device))


def from_se3(T: torch.Tensor, s=None) -> torch.Tensor:
    """Lift a (..., 3, 4) SE3 to Sim3 with scale s (default 1)."""
    if s is None:
        s = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    return pack(T[..., :3, :3], T[..., :3, 3], s)


def to_se3(S: torch.Tensor) -> torch.Tensor:
    """Keep R, scale t by 1/s (the ORB-SLAM convention for keyframe poses)."""
    R, t, s = unpack(S)
    return torch.cat([R, (t / torch.clamp(s, min=_EPS)[..., None])[..., None]], dim=-1)


def apply(S: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """x -> s R x + t."""
    R, t, s = unpack(S)
    return s[..., None] * _mv(R, X) + t


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A after B."""
    Ra, ta, sa = unpack(A)
    Rb, tb, sb = unpack(B)
    R = (Ra[..., :, :, None] * Rb[..., None, :, :]).sum(-2)
    return pack(R, sa[..., None] * _mv(Ra, tb) + ta, sa * sb)


def inverse(S: torch.Tensor) -> torch.Tensor:
    R, t, s = unpack(S)
    Rt = R.transpose(-1, -2)
    sinv = 1.0 / torch.clamp(s, min=_EPS)
    return pack(Rt, -sinv[..., None] * _mv(Rt, t), sinv)


def _V_matrix(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """V(omega, sigma) with t = V upsilon (Strasdat / Sophus): V = A I + B W
    + C W^2, with the reference's cancellation-stable pieces and
    eps^(1/4) branch thresholds."""
    s = torch.exp(sigma)
    theta2 = (omega * omega).sum(-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    W = so3.hat(omega)
    W2 = (W[..., :, :, None] * W[..., None, :, :]).sum(-2)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(W.shape)

    eps4 = float(torch.finfo(omega.dtype).eps) ** 0.25
    small_sig = sigma.abs() < eps4
    small_th = theta < eps4
    one = torch.ones_like(sigma)
    sig_safe = torch.where(small_sig, one, sigma)
    th_safe = torch.where(small_th, one, theta)
    s2t2 = sigma * sigma + theta2
    s2t2_safe = torch.where(small_sig & small_th, one, s2t2)

    s_m1 = torch.expm1(sigma)
    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, s_m1 / sig_safe)

    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    half_sin = torch.sin(0.5 * theta)
    one_m_scos = 2.0 * half_sin * half_sin - s_m1 * cos_t

    B_gen = (sigma * s * sin_t + one_m_scos * theta) / torch.where(small_th, one, th_safe * s2t2_safe)
    B_sig = torch.where(small_sig, 0.5 + sigma / 3.0 + sigma * sigma / 8.0,
                        (sig_safe * s - s_m1) / (sig_safe * sig_safe))
    B = torch.where(small_th, B_sig, B_gen)

    C_gen = (A - (s * sin_t * theta - one_m_scos * sigma) / s2t2_safe) / torch.where(
        small_th, one, theta2)
    C_sig = torch.where(small_sig, 1.0 / 6.0 + sigma / 8.0 + sigma * sigma / 20.0,
                        (s * (0.5 * sig_safe * sig_safe - sig_safe + 1.0) - 1.0) / (sig_safe**3))
    C = torch.where(small_th, C_sig, C_gen)
    return A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * W2


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form cofactor inverse with the reference's |det| >= 1e-8 floor."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    floor = torch.where(det < 0, -_EPS, _EPS).to(det.dtype)
    det = torch.where(det.abs() < _EPS, floor, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], dim=-1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 7) = (omega, upsilon, sigma) -> (..., 3, 5)."""
    omega, upsilon, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    V = _V_matrix(omega, sigma)
    return pack(so3.exp(omega), _mv(V, upsilon), torch.exp(sigma))


def log(S: torch.Tensor) -> torch.Tensor:
    """(..., 3, 5) -> (..., 7); upsilon = V^-1 t with the same V as `exp`."""
    R, t, s = unpack(S)
    omega = so3.log(R)
    sigma = torch.log(torch.clamp(s, min=_EPS))
    V = _V_matrix(omega, sigma)
    return torch.cat([omega, _mv(_inv3x3(V), t), sigma[..., None]], dim=-1)
