"""Image pyramid + separable Gaussian blur (counterpart of
`monocular_slam_tpu/ops/pyramid.py`). Images are (H, W) float32 in [0, 255].

The reference downsamples with `jax.image.resize(..., "bilinear")`, which
applies a triangle filter widened by the scale factor (antialiasing) as two
weight-matrix contractions. `resize_bilinear` builds the same weight
matrices (in float64, cast to float32, as the reference does under x64) and
applies them as two matmuls, so the pyramid levels agree with the
reference's to float32 rounding.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

SCALE_FACTOR = 1.2
N_LEVELS = 8


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding, (H, W). Taps are summed
    in the reference's order."""
    x = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    H, W = img.shape

    ap = F.pad(img[None, None], (radius, radius, 0, 0), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        out = out + k[i] * ap[:, i : i + W]
    ap = F.pad(out[None, None], (0, 0, radius, radius), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        out = out + k[i] * ap[i : i + H, :]
    return out


def level_shape(shape, level: int) -> tuple[int, int]:
    s = SCALE_FACTOR**level
    return (max(int(round(shape[-2] / s)), 16), max(int(round(shape[-1] / s)), 16))


@functools.lru_cache(maxsize=64)
def _weight_mat(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """(in_size, out_size) antialiased triangle-filter resampling weights."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    d = torch.float64
    sample_f = (torch.arange(out_size, dtype=d, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=d, device=device)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    eps32 = float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps32,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(torch.float32)


def resize_bilinear(img: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., *hw) with `jax.image.resize(..., "bilinear")`
    semantics."""
    H, W = img.shape[-2:]
    h, w = hw
    out = img
    if h != H:
        out = _weight_mat(H, h, img.device).T @ out
    if w != W:
        out = out @ _weight_mat(W, w, img.device)
    return out


def resize_level(img: torch.Tensor, level: int) -> torch.Tensor:
    """Direct bilinear downscale of level 0 to pyramid level `level`
    (1.2^-level); `build_pyramid` cascades instead."""
    if level == 0:
        return img
    return resize_bilinear(img, level_shape(img.shape, level))


def build_pyramid(img: torch.Tensor, n_levels: int = N_LEVELS):
    """Cascaded pyramid: level i resizes level i-1 to the level-0-derived
    shape of level i."""
    levels = [img]
    for i in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], level_shape(img.shape, i)))
    return tuple(levels)


def level_scale(level) -> float:
    return SCALE_FACTOR ** float(level)


def cubic_upsample(img: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(..., "cubic")` (Keys kernel, a=-0.5) as two
    weight-matrix products; a shrinking axis widens the kernel by the
    scale, as `jax.image.resize`'s antialiasing does. Used by the scene
    renderer."""
    def wmat(m: int, n: int) -> torch.Tensor:
        d = torch.float64
        inv_scale = m / n
        sample_f = (torch.arange(n, dtype=d, device=img.device) + 0.5) * inv_scale - 0.5
        x = (sample_f[None, :] - torch.arange(m, dtype=d, device=img.device)[:, None]).abs()
        x = x / max(inv_scale, 1.0)
        out = ((1.5 * x - 2.5) * x) * x + 1.0
        out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
        out = torch.where(x >= 2.0, 0.0, out)
        total = out.sum(0, keepdim=True)
        out = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                          out / torch.where(total != 0, total, 1.0), 0.0)
        inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
        return torch.where(inside[None, :], out, 0.0).to(img.dtype)

    H, W = img.shape
    return wmat(H, hw[0]).T @ img @ wmat(W, hw[1])

