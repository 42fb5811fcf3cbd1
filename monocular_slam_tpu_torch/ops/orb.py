"""Oriented BRIEF descriptors (counterpart of `monocular_slam_tpu/ops/orb.py`).

Orientation is the intensity-centroid angle over a radius-15 disc; the
descriptor is 256 steered-BRIEF comparisons on the blurred level image,
packed little-endian into 8 words: bit b of word w is test w*32+b.

The reference samples with one-hot matmuls (a TPU has no fast gather); a
one-hot product with one nonzero term returns the sampled value exactly,
so the port gathers directly and gets the same values. Packed words are
held as int32 with the bit pattern of the reference's uint32 (torch has no
shifts on uint32 on the CPU); compare through `numpy.view(np.uint32)`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

PATCH_RADIUS = 15
BRIEF_RADIUS = 13
STEER_RADIUS = 19
STEER_PATCH = 2 * STEER_RADIUS + 1
N_BITS = 256
N_ANGLE_BINS = 60
_PATTERN_SEED = 20160612


def _make_pattern() -> np.ndarray:
    """(256, 4) int8 test pairs (y1, x1, y2, x2), exactly as the reference
    draws them."""
    rng = np.random.RandomState(_PATTERN_SEED)
    sigma = BRIEF_RADIUS / 2.5
    pts = rng.randn(N_BITS, 4) * sigma
    pts = np.clip(pts, -BRIEF_RADIUS, BRIEF_RADIUS)
    return np.round(pts).astype(np.int8)


PATTERN = _make_pattern()  # (256, 4) numpy int8


def _disc_moment_masks() -> tuple[np.ndarray, np.ndarray]:
    r = PATCH_RADIUS
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    m = (ys**2 + xs**2 <= r**2).astype(np.float32)
    return ys * m, xs * m


_WY, _WX = _disc_moment_masks()


_CONSTS: dict = {}


def _on(arr, dtype, device) -> torch.Tensor:
    """A host constant's copy on `device`, made once: a per-call upload
    would be a host-to-device copy inside the captured step."""
    key = (id(arr), dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(arr, dtype=dtype, device=device)
    return t


def _patches(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, d: int) -> torch.Tensor:
    """(K, d, d) patches with top-left corners (y0, x0) (caller keeps them
    inside the image)."""
    W = img.shape[1]
    ar = torch.arange(d, device=img.device)
    rows = (y0[:, None] + ar[None, :])[:, :, None]
    cols = (x0[:, None] + ar[None, :])[:, None, :]
    return img.reshape(-1)[rows * W + cols]


def orientations(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per keypoint; img (H, W), yx (K, 2) float."""
    H, W = img.shape
    r = PATCH_RADIUS
    d = 2 * r + 1
    y0 = torch.clamp(yx[:, 0].to(torch.long) - r, 0, H - d)
    x0 = torch.clamp(yx[:, 1].to(torch.long) - r, 0, W - d)
    p = _patches(img, y0, x0, d)
    wy = _on(_WY, img.dtype, img.device)
    wx = _on(_WX, img.dtype, img.device)
    m01 = (p * wy[None]).sum((1, 2))
    m10 = (p * wx[None]).sum((1, 2))
    return torch.atan2(m01, m10)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool -> (K, 8) int32 words; bit b of word w is test w*32+b."""
    b = bits.to(torch.int64).reshape(-1, 8, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (b << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """(K, 8) packed words -> (K, 256) int8 in {-1, +1}."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc.device)
    bits = (desc.to(torch.int64)[..., :, None] >> shifts) & 1
    bits = bits.reshape(desc.shape[:-1] + (256,))
    return (bits * 2 - 1).to(torch.int8)


def _descriptors_continuous(img: torch.Tensor, yx: torch.Tensor, angles: torch.Tensor):
    """Rotate the pattern by each keypoint's angle, round to pixels, and
    compare the two samples of each pair on the edge-padded image."""
    H, W = img.shape
    D = STEER_PATCH
    R = STEER_RADIUS
    imgp = F.pad(img[None, None], (R, R, R, R), mode="replicate")[0, 0]
    yi = torch.clamp(yx[:, 0].to(torch.long), 0, H - 1)
    xi = torch.clamp(yx[:, 1].to(torch.long), 0, W - 1)
    c, s = torch.cos(angles), torch.sin(angles)
    pat = _on(PATTERN, torch.float32, img.device)
    py = torch.cat([pat[:, 0], pat[:, 2]])
    px = torch.cat([pat[:, 1], pat[:, 3]])
    ry = torch.round(s[:, None] * px[None, :] + c[:, None] * py[None, :])
    rx = torch.round(c[:, None] * px[None, :] - s[:, None] * py[None, :])
    ry = torch.clamp(ry.to(torch.long) + R, 0, D - 1)
    rx = torch.clamp(rx.to(torch.long) + R, 0, D - 1)
    Wp = imgp.shape[1]
    v = imgp.reshape(-1)[(yi[:, None] + ry) * Wp + (xi[:, None] + rx)]  # (K, 512)
    bits = v[:, :N_BITS] < v[:, N_BITS:]
    pm1 = (bits.to(torch.int8) * 2 - 1).to(torch.int8)
    return pack_bits(bits), pm1


def descriptors_and_pm1(img, yx, angles, steer_mode: str = "binned"):
    """Steered BRIEF on a pre-blurred image: (packed (K, 8) int32, pm1
    (K, 256) int8). "binned" quantizes the angle to N_ANGLE_BINS first."""
    if steer_mode != "continuous":
        bins = torch.round(angles * (N_ANGLE_BINS / (2.0 * math.pi)))
        angles = bins * (2.0 * math.pi / N_ANGLE_BINS)
    return _descriptors_continuous(img, yx, angles)


def descriptors(img: torch.Tensor, yx: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Packed binned-steering BRIEF descriptors (K, 8) int32."""
    return descriptors_and_pm1(img, yx, angles)[0]


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Set bits per 32-bit word (SWAR, as DBoW2 counts ORB distances) of
    int32 bit patterns (or uint32 values in a wider int); int32 counts."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact Hamming distance between packed (..., 8) descriptors; (...,)
    int32."""
    return popcount_u32(a ^ b).sum(-1).to(torch.int32)


class Features(NamedTuple):
    uv: torch.Tensor  # (N, 2) (x, y) at level-0 scale
    desc: torch.Tensor  # (N, 8) int32 (uint32 bit pattern)
    desc_pm1: torch.Tensor  # (N, 256) int8
    angle: torch.Tensor  # (N,)
    score: torch.Tensor  # (N,)
    scale: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool
