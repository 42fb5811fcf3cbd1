"""Branch-free FAST-9/16 corner scores, whole-image (counterpart of
`monocular_slam_tpu/ops/fast.py`).

Every pixel evaluates the full 16-pixel Bresenham ring: d_i = ring_i -
centre; the score is the largest t for which 9 contiguous d_i all exceed t
(bright) or all fall below -t (dark), taken as max over arcs of the circular
min-9, which a log-step min doubling computes. These tensor forms are the
plain version of the CUDA kernel in `ops/fast_score.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from monocular_slam_tpu_torch.utils.scatter import topk_stable

# 16-point Bresenham circle of radius 3, clockwise from 12 o'clock, (dy, dx)
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
BORDER = 3


def _ring_diffs(img: torch.Tensor) -> torch.Tensor:
    """(16, H, W) ring minus centre, by whole-image rolls."""
    stack = [torch.roll(img, (-dy, -dx), dims=(-2, -1)) for (dy, dx) in RING_OFFSETS]
    return torch.stack(stack, dim=0) - img[None]


def _circular_min9(d: torch.Tensor) -> torch.Tensor:
    """Min over each circular window of 9 along dim 0 (length 16)."""
    m = torch.minimum(d, torch.roll(d, -1, dims=0))
    m = torch.minimum(m, torch.roll(m, -2, dims=0))
    m = torch.minimum(m, torch.roll(m, -4, dims=0))
    return torch.minimum(m, torch.roll(d, -8, dims=0))


def corner_score_raw(img: torch.Tensor) -> torch.Tensor:
    """Raw FAST-9 score per pixel (no threshold, no border mask)."""
    d = _ring_diffs(img)
    bright = _circular_min9(d).amax(0)
    dark = _circular_min9(-d).amax(0)
    return torch.maximum(bright, dark)


def _interior(H: int, W: int, device) -> torch.Tensor:
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys >= BORDER) & (ys < H - BORDER) & (xs >= BORDER) & (xs < W - BORDER)


def corner_score(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """Thresholded FAST-9 score, zero within BORDER of the edge."""
    score = corner_score_raw(img)
    score = torch.where(score > threshold, score, 0.0)
    H, W = img.shape[-2:]
    return torch.where(_interior(H, W, img.device), score, 0.0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression: keep score where it is >= all 8 neighbours."""
    H, W = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    mx = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            mx = torch.maximum(mx, p[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W])
    return torch.where(score >= mx, score, 0.0)


def subpixel_offsets(img: torch.Tensor, yx: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """(K, 2) sub-pixel (dy, dx) offsets at integer corners `yx`, by a 1D
    parabola per axis through the raw FAST-9 scores of each corner's 3x3
    neighbourhood, recomputed at those pixels from clamped gathers (the
    same offsets as `subpixel_from_raw` wherever its gate accepts)."""
    H, W = img.shape[-2:]
    yi = yx[..., 0].to(torch.long)
    xi = yx[..., 1].to(torch.long)
    d1 = torch.arange(-1, 2, device=img.device)
    ys = yi[:, None, None] + d1[None, :, None]
    xs = xi[:, None, None] + d1[None, None, :]

    def at(dy: int, dx: int) -> torch.Tensor:
        return img[torch.clamp(ys + dy, 0, H - 1), torch.clamp(xs + dx, 0, W - 1)]

    d = torch.stack([at(dy, dx) for dy, dx in RING_OFFSETS]) - at(0, 0)[None]
    s = torch.maximum(_circular_min9(d).amax(0), _circular_min9(-d).amax(0))  # (K, 3, 3)
    off = torch.stack([_parab(s[:, 0, 1], s[:, 1, 1], s[:, 2, 1]),
                       _parab(s[:, 1, 0], s[:, 1, 1], s[:, 1, 2])], dim=-1)
    ok = (
        (yi >= BORDER + 1) & (yi < H - BORDER - 1)
        & (xi >= BORDER + 1) & (xi < W - BORDER - 1)
        & (s[:, 1, 1] > threshold)
    )
    return torch.where(ok[:, None], off, 0.0).to(img.dtype)


def _parab(sm, s0, sp):
    """1D parabola vertex offset through (-1, sm), (0, s0), (+1, sp)."""
    denom = sm - 2.0 * s0 + sp
    good = denom.abs() > 1e-6
    off = 0.5 * (sm - sp) / torch.where(good, denom, 1.0)
    return torch.clamp(torch.where(good, off, 0.0), -0.5, 0.5)


def subpixel_from_raw(raw: torch.Tensor, yx: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """(K, 2) sub-pixel (dy, dx) offsets at integer corners `yx`, by a 1D
    parabola per axis through the raw score map."""
    H, W = raw.shape
    p = F.pad(raw[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    offy = _parab(p[:-2, 1:-1], raw, p[2:, 1:-1])
    offx = _parab(p[1:-1, :-2], raw, p[1:-1, 2:])
    yi = yx[..., 0].to(torch.long)
    xi = yx[..., 1].to(torch.long)
    flat = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
    dy_off = offy.reshape(-1)[flat]
    dx_off = offx.reshape(-1)[flat]
    s0 = raw.reshape(-1)[flat]
    ok = (
        (yi >= BORDER + 1) & (yi < H - BORDER - 1)
        & (xi >= BORDER + 1) & (xi < W - BORDER - 1)
        & (s0 > threshold)
    )
    off = torch.stack([dy_off, dx_off], dim=-1)
    return torch.where(ok[:, None], off, 0.0).to(raw.dtype)


class Corners(NamedTuple):
    yx: torch.Tensor  # (K, 2) float (y, x) at this level
    score: torch.Tensor  # (K,)
    valid: torch.Tensor  # (K,) bool


def top_corners(score: torch.Tensor, max_corners: int) -> Corners:
    """The `max_corners` highest entries of an NMS'd score map (lowest
    flat index first among equal scores, as `lax.top_k`)."""
    vals, idx = topk_stable(score.reshape(-1), max_corners)
    W = score.shape[-1]
    yx = torch.stack([idx // W, idx % W], dim=-1).to(score.dtype)
    return Corners(yx=yx, score=vals, valid=vals > 0)


def detect(img: torch.Tensor, max_corners: int, threshold: float = 20.0) -> Corners:
    """Fixed-capacity FAST detection: the top `max_corners` NMS survivors."""
    return top_corners(nms3(corner_score(img, threshold)), max_corners)
