"""Plain ORB extraction: the reference for the program's front end.

A frozen copy of the port's plain extraction path (pyramid by antialiased
bilinear weight matrices, FAST-9 over the whole image, 3x3 NMS, exact top-k
per level, intensity-centroid orientation, steered BRIEF on the blurred
level, sub-pixel parabola from the raw score map), in plain torch
operations and with no kernel. `level_dtype` rounds every pyramid level
and its blurred copy to a lower precision: the control's front end.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SCALE_FACTOR = 1.2
PATCH_RADIUS = 15
BRIEF_RADIUS = 13
STEER_RADIUS = 19
N_BITS = 256
N_ANGLE_BINS = 60
BORDER = 3
RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def _pattern() -> np.ndarray:
    rng = np.random.RandomState(20160612)
    pts = np.clip(rng.randn(N_BITS, 4) * (BRIEF_RADIUS / 2.5), -BRIEF_RADIUS, BRIEF_RADIUS)
    return np.round(pts).astype(np.int8)


PATTERN = _pattern()


def level_shape(hw, level: int):
    s = SCALE_FACTOR ** level
    return max(int(round(hw[0] / s)), 16), max(int(round(hw[1] / s)), 16)


def _weights(n_in: int, n_out: int, device) -> torch.Tensor:
    inv = 1.0 / (n_out / n_in)
    d = torch.float64
    sample = (torch.arange(n_out, dtype=d, device=device) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=d, device=device)[:, None]).abs()
    x = x / max(inv, 1.0)
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(torch.float32)


def pyramid(img: torch.Tensor, n_levels: int):
    levels = [img]
    for lv in range(1, n_levels):
        h, w = level_shape(img.shape, lv)
        prev = levels[-1]
        out = prev
        if h != prev.shape[0]:
            out = _weights(prev.shape[0], h, img.device).T @ out
        if w != prev.shape[1]:
            out = out @ _weights(prev.shape[1], w, img.device)
        levels.append(out)
    return levels


def blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    H, W = img.shape
    ap = F.pad(img[None, None], (radius, radius, 0, 0), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        out = out + k[i] * ap[:, i:i + W]
    ap = F.pad(out[None, None], (0, 0, radius, radius), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(2 * radius + 1):
        out = out + k[i] * ap[i:i + H, :]
    return out


def _min9(d: torch.Tensor) -> torch.Tensor:
    m = torch.minimum(d, torch.roll(d, -1, dims=0))
    m = torch.minimum(m, torch.roll(m, -2, dims=0))
    m = torch.minimum(m, torch.roll(m, -4, dims=0))
    return torch.minimum(m, torch.roll(d, -8, dims=0))


def fast_raw(img: torch.Tensor) -> torch.Tensor:
    d = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1)) for dy, dx in RING]) - img[None]
    return torch.maximum(_min9(d).amax(0), _min9(-d).amax(0))


def fast_nms(raw: torch.Tensor, threshold: float) -> torch.Tensor:
    H, W = raw.shape
    ys = torch.arange(H, device=raw.device)[:, None]
    xs = torch.arange(W, device=raw.device)[None, :]
    inner = (ys >= BORDER) & (ys < H - BORDER) & (xs >= BORDER) & (xs < W - BORDER)
    score = torch.where(inner & (raw > threshold), raw, 0.0)
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    mx = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                mx = torch.maximum(mx, p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return torch.where(score >= mx, score, 0.0)


def _parab(sm, s0, sp):
    denom = sm - 2.0 * s0 + sp
    good = denom.abs() > 1e-6
    off = 0.5 * (sm - sp) / torch.where(good, denom, 1.0)
    return torch.clamp(torch.where(good, off, 0.0), -0.5, 0.5)


def subpixel(raw: torch.Tensor, yx: torch.Tensor, threshold: float) -> torch.Tensor:
    H, W = raw.shape
    p = F.pad(raw[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    offy = _parab(p[:-2, 1:-1], raw, p[2:, 1:-1]).reshape(-1)
    offx = _parab(p[1:-1, :-2], raw, p[1:-1, 2:]).reshape(-1)
    yi, xi = yx[:, 0].long(), yx[:, 1].long()
    flat = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
    ok = ((yi >= BORDER + 1) & (yi < H - BORDER - 1) & (xi >= BORDER + 1) & (xi < W - BORDER - 1)
          & (raw.reshape(-1)[flat] > threshold))
    return torch.where(ok[:, None], torch.stack([offy[flat], offx[flat]], -1), 0.0)


def orientation(img: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    r = PATCH_RADIUS
    d = 2 * r + 1
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    disc = (ys ** 2 + xs ** 2 <= r ** 2).astype(np.float32)
    wy = torch.as_tensor(ys * disc, dtype=img.dtype, device=img.device)
    wx = torch.as_tensor(xs * disc, dtype=img.dtype, device=img.device)
    y0 = torch.clamp(yx[:, 0].long() - r, 0, H - d)
    x0 = torch.clamp(yx[:, 1].long() - r, 0, W - d)
    ar = torch.arange(d, device=img.device)
    p = img.reshape(-1)[((y0[:, None] + ar)[:, :, None]) * W + (x0[:, None] + ar)[:, None, :]]
    return torch.atan2((p * wy).sum((1, 2)), (p * wx).sum((1, 2)))


def brief(img: torch.Tensor, yx: torch.Tensor, ang: torch.Tensor, steer_mode: str):
    """Packed (K, 8) int32 steered-BRIEF words (bit b of word w is test
    w * 32 + b)."""
    if steer_mode != "continuous":
        ang = torch.round(ang * (N_ANGLE_BINS / (2.0 * math.pi))) * (2.0 * math.pi / N_ANGLE_BINS)
    H, W = img.shape
    R = STEER_RADIUS
    D = 2 * R + 1
    imgp = F.pad(img[None, None], (R, R, R, R), mode="replicate")[0, 0]
    yi = torch.clamp(yx[:, 0].long(), 0, H - 1)
    xi = torch.clamp(yx[:, 1].long(), 0, W - 1)
    c, s = torch.cos(ang), torch.sin(ang)
    pat = torch.as_tensor(PATTERN, dtype=torch.float32, device=img.device)
    py = torch.cat([pat[:, 0], pat[:, 2]])
    px = torch.cat([pat[:, 1], pat[:, 3]])
    ry = torch.clamp(torch.round(s[:, None] * px + c[:, None] * py).long() + R, 0, D - 1)
    rx = torch.clamp(torch.round(c[:, None] * px - s[:, None] * py).long() + R, 0, D - 1)
    Wp = imgp.shape[1]
    v = imgp.reshape(-1)[(yi[:, None] + ry) * Wp + (xi[:, None] + rx)]
    bits = (v[:, :N_BITS] < v[:, N_BITS:]).to(torch.int64).reshape(-1, 8, 32)
    words = (bits << torch.arange(32, dtype=torch.int64, device=img.device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def budgets(n_features: int, n_levels: int) -> list[int]:
    raw = [(1.0 / SCALE_FACTOR) ** i for i in range(n_levels)]
    per = [max(8, int(round(n_features * r / sum(raw)))) for r in raw]
    per[0] += n_features - sum(per)
    return per


def extract(img: torch.Tensor, n_features: int, n_levels: int, fast_threshold: float,
            steer_mode: str, level_dtype=torch.float32) -> dict:
    """ORB features of an (H, W) image in [0, 255]: uv (N, 2) at level-0
    scale, level (N,), desc (N, 8) int32, valid (N,)."""
    img = img.to(torch.float32)
    out = {"uv": [], "level": [], "desc": [], "valid": []}
    for lv, (im, budget) in enumerate(zip(pyramid(img, n_levels), budgets(n_features, n_levels))):
        im = im.to(level_dtype).to(torch.float32).contiguous()
        raw = fast_raw(im)
        vals, idx = torch.sort(fast_nms(raw, fast_threshold).reshape(-1), descending=True,
                               stable=True)
        vals, idx = vals[:budget], idx[:budget]
        Hl, Wl = im.shape
        yx = torch.stack([idx // Wl, idx % Wl], -1).to(torch.float32)
        e = PATCH_RADIUS
        valid = ((vals > 0) & (yx[:, 0] >= e) & (yx[:, 0] < Hl - e)
                 & (yx[:, 1] >= e) & (yx[:, 1] < Wl - e))
        blurred = blur(im).to(level_dtype).to(torch.float32)
        desc = brief(blurred, yx, orientation(im, yx), steer_mode)
        yx = yx + subpixel(raw, yx, fast_threshold)
        out["uv"].append(torch.stack([yx[:, 1], yx[:, 0]], -1) * SCALE_FACTOR ** lv)
        out["level"].append(torch.full((budget,), lv, device=img.device))
        out["desc"].append(desc)
        out["valid"].append(valid)
    return {k: torch.cat(v) for k, v in out.items()}
