"""The benchmark's course generator: a frozen copy of the port's renderer.

A course is the textured box room (`box_room`: four walls, floor, ceiling
and a square pillar, each face a threefry-noise texture) seen by a camera
that orbits the pillar at 1.8 m and looks at it. The orbit's angle advances
by the traffic file's steps, one segment after another; the height bobs as
`0.15 sin(0.3 i)`. With one segment this is the port's
`datasets.render.render_sequence` bit for bit (`slambench/tests`), which is
the JAX package's course for `PRNGKey(seed)`.

Nothing here imports the port: the benchmark's yardstick must not move when
a later change edits the program. Frames are rendered in float32 on the
device and quantized to uint8 (truncation, as the port's PNG export).
"""

from __future__ import annotations

import math

import numpy as np
import torch

RADIUS = 1.8

# --- threefry-2x32, as jax.random draws it (partitionable layout) ----------
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x, r):
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The 20-round Threefry-2x32 hash of counter pairs under key (k1, k2)."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x1 = np.asarray(x1, _U32) + ks[0]
        x2 = np.asarray(x2, _U32) + ks[1]
        for block in range(5):
            for r in _ROT[block % 2]:
                x1 = x1 + x2
                x2 = _rotl(x2, r) ^ x1
            x1 = x1 + ks[(block + 1) % 3]
            x2 = x2 + ks[(block + 2) % 3] + _U32(block + 1)
    return x1, x2


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`: the seed's 64 bits as (high, low) words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], _U32)


def _hash_iota(key, shape):
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    return threefry2x32(key[0], key[1], hi, lo)


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split`: (num, 2) uint32 keys."""
    b1, b2 = _hash_iota(np.asarray(key, _U32), (num,))
    return np.stack([b1, b2], axis=-1)


def uniform(key, shape) -> np.ndarray:
    """float32 `jax.random.uniform` in [0, 1)."""
    b1, b2 = _hash_iota(np.asarray(key, _U32), tuple(shape))
    bits = b1 ^ b2
    floats = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return np.maximum(np.float32(0.0), floats.astype(np.float64).astype(np.float32))


# --- the scene ----------------------------------------------------------------
def cubic_upsample(img: torch.Tensor, hw) -> torch.Tensor:
    """`jax.image.resize(..., "cubic")` (Keys, a = -0.5) as two weight-matrix
    products."""
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


def texture(key, size: int, device) -> torch.Tensor:
    """(size, size) four-octave noise texture in [0, 255]."""
    img = torch.zeros((size, size), dtype=torch.float32, device=device)
    octaves = ((0.35, 32), (0.30, 96), (0.20, 256), (0.15, 512))
    for kk, (w, n) in zip(split(key, 4), octaves):
        noise = torch.as_tensor(uniform(kk, (n, n)), device=device)
        img = img + w * cubic_upsample(noise, (size, size))
    img = (img - img.min()) / (img.max() - img.min())
    flat = img.reshape(-1)
    n = flat.numel()
    med = 0.5 * (torch.kthvalue(flat, n // 2).values + torch.kthvalue(flat, n // 2 + 1).values)
    return torch.sigmoid((img - med) * 16.0) * 255.0


# (origin, u, v, extent) of each face: walls, ceiling, floor, then the pillar
def _faces(half=3.0, height=1.8, pillar=0.45):
    h, y0, y1, p = half, -height, height, pillar
    return [
        ([-h, y0, h], [1, 0, 0], [0, 1, 0], [2 * h, y1 - y0]),
        ([-h, y0, -h], [1, 0, 0], [0, 1, 0], [2 * h, y1 - y0]),
        ([-h, y0, -h], [0, 0, 1], [0, 1, 0], [2 * h, y1 - y0]),
        ([h, y0, -h], [0, 0, 1], [0, 1, 0], [2 * h, y1 - y0]),
        ([-h, y1, -h], [1, 0, 0], [0, 0, 1], [2 * h, 2 * h]),
        ([-h, y0, -h], [1, 0, 0], [0, 0, 1], [2 * h, 2 * h]),
        ([-p, y0, p], [1, 0, 0], [0, 1, 0], [2 * p, y1 - y0]),
        ([-p, y0, -p], [1, 0, 0], [0, 1, 0], [2 * p, y1 - y0]),
        ([-p, y0, -p], [0, 0, 1], [0, 1, 0], [2 * p, y1 - y0]),
        ([p, y0, -p], [0, 0, 1], [0, 1, 0], [2 * p, y1 - y0]),
    ]


def box_room(device):
    """(origin, u, v, extent) float32 tensors of the room's ten faces."""
    rows = _faces()
    return tuple(torch.tensor([r[j] for r in rows], dtype=torch.float32, device=device)
                 for j in range(4))


def render_frame(pose: torch.Tensor, k: torch.Tensor, wh, planes, textures) -> torch.Tensor:
    """Ray-cast one (H, W) float32 frame in [0, 255]; pose is world->camera
    (3, 4), textures (10, S, S), face j textured by texture j."""
    origin, pu, pv, extent = planes
    W, H = wh
    S = textures.shape[-1]
    dev = textures.device
    R = pose[:3, :3]
    C = -(R.T @ pose[:3, 3])
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    dirs = torch.stack([(xs + 0.5 - k[2]) / k[0], (ys + 0.5 - k[3]) / k[1],
                        torch.ones_like(xs)], dim=-1) @ R
    n = torch.linalg.cross(pu, pv)
    denom = torch.einsum("hwc,pc->phw", dirs, n)
    denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
    t = ((origin - C) * n).sum(-1)[:, None, None] / denom
    rel = C + t[..., None] * dirs[None] - origin[:, None, None, :]
    lu = (rel * pu[:, None, None, :]).sum(-1)
    lv = (rel * pv[:, None, None, :]).sum(-1)
    ext = extent[:, None, None, :]
    ok = (t > 1e-3) & (lu >= 0) & (lu <= ext[..., 0]) & (lv >= 0) & (lv <= ext[..., 1])
    tmin, best = torch.where(ok, t, torch.full_like(t, float("inf"))).min(0)
    lu = lu.gather(0, best[None])[0]
    lv = lv.gather(0, best[None])[0]
    density = (S - 1.0) / extent.max()
    uf = torch.clamp(lu * density, 0.0, S - 1.0)
    vf = torch.clamp(lv * density, 0.0, S - 1.0)
    u0 = torch.clamp(uf.to(torch.long), 0, S - 2)
    v0 = torch.clamp(vf.to(torch.long), 0, S - 2)
    au, av = uf - u0, vf - v0
    t00 = textures[best, v0, u0]
    t01 = textures[best, v0, u0 + 1]
    t10 = textures[best, v0 + 1, u0]
    t11 = textures[best, v0 + 1, u0 + 1]
    img = t00 * (1 - au) * (1 - av) + t01 * au * (1 - av) + t10 * (1 - au) * av + t11 * au * av
    return torch.where(torch.isfinite(tmin), img, torch.zeros_like(img))


# --- the orbit ------------------------------------------------------------------
def _fma(a, b, c):
    return (np.float64(1.0) * a * b + c).astype(np.float32)


def _norm(v):
    return np.sqrt(_fma(v[..., 2], v[..., 2], _fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0])))


def _cross(a, b):
    return np.stack([_fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))
                     for i, j in ((1, 2), (2, 0), (0, 1))], axis=-1)


def orbit_angles(n_frames: int, segments) -> np.ndarray:
    """(n_frames,) float64 orbit angles: `segments` is a list of (frames,
    rad_per_frame); the last segment runs on to `n_frames`. Within a segment
    the angle is its start plus step * (frames into it), so one segment is
    `step * i` exactly."""
    ang = np.empty(n_frames, np.float64)
    start, a0 = 0, 0.0
    for s, (count, step) in enumerate(segments):
        stop = n_frames if s == len(segments) - 1 else min(n_frames, start + int(count))
        ang[start:stop] = a0 + step * np.arange(stop - start)
        a0 += step * (stop - start)
        start = stop
        if start >= n_frames:
            break
    return ang


def orbit_poses(n_frames: int, segments, radius: float = RADIUS) -> np.ndarray:
    """(n_frames, 3, 4) float32 world->camera poses looking at the pillar,
    with float32 arithmetic and fused multiply-adds as the JAX package
    rounds them."""
    i = np.arange(n_frames)
    ang = orbit_angles(n_frames, segments)
    c = np.stack([radius * np.sin(ang), 0.15 * np.sin(0.3 * i), -radius * np.cos(ang)],
                 axis=-1).astype(np.float32)
    z = -c / _norm(c)[:, None]
    x = _cross(np.broadcast_to(np.array([0.0, 1.0, 0.0], np.float32), z.shape), z)
    x = x / _norm(x)[:, None]
    y = _cross(z, x)
    R = np.stack([x, y, z], axis=1)
    t = -_fma(R[..., 2], c[:, None, 2], _fma(R[..., 1], c[:, None, 1], R[..., 0] * c[:, None, 0]))
    return np.concatenate([R, t[..., None]], axis=-1).astype(np.float32)


def render(seed: int, n_frames: int, segments, wh, k, device, tex_size: int = 2048):
    """The course for `seed`: (frames (n, H, W) uint8 numpy, poses_gt (n, 3,
    4) float32 world->camera). Textures from `PRNGKey(seed)` split over the
    faces; frames rendered on `device` in float32, clamped and truncated to
    uint8."""
    planes = box_room(device)
    keys = split(prng_key(seed), len(_faces()))
    textures = torch.stack([texture(kk, tex_size, device) for kk in keys])
    poses = orbit_poses(n_frames, segments)
    kt = torch.as_tensor(np.asarray(k), dtype=torch.float32, device=device)
    pt = torch.as_tensor(poses, device=device)
    W, H = wh
    out = torch.empty((n_frames, H, W), dtype=torch.uint8, device=device)
    for f in range(n_frames):
        img = render_frame(pt[f], kt, wh, planes, textures)
        out[f] = torch.clamp(img, 0.0, 255.0).to(torch.uint8)
    frames = out.cpu().numpy()
    return frames, poses
