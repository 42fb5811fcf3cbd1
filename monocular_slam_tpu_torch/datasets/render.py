"""Synthetic textured-room renderer on the device (counterpart of
`monocular_slam_tpu/datasets/render.py`).

Same scene and course as the reference's benchmark: the `box_room` of ten
textured planes (walls, floor, ceiling, central pillar), the
`arc_trajectory(radius=1.8, ang_step=0.06)` orbit and the `SYNTH_K`
pinhole. Textures are four octaves of uniform noise, cubic-upsampled and
mixed 0.35/0.30/0.20/0.15, normalized and pushed through a sigmoid around
the median, as the reference builds them. The noise is drawn with
`utils/prng.py`, the port's copy of `jax.random`'s threefry: `seed` means
the reference's `jax.random.PRNGKey(seed)`, split over the planes as it
splits it, so a course here is the reference's course, pixel for pixel up
to float rounding. `render_frame` is tensor math on whatever device its
inputs live on.

`export_tum` writes a rendered course as a TUM RGB-D directory (8-bit grey
PNGs through `native.write_png`, `rgb.txt`, `groundtruth.txt`, `calib.txt`,
`VERSION`), the layout `datasets/tum.load` reads.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from monocular_slam_tpu_torch import native
from monocular_slam_tpu_torch.datasets.synthetic import arc_trajectory
from monocular_slam_tpu_torch.ops.pyramid import cubic_upsample
from monocular_slam_tpu_torch.utils import prng
from monocular_slam_tpu_torch.utils.device import resolve_device

SYNTH_K = np.array([517.3, 516.5, 318.6, 255.3])

# the reference's RENDER_VERSION: cached on-disk courses carry it
RENDER_VERSION = 2


class Planes(NamedTuple):
    origin: torch.Tensor  # (P, 3) corner point
    u: torch.Tensor  # (P, 3) unit edge direction
    v: torch.Tensor  # (P, 3) unit edge direction
    extent: torch.Tensor  # (P, 2) lengths along u, v
    tex_id: torch.Tensor  # (P,) int64


Plane = Planes  # the reference's name for the stacked planes


def texture(key: np.ndarray, size: int = 2048, device=None) -> torch.Tensor:
    """(size, size) high-contrast multi-scale noise texture in [0, 255] from
    a threefry key, the reference's `_texture(key, size)`."""
    img = torch.zeros((size, size), dtype=torch.float32, device=device)
    octaves = ((0.35, 32), (0.30, 96), (0.20, 256), (0.15, 512))
    for kk, (w, n) in zip(prng.split(key, 4), octaves):
        noise = torch.as_tensor(prng.uniform(kk, (n, n)), device=device)
        img = img + w * cubic_upsample(noise, (size, size))
    img = (img - img.min()) / (img.max() - img.min())
    flat = img.reshape(-1)
    n = flat.numel()
    med = 0.5 * (torch.kthvalue(flat, n // 2).values + torch.kthvalue(flat, n // 2 + 1).values)
    return torch.sigmoid((img - med) * 16.0) * 255.0


def box_room(half: float = 3.0, height: float = 1.8, pillar: float = 0.45, device=None) -> Planes:
    """Textured room around the origin with a square pillar at the centre."""
    h, y0, y1, p = half, -height, height, pillar
    rows = [
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

    def col(j):
        return torch.tensor([r[j] for r in rows], dtype=torch.float32, device=device)

    return Planes(col(0), col(1), col(2), col(3),
                  torch.arange(len(rows), device=device))


def render_frame(pose: torch.Tensor, k: torch.Tensor, wh, planes: Planes,
                 textures: torch.Tensor) -> torch.Tensor:
    """Ray-cast one grayscale (H, W) float32 frame in [0, 255]. pose:
    world->camera (3, 4); textures (n_tex, S, S)."""
    W, H = wh
    S = textures.shape[-1]
    dev = textures.device
    R = pose[:3, :3]
    C = -(R.T @ pose[:3, 3])
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32), indexing="ij")
    dirs_cam = torch.stack([(xs + 0.5 - k[2]) / k[0], (ys + 0.5 - k[3]) / k[1],
                            torch.ones_like(xs)], dim=-1)
    dirs = dirs_cam @ R  # world-frame ray directions
    n = torch.linalg.cross(planes.u, planes.v)  # (P, 3)
    denom = torch.einsum("hwc,pc->phw", dirs, n)
    denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
    t = ((planes.origin - C) * n).sum(-1)[:, None, None] / denom
    pt = C + t[..., None] * dirs[None]  # (P, H, W, 3)
    rel = pt - planes.origin[:, None, None, :]
    lu = (rel * planes.u[:, None, None, :]).sum(-1)
    lv = (rel * planes.v[:, None, None, :]).sum(-1)
    ext = planes.extent[:, None, None, :]
    ok = (t > 1e-3) & (lu >= 0) & (lu <= ext[..., 0]) & (lv >= 0) & (lv <= ext[..., 1])
    ts = torch.where(ok, t, torch.full_like(t, float("inf")))
    tmin, best = ts.min(0)
    lu = lu.gather(0, best[None])[0]
    lv = lv.gather(0, best[None])[0]
    tex_idx = planes.tex_id[best]
    # isotropic texel density: the largest face spans the whole texture
    density = (S - 1.0) / planes.extent.max()
    uf = torch.clamp(lu * density, 0.0, S - 1.0)
    vf = torch.clamp(lv * density, 0.0, S - 1.0)
    u0 = torch.clamp(uf.to(torch.long), 0, S - 2)
    v0 = torch.clamp(vf.to(torch.long), 0, S - 2)
    au, av = uf - u0, vf - v0
    t00 = textures[tex_idx, v0, u0]
    t01 = textures[tex_idx, v0, u0 + 1]
    t10 = textures[tex_idx, v0 + 1, u0]
    t11 = textures[tex_idx, v0 + 1, u0 + 1]
    img = t00 * (1 - au) * (1 - av) + t01 * au * (1 - av) + t10 * (1 - au) * av + t11 * au * av
    return torch.where(torch.isfinite(tmin), img, torch.zeros_like(img))


def render_sequence(seed: int = 11, n_frames: int = 60, wh=(640, 480), radius: float = 1.8,
                    ang_step: float = 0.06, tex_size: int = 2048, device=None, key=None, k=None,
                    quantize: bool = True):
    """The rendered orbit inside the box room, textured from
    `PRNGKey(seed)` (or from `key`, a (2,) uint32 key, when given), seen
    through `k` (default: `SYNTH_K` scaled to `wh`). Returns (images
    (F, H, W) float32 tensor on `device` (default: the card), quantized to
    integers in [0, 255] as the reference's PNG export stores them, or
    with `quantize` False the renderer's floats, as the reference's
    `render_sequence` returns them; poses_gt (F, 3, 4) numpy world->camera;
    k (4,) numpy)."""
    device = resolve_device(device)
    W, H = wh
    if k is None:
        k = SYNTH_K * np.array([W / 640.0, H / 480.0, W / 640.0, H / 480.0])
    k = np.asarray(k)
    planes = box_room(device=device)
    key = prng.PRNGKey(seed) if key is None else np.asarray(key, np.uint32)
    keys = prng.split(key, planes.origin.shape[0])
    textures = torch.stack([texture(kk, tex_size, device) for kk in keys])
    poses = arc_trajectory(n_frames, radius=radius, ang_step=ang_step)
    kt = torch.as_tensor(k, dtype=torch.float32, device=device)
    pt = torch.as_tensor(poses, device=device)
    imgs = torch.stack([render_frame(pt[i], kt, wh, planes, textures) for i in range(n_frames)])
    if quantize:
        imgs = torch.clamp(imgs, 0.0, 255.0).to(torch.uint8).to(torch.float32)
    return imgs, poses, k


def _rt_to_tum_line(ts: float, pose: np.ndarray) -> str:
    """world->camera (3, 4) -> TUM groundtruth line (camera-to-world)."""
    from scipy.spatial.transform import Rotation

    R = pose[:3, :3]
    C = -R.T @ pose[:3, 3]
    q = Rotation.from_matrix(R.T).as_quat()  # (qx, qy, qz, qw)
    vals = [C[0], C[1], C[2], q[0], q[1], q[2], q[3]]
    return f"{ts:.6f} " + " ".join(f"{v:.6f}" for v in vals)


def write_tum(root: str, imgs, poses: np.ndarray, k: np.ndarray, fps: float = 30.0) -> str:
    """Write rendered frames ((F, H, W) in [0, 255], tensor or numpy) and
    their world->camera poses as a TUM RGB-D directory; returns `root`."""
    imgs = imgs.detach().cpu().numpy() if torch.is_tensor(imgs) else np.asarray(imgs)
    imgs = np.clip(imgs, 0, 255).astype(np.uint8)
    H, W = imgs.shape[1:]
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    rgb_lines = ["# color images", "# timestamp filename"]
    gt_lines = ["# ground truth trajectory", "# timestamp tx ty tz qx qy qz qw"]
    for i in range(len(imgs)):
        ts = i / fps
        name = f"rgb/{ts:.6f}.png"
        native.write_png(os.path.join(root, name), imgs[i])
        rgb_lines.append(f"{ts:.6f} {name}")
        gt_lines.append(_rt_to_tum_line(ts, poses[i]))
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "VERSION"), "w") as f:
        f.write(f"{RENDER_VERSION}\n")
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(" ".join(f"{v:.6f}" for v in k) + f" {W} {H}\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("\n".join(gt_lines) + "\n")
    return root


def export_tum(root: str, seed: int = 0, n_frames: int = 60, wh=(640, 480), fps: float = 30.0,
               device=None, key=None, **render_kwargs) -> str:
    """Render a course (`render_sequence(seed, ...)` on `device`, default
    the card; `key` in place of `PRNGKey(seed)`) and write it as a TUM
    RGB-D directory (rgb/*.png, rgb.txt, groundtruth.txt, calib.txt,
    VERSION), as the reference's `export_tum` does with `PRNGKey(seed)`.
    Returns `root`."""
    imgs, poses, k = render_sequence(seed=seed, n_frames=n_frames, wh=wh, device=device,
                                     key=key, **render_kwargs)
    return write_tum(root, imgs, poses, k, fps)
