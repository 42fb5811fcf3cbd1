"""ORB extraction over an image pyramid (counterpart of
`monocular_slam_tpu/ops/features.py`).

K1 corner maps of every level at once (`ops/fast_score.corner_maps_levels`
— one CUDA kernel launch per frame on a card, the plain version on the
CPU); then per level: exact top-k of the NMS map with the
reference's lowest-index-first tie order, the ORB edge gate, orientation,
steered BRIEF on the blurred level, and the sub-pixel parabola from the raw
map. The keypoint budget is split geometrically (1/1.2) across levels.
"""

from __future__ import annotations

import torch

from monocular_slam_tpu_torch.ops import fast, fast_score, orb, pyramid
from monocular_slam_tpu_torch.utils.scatter import topk_stable


def _level_budgets(n_features: int, n_levels: int) -> list[int]:
    inv = 1.0 / pyramid.SCALE_FACTOR
    raw = [inv**i for i in range(n_levels)]
    s = sum(raw)
    per = [max(8, int(round(n_features * r / s))) for r in raw]
    per[0] += n_features - sum(per)
    return per


def extract(
    img: torch.Tensor,
    n_features: int = 1000,
    n_levels: int = pyramid.N_LEVELS,
    fast_threshold: float = 20.0,
    steer_mode: str = "binned",
    levels_maps_fn=None,
) -> orb.Features:
    """ORB features of a grayscale (H, W) image in [0, 255], exactly
    n_features slots. `levels_maps_fn(levels, t) -> [(nms, raw)]` computes
    the corner maps of all pyramid levels; it defaults to
    `fast_score.corner_maps_levels`."""
    if levels_maps_fn is None:
        levels_maps_fn = fast_score.corner_maps_levels
    img = img.to(torch.float32).contiguous()
    levels = [x.contiguous() for x in pyramid.build_pyramid(img, n_levels)]
    budgets = _level_budgets(n_features, n_levels)
    maps = levels_maps_fn(levels, fast_threshold)

    out = {n: [] for n in orb.Features._fields}
    for lvl, (im_l, budget, (nms_map, raw_map)) in enumerate(zip(levels, budgets, maps)):
        sc = pyramid.level_scale(lvl)
        vals, idx = topk_stable(nms_map.reshape(-1), budget)
        Hl, Wl = im_l.shape
        yx = torch.stack([idx // Wl, idx % Wl], dim=-1).to(img.dtype)
        eb = orb.PATCH_RADIUS
        valid = (
            (vals > 0)
            & (yx[:, 0] >= eb) & (yx[:, 0] < Hl - eb)
            & (yx[:, 1] >= eb) & (yx[:, 1] < Wl - eb)
        )
        blurred = pyramid.gaussian_blur(im_l, sigma=2.0, radius=3)
        ang = orb.orientations(im_l, yx)
        desc, pm1 = orb.descriptors_and_pm1(blurred, yx, ang, steer_mode=steer_mode)
        yx_ref = yx + fast.subpixel_from_raw(raw_map, yx, fast_threshold)
        out["uv"].append(torch.stack([yx_ref[:, 1], yx_ref[:, 0]], dim=-1) * sc)
        out["desc"].append(desc)
        out["desc_pm1"].append(pm1)
        out["angle"].append(ang)
        out["score"].append(vals)
        out["scale"].append(torch.full((budget,), sc, dtype=img.dtype, device=img.device))
        out["valid"].append(valid)
    return orb.Features(**{n: torch.cat(v) for n, v in out.items()})
