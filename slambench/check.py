"""How a run's `correct` is decided: the program's answers in the window
against the plain reference (`slambench/reference/`), one number each per
layer, each held to the limit in `slambench/limits/<workload>.json`.

- `kp_mismatch_pct` (front end): the sampled window frames' keypoints and
  descriptors, as the program stored them, against the reference's
  extraction of the same uint8 frames. A keypoint is matched when the other
  side has one at the same level within `UV_TOL` px with the same 256 bits;
  the number is the unmatched share of both sides' valid keypoints.
- `rpe_rot_mrad_p50`, `rpe_mm_p50` (tracking): the median error of each
  consecutive pair of tracked window frames' relative rotation, and of
  their pose step after Sim(3) alignment, as the host read the poses in the
  window, against the course's true ones.
- `rot_over_2.5mrad_pct` (tracking, and the mapping block and the loop
  closer through the keyframe frames they leave): the share of those pairs
  whose rotation error is over `ROT_TAIL_MRAD`. A fault on a few frames
  (keyframe frames, a closure) raises it where the medians do not move.
- `reproj_px_p50` (mapping block and, after a closure, the loop closer's
  correction): the median reprojection error, in pyramid-level pixels, of
  every map-point observation of the window's frames still resident at the
  end, with the final poses and points.

The control (`control=True`) puts the reference's extraction with its
pyramid in bfloat16 in the front end's place, and the program's poses and
points rounded to bfloat16 in the state's place.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference import geometry
from slambench.reference import orb as ref_orb

UV_TOL = 0.01  # px at level 0: the port's zero-coefficient undistortion rounds below 1e-3
ROT_TAIL_MRAD = 2.5  # sound runs put 1.5-3.5% of pairs over it, the bfloat16 control 30-39%


def _levels(scale: np.ndarray) -> np.ndarray:
    return np.rint(np.log(scale) / np.log(ref_orb.SCALE_FACTOR)).astype(np.int64)


def mismatch(prog: dict, ref: dict) -> tuple[int, int]:
    """(unmatched, total) valid keypoints of two extractions of one frame:
    dicts of uv (N, 2), level (N,), desc (N, 8) int32, valid (N,) numpy."""
    bad = total = 0
    pv, rv = prog["valid"], ref["valid"]
    for lv in np.union1d(prog["level"][pv], ref["level"][rv]):
        a = pv & (prog["level"] == lv)
        b = rv & (ref["level"] == lv)
        ua, ub = prog["uv"][a].astype(np.float64), ref["uv"][b].astype(np.float64)
        da, db = prog["desc"][a], ref["desc"][b]
        near = np.linalg.norm(ua[:, None] - ub[None], axis=-1) < UV_TOL
        same = near & (da[:, None, :] == db[None, :, :]).all(-1)
        bad += int((~same.any(1)).sum() + (~same.any(0)).sum())
        total += len(ua) + len(ub)
    return bad, total


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def reference_features(img: np.ndarray, fe: dict, device, level_dtype=torch.float32) -> list:
    """The reference's extraction of one uint8 frame, in each steering mode
    that `fe["steer_mode"]` allows ("auto" switches between both)."""
    modes = ("binned", "continuous") if fe["steer_mode"] == "auto" else (fe["steer_mode"],)
    t = torch.as_tensor(img, device=device)
    out = []
    for mode in modes:
        with torch.no_grad():
            f = ref_orb.extract(t, fe["n_features"], fe["n_levels"], fe["fast_threshold"], mode,
                                level_dtype)
        out.append({k: v.cpu().numpy() for k, v in f.items()})
    return out


def numbers(ans: dict, gt: np.ndarray, images: dict, fe: dict, device,
            control: bool = False) -> dict:
    """The numbers of a run (`ans` as `run.collect_answers` gives it;
    `images` the sampled frames' uint8 images by window index)."""
    bad = total = 0
    for j, prog in ans["features"].items():
        refs = reference_features(images[j], fe, device)
        if control:
            ctl = reference_features(images[j], fe, device, torch.bfloat16)
            counts = [mismatch(c, r) for c, r in zip(ctl, refs)]
        else:
            prog = dict(prog, level=_levels(prog["scale"]))
            counts = [mismatch(prog, r) for r in refs]
        b, t = min(counts)
        bad, total = bad + b, total + t
    poses, obs = ans["poses"], ans["obs"]
    points, obs_pose = ans["points"], obs["pose"]
    if control:
        poses, points, obs_pose = _bf16(poses), _bf16(points), _bf16(obs_pose)
    rpe = geometry.rpe_mm(poses, gt, ans["tracked"])
    rot = geometry.rpe_rot_mrad(poses, gt, ans["tracked"])
    rep = (geometry.reprojection_px(obs_pose, obs["k"], obs["uv"], obs["scale"], obs["pid"],
                                    points) if len(obs["pid"]) else [])
    return {
        "kp_mismatch_pct": 100.0 * bad / total if total else float("inf"),
        "rpe_mm_p50": float(np.median(rpe)),
        "rpe_rot_mrad_p50": float(np.median(rot)),
        "rot_over_2.5mrad_pct": 100.0 * float(np.mean(rot > ROT_TAIL_MRAD)),
        "reproj_px_mean": float(np.mean(rep)) if len(rep) else float("inf"),
        "reproj_px_p50": float(np.median(rep)) if len(rep) else float("inf"),
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that `limits`
    names: every one at or under its limit (one that is not finite fails)."""
    out = {n: {"value": values[n], "limit": lim} for n, lim in limits.items()}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values())
    return ok, out
