"""TUM RGB-D dataset loader: rgb/depth lists + groundtruth with timestamp
association (counterpart of `monocular_slam_tpu/datasets/tum.py`; images
decode through the port's native PNG decoder).

Replaces `FrameLoader` (`src/FrameLoader.cpp`): directory scan of `rgb/`
(`loadImgFileList`, :36-67), optional `depth/` (:69-95), `groundtruth.txt`
quaternion poses (:116-168) with nearest-timestamp association within 0.02 s
(the reference's bound, :131), and per-dataset intrinsics. Frame windows
([start, end) step) mirror the reference's `FrameLoader(dir, 0, 200, 2)`
usage (`src/main.cpp:35`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from monocular_slam_tpu_torch import native
from monocular_slam_tpu_torch.datasets import intrinsics as intr

MAX_GT_DT = 0.02  # seconds — `src/FrameLoader.cpp:131`


@dataclass
class TumFrame:
    timestamp: float
    rgb_path: str
    depth_path: str | None
    pose_gt: np.ndarray | None  # (3, 4) world->camera or None


@dataclass
class TumSequence:
    frames: list[TumFrame]
    k: np.ndarray  # (4,)
    dist: np.ndarray  # (5,)
    wh: tuple[int, int]

    def load_image(self, i: int, gray: bool = True) -> np.ndarray:
        """Decode frame i's RGB image as float32 (H, W) grayscale [0, 255]
        with the native decoder."""
        return native.load_png_f32(self.frames[i].rgb_path, scale16=1.0 / 256.0)

    def load_depth(self, i: int) -> np.ndarray | None:
        """Depth in meters (TUM scale factor 5000), or None."""
        p = self.frames[i].depth_path
        if p is None:
            return None
        return native.load_png_f32(p, scale16=1.0 / 5000.0)

    def load_images_batch(self, indices, n_threads: int = 0):
        """Threaded native batch decode of several frames."""
        return native.load_batch_f32(
            [self.frames[i].rgb_path for i in indices], scale16=1.0 / 256.0,
            n_threads=n_threads,
        )


def _read_list_file(path: str):
    """Parse a TUM `rgb.txt`/`depth.txt`: lines `timestamp filename`."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, name = line.split()[:2]
            out.append((float(ts), name))
    return out


def _associate(ts_query: np.ndarray, ts_ref: np.ndarray, max_dt: float):
    """Nearest-neighbour timestamp association. Returns (idx, ok) arrays."""
    idx = np.searchsorted(ts_ref, ts_query)
    idx = np.clip(idx, 1, len(ts_ref) - 1)
    left = ts_ref[idx - 1]
    right = ts_ref[idx]
    use_left = (ts_query - left) < (right - ts_query)
    nearest = np.where(use_left, idx - 1, idx)
    dt = np.abs(ts_ref[nearest] - ts_query)
    return nearest, dt <= max_dt


def _quat_to_Rwc(q: np.ndarray, c: np.ndarray) -> np.ndarray:
    """TUM line (camera-to-world quat + center) -> world->camera (3, 4).
    Same conversion as `loadGroundTruth` + `WorldRtToRT`
    (`src/FrameLoader.cpp:97-168`)."""
    from scipy.spatial.transform import Rotation

    R_cw = Rotation.from_quat(q).as_matrix()  # camera-to-world
    R_wc = R_cw.T
    t = -R_wc @ c
    return np.concatenate([R_wc, t[:, None]], axis=1)


def load(
    root: str,
    start: int = 0,
    end: int | None = None,
    step: int = 1,
) -> TumSequence:
    """Load a TUM sequence directory (must contain rgb.txt; depth.txt and
    groundtruth.txt optional). Intrinsics come from a `calib.txt`
    (fx fy cx cy [W H]) if present, else dataset-name sniffing — the
    reference only has the latter (`FrameLoader.cpp:282-301`)."""
    calib_file = os.path.join(root, "calib.txt")
    if os.path.exists(calib_file):
        vals = np.loadtxt(calib_file).reshape(-1)
        cal = dict(
            k=vals[:4],
            dist=np.zeros(5),
            wh=(int(vals[4]), int(vals[5])) if len(vals) >= 6 else (640, 480),
        )
    else:
        cal = intr.lookup(root)
    rgb = _read_list_file(os.path.join(root, "rgb.txt"))
    if end is None:
        end = len(rgb)
    rgb = rgb[start:end:step]
    ts_rgb = np.array([t for t, _ in rgb])

    depth_map = {}
    depth_file = os.path.join(root, "depth.txt")
    if os.path.exists(depth_file):
        depth = _read_list_file(depth_file)
        ts_d = np.array([t for t, _ in depth])
        idx, ok = _associate(ts_rgb, ts_d, MAX_GT_DT)
        for i, (j, o) in enumerate(zip(idx, ok)):
            if o:
                depth_map[i] = os.path.join(root, depth[j][1])

    gt_map = {}
    gt_file = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_file):
        rows = []
        with open(gt_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                rows.append([float(v) for v in line.split()])
        rows = np.asarray(rows)
        ts_gt = rows[:, 0]
        idx, ok = _associate(ts_rgb, ts_gt, MAX_GT_DT)
        for i, (j, o) in enumerate(zip(idx, ok)):
            if o:
                gt_map[i] = _quat_to_Rwc(rows[j, 4:8], rows[j, 1:4])

    frames = [
        TumFrame(
            timestamp=ts_rgb[i],
            rgb_path=os.path.join(root, rgb[i][1]),
            depth_path=depth_map.get(i),
            pose_gt=gt_map.get(i),
        )
        for i in range(len(rgb))
    ]
    return TumSequence(frames=frames, k=cal["k"], dist=cal["dist"], wh=cal["wh"])
