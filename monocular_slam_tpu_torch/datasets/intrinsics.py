"""Known camera intrinsics for the supported datasets (a copy of
`monocular_slam_tpu/datasets/intrinsics.py`; the port keeps its own).

The reference hardcodes these in `src/FrameLoader.cpp:171-238`
(`loadCameraIntrinsics_TUM1`, `_kinect`, `_Minitaur`) and the TUM-F1
distortion in `src/CameraPoseEstimator.cpp:462-469`. Collected here as data,
keyed by dataset id. Intrinsics are (fx, fy, cx, cy); distortion is OpenCV
radtan (k1, k2, p1, p2, k3).
"""

from __future__ import annotations

import numpy as np

INTRINSICS = {
    # TUM RGB-D freiburg1 (ROS default calibration)
    "tum_fr1": dict(
        k=np.array([517.306408, 516.469215, 318.643040, 255.313989]),
        dist=np.array([0.262383, -0.953104, -0.005358, 0.002628, 1.163314]),
        wh=(640, 480),
    ),
    # TUM RGB-D freiburg2
    "tum_fr2": dict(
        k=np.array([520.908620, 521.007327, 325.141442, 249.701764]),
        dist=np.array([0.231222, -0.784899, -0.003257, -0.000105, 0.917205]),
        wh=(640, 480),
    ),
    # TUM RGB-D freiburg3
    "tum_fr3": dict(
        k=np.array([535.4, 539.2, 320.1, 247.6]),
        dist=np.zeros(5),
        wh=(640, 480),
    ),
    # Kinect-style default the reference uses for desk sequences
    # (`loadCameraIntrinsics_kinect`, FrameLoader.cpp)
    "kinect": dict(
        k=np.array([525.0, 525.0, 319.5, 239.5]),
        dist=np.zeros(5),
        wh=(640, 480),
    ),
    # KITTI odometry grayscale left (seq 00-02 calibration)
    "kitti_00": dict(
        k=np.array([718.856, 718.856, 607.1928, 185.2157]),
        dist=np.zeros(5),
        wh=(1241, 376),
    ),
    # rendered synthetic sequences (`datasets/render.py`): fr1-like pinhole,
    # zero distortion (the renderer has no lens)
    "synth": dict(
        k=np.array([517.3, 516.5, 318.6, 255.3]),
        dist=np.zeros(5),
        wh=(640, 480),
    ),
    # CMU Minitaur hopping-robot video
    # (`loadCameraIntrinsics_Minitaur`, FrameLoader.cpp:193-214)
    "minitaur": dict(
        k=np.array([712.9293, 683.2151, 913.5476, 550.1913]),
        dist=np.zeros(5),
        wh=(1920, 1080),
    ),
}


def lookup(name_or_path: str):
    """Dataset sniffing by substring — same mechanism as the reference's
    loader dispatch (`FrameLoader.cpp:282-301`)."""
    s = name_or_path.lower()
    if "synth" in s:  # rendered TUM-format sequences (datasets/render.py)
        return INTRINSICS["synth"]
    if "freiburg1" in s or "fr1" in s:
        return INTRINSICS["tum_fr1"]
    if "freiburg2" in s or "fr2" in s:
        return INTRINSICS["tum_fr2"]
    if "freiburg3" in s or "fr3" in s:
        return INTRINSICS["tum_fr3"]
    if "kitti" in s:
        return INTRINSICS["kitti_00"]
    if "desk2" in s or "kinect" in s:
        return INTRINSICS["kinect"]
    if "minitaur" in s:  # MinitaurHoppingVideo (`FrameLoader.cpp:297-300`)
        return INTRINSICS["minitaur"]
    raise KeyError(f"unknown dataset: {name_or_path}")
