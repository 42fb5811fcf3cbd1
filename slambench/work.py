"""Frozen work formulas of the port's kernels and the card's peak rates.

The program keeps its own copies (`monocular_slam_tpu_torch/bench.py`,
`utils/roofline.py`); a later change may edit those, so the benchmark keeps
these, which `slambench/tests` hold equal to the program's at the time they
were copied.
"""

from __future__ import annotations

SCALE_FACTOR = 1.2  # ORBextractor.scaleFactor
K1_BYTES_PER_PX = 12  # read the level once, write the NMS and raw maps (float32)

# NVIDIA H100 SXM data sheet, dense rates at 700 W
PEAKS = {
    "NVIDIA H100": {"hbm_bytes_per_s": 3.35e12, "int8_ops_per_s": 1979e12},
}


def peaks(device_name: str) -> dict:
    """The data sheet's rates for a card by its `torch.cuda.get_device_name`."""
    for key, val in PEAKS.items():
        if key.lower() in device_name.lower():
            return val
    raise KeyError(f"no peak rates for {device_name!r}")


def level_shape(hw, level: int) -> tuple[int, int]:
    """(H, W) of pyramid level `level` of an (H, W) image (the port's rule:
    rounded, at least 16)."""
    s = SCALE_FACTOR ** level
    return max(int(round(hw[0] / s)), 16), max(int(round(hw[1] / s)), 16)


def pyramid_pixels(hw, n_levels: int) -> int:
    """Pixels over the `n_levels` levels of an (H, W) image."""
    return sum(h * w for h, w in (level_shape(hw, lv) for lv in range(n_levels)))


def k1_bytes(hw, n_levels: int) -> int:
    """K1's least bytes for one frame: 12 a pixel over every level."""
    return K1_BYTES_PER_PX * pyramid_pixels(hw, n_levels)


def k2_ops(n: int, b: int, m: int) -> int:
    """K2's int8 operations for one launch: n query rows against b
    databases of m rows, 256 multiply-adds (2 operations) a pair."""
    return 2 * n * b * m * 256
