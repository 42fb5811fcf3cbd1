"""Roofline accounting for the port (counterpart of
`monocular_slam_tpu/utils/roofline.py`): a program's flop and byte counts
against the card's peak rates.

PyTorch has no compiled-program cost model like XLA's
`Compiled.cost_analysis()`, so `analyze` takes the counts from the caller
(as `chip_smoke.py` counts each kernel's bytes and operations). It reports
  - mfu:       achieved operations/s over the peak rate of the dtype named,
  - hbm_frac:  achieved bytes/s over the peak memory rate,
  - bound:     "compute" when the arithmetic intensity exceeds the
               machine balance, else "memory",
  - sol_frac:  achieved over attainable throughput, attainable =
               min(peak, intensity * peak_bw).
"""

from __future__ import annotations

from typing import NamedTuple


class DevicePeaks(NamedTuple):
    name: str
    peak_bw: float  # memory bytes/s
    peak_ops: dict  # dtype name -> dense operations/s

    def peak_flops(self, dtype: str = "float32") -> float:
        return self.peak_ops[dtype]


# NVIDIA H100 SXM data sheet, dense rates at 700 W
H100_SXM = DevicePeaks("NVIDIA H100 SXM", 3.35e12, {
    "float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12, "int8": 1979e12,
})
# a nominal host, for runs on the CPU (not a measured rate)
CPU_NOMINAL = DevicePeaks("host CPU (nominal)", 100e9, {
    "float32": 1e12, "tf32": 1e12, "bfloat16": 1e12, "float16": 1e12, "int8": 1e12,
})


def device_peaks(device=None) -> DevicePeaks:
    """Peaks of the card named by `torch.cuda.get_device_name(device)`;
    `CPU_NOMINAL` for a CPU device; raises for a card it has no table for."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return CPU_NOMINAL
    name = torch.cuda.get_device_name(dev)
    if "h100" in name.lower():
        return H100_SXM
    raise KeyError(f"no peak rates for {name!r}")


class Roofline(NamedTuple):
    flops: float
    bytes: float
    wall_s: float
    intensity: float  # operations per memory byte
    mfu: float  # achieved / peak operation rate
    hbm_frac: float  # achieved / peak memory rate
    bound: str  # "compute" | "memory"
    sol_frac: float  # achieved / attainable under the roofline

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "wall_ms": round(self.wall_s * 1e3, 3),
            "intensity_flop_per_byte": round(self.intensity, 2),
            "mfu": round(self.mfu, 4),
            "hbm_frac": round(self.hbm_frac, 4),
            "bound": self.bound,
            "sol_frac": round(self.sol_frac, 4),
        }


def analyze(flops: float, bytes_: float, wall_s: float, peaks: DevicePeaks | None = None,
            dtype: str = "float32") -> Roofline:
    """Roofline numbers for a program that does `flops` operations of
    `dtype` and moves `bytes_` bytes in `wall_s` seconds per call."""
    peaks = peaks or device_peaks()
    peak = peaks.peak_flops(dtype)
    flops, byts = float(flops), float(bytes_)
    intensity = flops / max(byts, 1.0)
    mfu = flops / max(wall_s, 1e-12) / peak
    hbm = byts / max(wall_s, 1e-12) / peaks.peak_bw
    bound = "compute" if intensity >= peak / peaks.peak_bw else "memory"
    attainable = min(peak, intensity * peaks.peak_bw)
    sol = (flops / max(wall_s, 1e-12)) / attainable if flops > 0 else hbm
    return Roofline(flops, byts, wall_s, intensity, mfu, hbm, bound, min(sol, 1.0))
