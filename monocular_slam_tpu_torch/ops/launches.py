"""Launch counts of the port's hand-written kernels, counted on the card by
the kernels themselves.

Every kernel of `csrc/` takes a pointer to a 64-bit counter and adds one to
it from the first thread of its first block. A launch is therefore counted
where it runs: an eager call and every replay of a CUDA graph that captured
the launch alike (a capture records the launch and runs nothing). A
device's counters are one int64 tensor, `counters(device)`, one lane per
kernel in `KERNELS`' order. `read()` brings every device's counts to the
host (a synchronization) and `reset()` zeroes them. CPU tensors take the
kernels' plain versions and are counted nowhere.
"""

from __future__ import annotations

import torch

KERNELS = ("corner_maps", "hamming_top2", "small_eigh", "svd3", "pose_gn")

_counters: dict[int, torch.Tensor] = {}  # device index -> int64 (len(KERNELS),)


def counters(device) -> torch.Tensor:
    """The counters of a CUDA device, made at first use. They must exist
    before a capture that records a kernel: a program's warm-up run makes
    them."""
    dev = torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    buf = _counters.get(idx)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("launch counters first needed inside a capture: run the captured "
                               "function once before capturing it")
        with torch.inference_mode(False):  # a normal tensor: `reset` runs in and out of it
            buf = _counters[idx] = torch.zeros(len(KERNELS), dtype=torch.int64,
                                               device=f"cuda:{idx}")
    return buf


def pointer(name: str, device) -> int:
    """The device address of kernel `name`'s counter, for its launch."""
    return counters(device).data_ptr() + 8 * KERNELS.index(name)


def read() -> dict[str, int]:
    """Every kernel's launches since the last `reset`, summed over devices."""
    total = dict.fromkeys(KERNELS, 0)
    for buf in _counters.values():
        for name, n in zip(KERNELS, buf.tolist()):
            total[name] += n
    return total


def count(name: str) -> int:
    """`read()[name]`."""
    return read()[name]


def reset() -> None:
    """Every counter to 0 (in place: captured programs keep their address)."""
    for buf in _counters.values():
        buf.zero_()
