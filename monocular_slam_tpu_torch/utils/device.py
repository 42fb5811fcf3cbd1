"""Device selection and the float32 precision policy.

The counterpart of `monocular_slam_tpu/utils/precision.py`: the TPU lowers
default-precision f32 matmuls at bf16 input precision, which gave 0.14 rad
SE3-log errors in the small geometry and normal-equation math. On an NVIDIA
card the same trap is TF32 — cuBLAS matmuls under
`torch.set_float32_matmul_precision("high")` and cuDNN convolutions, which
default to TF32. The policy here turns both off once, so every f32 product
in the port is a full-precision product and the `*_hp` helpers of the
reference become plain torch ops.

The port's entry points (`SlamSession`, `render_sequence`, `LoopCloser`,
`vocabulary.load_default`, ...) run on the card unless the caller asks for
the CPU with `device="cpu"`.
"""

from __future__ import annotations

import torch


def apply_precision_policy() -> None:
    """Full-f32 matmuls and convolutions (no TF32). Idempotent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """`torch.device` for `device` (default: the CUDA card), with the
    precision policy applied. Raises when CUDA is asked for, or defaulted
    to, and absent: nothing falls back to the CPU; pass `device="cpu"` to
    run there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run on the CPU)"
        )
    apply_precision_policy()
    return dev
