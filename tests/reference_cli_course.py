"""The JAX reference on the course of `chip_smoke.py`'s cli phase: the long
run's orbit (`render_sequence(seed=19, ang_step=0.05)`), 200 frames at
640x480, rendered by the port on the CPU, through the reference's
`SlamSession` with its loop closer (bundled vocabulary) at the CLI's
default width (1000 features, max_frames 256, max_points 30000). Prints
frames tracked, ATE and closures for each seed given (default 0), with
JAX's default float32 draws (x64 off). It is the yardstick of the cli
phase's ATE limit (`chip_smoke.CLI_MAX_ATE_M`). The reference's own CLI
cannot serve: with `--loop-closure` it attaches the closer after building
the session, whose BoW database is then the one-row placeholder, and the
first keyframe insert fails.

    python tests/reference_cli_course.py [SEED ...]    # ~2-5 min a seed
"""

import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from monocular_slam_tpu.eval import ate  # noqa: E402
from monocular_slam_tpu.retrieval import vocabulary  # noqa: E402
from monocular_slam_tpu.slam.config import FrontendConfig, SlamConfig  # noqa: E402
from monocular_slam_tpu.slam.loop_closer import LoopCloser  # noqa: E402
from monocular_slam_tpu.slam.session import SlamSession  # noqa: E402
from monocular_slam_tpu_torch.datasets import render  # noqa: E402

FRAMES = 200  # chip_smoke.CLI_FRAMES
WH = (640, 480)


def main(seeds) -> None:
    imgs, poses_gt, k = render.render_sequence(seed=19, n_frames=FRAMES, wh=WH, ang_step=0.05,
                                               device="cpu")
    imgs = imgs.to(torch.uint8).numpy()  # the 8-bit frames the CLI decodes
    for seed in seeds:
        cfg = SlamConfig(max_frames=256, max_points=30000, frontend=FrontendConfig(n_features=1000))
        lc = LoopCloser(voc=vocabulary.load_default(), cfg=cfg)
        sess = SlamSession(cfg, seed=seed, run_ba=True, loop_closer=lc)
        for i in range(FRAMES):
            sess.add_frame(imgs[i].astype(np.float32), k, i / 30.0)
        poses, valid, _ = sess.trajectory()
        r = ate.ate(np.asarray(poses)[valid], poses_gt[valid])
        print(f"seed {seed}: tracked {int(valid.sum())}/{FRAMES}, ATE {r.rmse * 100:.3f} cm, "
              f"closures {lc.closures}", flush=True)


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]] or [0])
