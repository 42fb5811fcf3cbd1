"""The port runs without JAX: a fresh interpreter in which `import jax`
fails imports every module of `monocular_slam_tpu_torch` and runs `extract`,
a few session frames, and a prewarmed loop-closing session fed from a frame
buffer on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["monocular_slam_tpu"] = None
import numpy as np, torch
torch.set_num_threads(1)  # beside the suite's other worker processes
import monocular_slam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules if sys.modules[k] is not None)
from monocular_slam_tpu_torch.datasets import render
from monocular_slam_tpu_torch.ops import features
from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
from monocular_slam_tpu_torch.slam.session import SlamSession
imgs, gt, k = render.render_sequence(seed=2, n_frames=3, wh=(160, 120), tex_size=256, device="cpu")
f = features.extract(imgs[0], n_features=200)
assert f.uv.shape == (200, 2) and int(f.valid.sum()) > 20
cfg = SlamConfig(max_frames=4, max_points=500, image_wh=(160, 120),
                 frontend=FrontendConfig(n_features=200))
sess = SlamSession(cfg, seed=0, device="cpu")
for i in range(3):
    sess.add_frame(imgs[i], k, i / 30.0)
poses, valid, _ = sess.trajectory()
assert poses.shape == (3, 3, 4) and np.isfinite(poses).all()
# a few loop-closing frames: detection every frame, the bundled vocabulary
from monocular_slam_tpu_torch.retrieval import vocabulary
from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser
lc = LoopCloser(vocabulary.load_default(device="cpu"), cfg, device="cpu")
sess = SlamSession(cfg, seed=0, loop_closer=lc, device="cpu")
assert sess.prewarm(image=True) > 0
for i in range(3):
    sess.add_frame_from_buffer(imgs.to(torch.uint8), i, k, i / 30.0)
sess.flush()
assert lc._db.shape == (4, 10**4) and sess.stats[-1].cand_j >= -1
q = vocabulary.bow_vector(lc.voc, f.desc_pm1, f.valid)
assert abs(float(q.sum()) - 1.0) < 1e-5
print("modules", len(names))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "modules" in out.stdout


def test_port_sources_name_no_jax():
    """No `import jax` and no import of the JAX package in the port's sources."""
    for path in (ROOT / "monocular_slam_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "import monocular_slam_tpu\n" not in text, path
        assert "from monocular_slam_tpu." not in text and "from monocular_slam_tpu " not in text, path
