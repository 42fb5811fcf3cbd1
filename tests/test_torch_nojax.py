"""The port runs without JAX, PIL and matplotlib (the card's machine has
none of them): a fresh interpreter in which importing any of them fails
imports every module of `monocular_slam_tpu_torch` and runs `extract`, a few
session frames, a prewarmed loop-closing session fed from a frame buffer,
the CLI on a course written by the port's own exporter, a Poisson mesh and
the sharded BA on a one-rank gloo group, on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["monocular_slam_tpu"] = None
sys.modules["PIL"] = None
sys.modules["matplotlib"] = None
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
# the CLI on an exported course: PNGs written and decoded natively, the
# plot skipped for want of matplotlib
import contextlib, io, json, os, tempfile
from monocular_slam_tpu_torch import run
root = render.export_tum(tempfile.mkdtemp(), seed=3, n_frames=3, wh=(320, 240), tex_size=512,
                         device="cpu")
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert run.main(["--dataset", root, "--end", "3", "--step", "1", "--features", "300",
                     "--max-frames", "16", "--max-points", "3000", "--out",
                     os.path.join(root, "out"), "--device", "cpu"]) == 0
out = buf.getvalue().splitlines()
assert any(line.startswith("[run] plot skipped") for line in out), out
summary = json.loads(out[-1])
assert summary["frames"] == 3 and summary["tracked"] == 3 and "ate_rmse" in summary, summary
assert os.path.exists(os.path.join(root, "out", "trajectory.txt"))
assert not any(k.split(".")[0] in ("PIL", "matplotlib") for k, v in sys.modules.items() if v)
# meshing and the distributed solvers
from monocular_slam_tpu_torch.viz import mesh
d = torch.randn(500, 3, dtype=torch.float64)
d = d / d.norm(dim=1, keepdim=True)
v, t = mesh.poisson_mesh(d, normals=d, depth=4)
assert t.shape[0] > 100 and mesh.mesh_boundary_edges(t) == 0
import torch.distributed as dist
from monocular_slam_tpu_torch.parallel import distributed, sharded_ba
from monocular_slam_tpu_torch.parallel.mesh import make_mesh
assert distributed.initialize(num_processes=1) is False and not dist.is_initialized()
dist.init_process_group("gloo", init_method="file://" + os.path.join(tempfile.mkdtemp(), "rdv"),
                        world_size=1, rank=0)
from monocular_slam_tpu_torch.geometry import camera, se3
from monocular_slam_tpu_torch.optim import ba
poses = torch.as_tensor(poses[:3], dtype=torch.float32)
X = torch.rand((40, 3)) + torch.tensor([0.0, 0.0, 4.0])
kk = torch.as_tensor(np.asarray(k), dtype=torch.float32).reshape(1, 4).repeat(3, 1)
cam, pt = torch.arange(120) // 40, torch.arange(120) % 40
uv = camera.project(kk[cam], se3.apply(poses[cam], X[pt]))
prob = ba.BAProblem(poses, X + 0.01, kk, cam, pt, uv, torch.ones(120),
                    torch.ones(120, dtype=torch.bool), torch.tensor([True, True, False]))
res = sharded_ba.distributed_bundle_adjust(prob, make_mesh(device="cpu"), n_iters=3)
assert float(res.chi2_history[-1]) < float(res.chi2_initial)
dist.destroy_process_group()
# the drivers: each module imported above; their problems and the graft entry
for n in ("benchmarks.step_profile", "benchmarks.compile_profile", "benchmarks.scaling",
          "benchmarks.multihost", "benchmarks.train_vocab", "graft_entry"):
    assert pkg.__name__ + "." + n in names, n
from monocular_slam_tpu_torch import graft_entry
from monocular_slam_tpu_torch.benchmarks import multihost, scaling, train_vocab
assert scaling.ba_problem(4, 50, 10, "cpu").uv.shape == (40, 2)
assert multihost.ba_problem(4, 50, 10, "cpu").uv.shape == (40, 2)
assert scaling.cg_comm_bytes_per_iter(32) == 768
assert graft_entry.dryrun_problem("cpu").uv.shape == (256, 2)
fn, ex = graft_entry.entry("cpu")
assert int(fn(*ex)[1]) > 0
from monocular_slam_tpu_torch.benchmarks import Replayed
chain = Replayed(lambda x: x + 1.0, torch.zeros(()), "cpu")
chain.step()
assert float(chain.current()) == 1.0
aug = train_vocab.augment(np.full((8, 8), 100.0, np.float32), np.random.RandomState(7))
assert aug.shape == (8, 8) and aug.dtype == np.float32
print("modules", len(names))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "modules" in out.stdout


def test_port_sources_name_no_jax():
    """No `import jax`, no import of the JAX package and none of PIL in the
    port's sources."""
    for path in (ROOT / "monocular_slam_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "import PIL" not in text and "from PIL" not in text, path
        assert "import monocular_slam_tpu\n" not in text, path
        assert "from monocular_slam_tpu." not in text and "from monocular_slam_tpu " not in text, path
