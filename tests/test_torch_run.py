"""The port's CLI (`monocular_slam_tpu_torch.run`) beside the reference's
(`monocular_slam_tpu.run`): both `run.main`s on one exported 320x240,
12-frame course and on the synthetic feature route. Tracked masks must be
equal and the port's ATE within the rule of `test_torch_slam.py`
(<= max(1.5 ref, ref + 5 mm)); the files it writes must be readable."""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest

from monocular_slam_tpu import run as jrun
from monocular_slam_tpu_torch import run as trun
from monocular_slam_tpu_torch.datasets import render
from monocular_slam_tpu_torch.io import ply, trajectory
from port_util import COURSE_FRAMES, COURSE_KEY, COURSE_WH
from port_util import one_torch_thread  # noqa: F401 (autouse)

SMALL = ["--features", "300", "--max-frames", "16", "--max-points", "3000", "--step", "1"]


def _main(main, argv):
    """Run a CLI's main; returns (exit code, stdout lines, summary dict)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, lines, json.loads(lines[-1])


def _assert_ate_rule(port, ref):
    assert port["ate_rmse"] <= max(1.5 * ref["ate_rmse"], ref["ate_rmse"] + 0.005), (port, ref)


def _tracked_mask(out_dir, stamps):
    ts, _ = trajectory.read_tum(os.path.join(out_dir, "trajectory.txt"))
    return np.isin(np.round(stamps, 6), np.round(ts, 6))


@pytest.fixture(scope="module")
def image_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("course"))
    render.export_tum(root, seed=COURSE_KEY, n_frames=COURSE_FRAMES, wh=COURSE_WH, device="cpu")
    args = ["--dataset", root, "--start", "0", "--end", str(COURSE_FRAMES), *SMALL]
    port = _main(trun.main, [*args, "--out", os.path.join(root, "port"), "--device", "cpu", "-v"])
    ref = _main(jrun.main, [*args, "--out", os.path.join(root, "ref")])
    return root, port, ref


def test_image_route_matches_reference(image_runs):
    root, (rc, lines, port), (jrc, _, ref) = image_runs
    assert rc == 0 and jrc == 0
    assert port["frames"] == ref["frames"] == COURSE_FRAMES
    stamps = np.arange(COURSE_FRAMES) / 30.0
    np.testing.assert_array_equal(_tracked_mask(os.path.join(root, "port"), stamps),
                                  _tracked_mask(os.path.join(root, "ref"), stamps))
    assert port["tracked"] == ref["tracked"] >= COURSE_FRAMES - 1
    _assert_ate_rule(port, ref)
    # --verbose: one line per frame and the kernels' launch counts
    assert sum(line.startswith("[") and "tracked=" in line for line in lines) == COURSE_FRAMES
    counts = json.loads(next(x for x in lines if x.startswith("[run] kernel launches"))
                        .split("launches ", 1)[1])
    assert counts["track_calls"] >= COURSE_FRAMES - 2


def test_image_route_outputs_readable(image_runs):
    root, (_, lines, port), _ = image_runs
    out = os.path.join(root, "port")
    ts, poses = trajectory.read_tum(os.path.join(out, "trajectory.txt"))
    assert len(ts) == port["tracked"] and np.isfinite(poses).all()
    pts = ply.read_ply_points(os.path.join(out, "map.ply"))
    assert pts.shape == (port["map_points"], 3) and np.isfinite(pts).all()
    assert os.path.getsize(os.path.join(out, "trajectory.png")) > 1000
    assert {"fps_incl_compile", "wall_s", "prewarm_s", "rpe"} <= port.keys()
    from monocular_slam_tpu_torch.eval import compare

    res = compare.compare(os.path.join(out, "trajectory.txt"), os.path.join(root, "groundtruth.txt"))
    assert abs(res["ate_rmse"] - port["ate_rmse"]) <= 1e-5


def test_synthetic_route_matches_reference(tmp_path):
    args = ["--dataset", "synthetic", "--end", "10", *SMALL]
    rc, _, port = _main(trun.main, [*args, "--out", str(tmp_path / "port"), "--device", "cpu"])
    # the reference draws its data with jax_enable_x64 off, as outside the tests
    with jax.enable_x64(False):
        jrc, _, ref = _main(jrun.main, [*args, "--out", str(tmp_path / "ref")])
    assert rc == 0 and jrc == 0
    assert port["frames"] == ref["frames"] == 10
    stamps = np.arange(10) / 30.0
    np.testing.assert_array_equal(_tracked_mask(str(tmp_path / "port"), stamps),
                                  _tracked_mask(str(tmp_path / "ref"), stamps))
    assert np.isfinite(port["ate_rmse"]) and port["tracked"] >= 8
    _assert_ate_rule(port, ref)


def test_cli_needs_the_card_unless_told(tmp_path, monkeypatch):
    """Without `--device cpu` the CLI asks for the card and raises without
    one; nothing falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["--dataset", "synthetic", "--end", "2", "--out", str(tmp_path)])
