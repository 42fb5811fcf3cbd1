"""Parity of the port's host layer with the JAX package: the threefry-drawn
renderer and synthetic sequences, the TUM exporter and loaders, the native
PNG decoder, trajectory/PLY/snapshot IO, ATE/RPE and the compare harness,
depth back-projection, BA logs, the stage timer, roofline arithmetic and
the plots. Inputs come from numpy seeds; the reference's random data is
drawn with `jax_enable_x64` off, as the JAX package runs outside the tests."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from monocular_slam_tpu import native as jnative
from monocular_slam_tpu.datasets import kitti as jkitti
from monocular_slam_tpu.datasets import middlebury as jmid
from monocular_slam_tpu.datasets import render as jrender
from monocular_slam_tpu.datasets import synthetic as jsyn
from monocular_slam_tpu.datasets import tum as jtum
from monocular_slam_tpu.eval import ate as jate
from monocular_slam_tpu.eval import compare as jcompare
from monocular_slam_tpu.io import ply as jply
from monocular_slam_tpu.io import snapshot as jsnap
from monocular_slam_tpu.io import trajectory as jtraj
from monocular_slam_tpu.slam import depth as jdepth
from monocular_slam_tpu.slam import state as jstate
from monocular_slam_tpu.slam.config import FrontendConfig, SlamConfig
from monocular_slam_tpu.utils import profiling as jprof
from monocular_slam_tpu.utils import roofline as jroof
from monocular_slam_tpu_torch import native
from monocular_slam_tpu_torch.datasets import kitti, middlebury, render, synthetic, tum
from monocular_slam_tpu_torch.eval import ate, compare
from monocular_slam_tpu_torch.io import ply, snapshot, trajectory
from monocular_slam_tpu_torch.slam import depth
from monocular_slam_tpu_torch.slam import state as tstate
from monocular_slam_tpu_torch.utils import prng, profiling, roofline
from monocular_slam_tpu_torch.viz import plots
from port_util import one_torch_thread  # noqa: F401 (autouse)

COURSE = dict(n_frames=4, wh=(160, 120))


@pytest.fixture(scope="module")
def course():
    """The port's render of `PRNGKey(3)`'s course, 4 frames at 160x120."""
    imgs, poses, k = render.render_sequence(seed=3, device="cpu", **COURSE)
    return imgs.numpy(), poses, k


# --- renderer -------------------------------------------------------------------

def test_texture_matches_reference():
    for seed in (0, 7):
        with jax.enable_x64(False):
            ref = np.asarray(jrender._texture(jax.random.PRNGKey(seed), 256))
        out = render.texture(prng.PRNGKey(seed), 256, device="cpu").numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-2)


def test_render_sequence_matches_reference(course):
    imgs, poses, k = course
    with jax.enable_x64(False):
        ref, ref_poses, ref_k = jrender.render_sequence(jax.random.PRNGKey(3), **COURSE)
    ref8 = np.clip(ref, 0, 255).astype(np.uint8).astype(np.int32)
    diff = np.abs(imgs.astype(np.int32) - ref8)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    np.testing.assert_array_equal(poses, np.asarray(ref_poses))
    np.testing.assert_array_equal(k, ref_k)


# --- synthetic sequences ---------------------------------------------------------

def test_feature_sequence_matches_reference():
    with jax.enable_x64(False):
        ref = jsyn.feature_sequence(jax.random.PRNGKey(0), n_frames=6)
    out = synthetic.feature_sequence(prng.PRNGKey(0), n_frames=6, device="cpu")
    np.testing.assert_array_equal(out.poses_gt, np.asarray(ref.poses_gt))
    np.testing.assert_array_equal(out.points_gt, np.asarray(ref.points_gt))
    for a, b in zip(out.frames, ref.frames):
        np.testing.assert_array_equal(a.desc.numpy(), np.asarray(b.desc).view(np.int32))
        np.testing.assert_array_equal(a.desc_pm1.numpy(), np.asarray(b.desc_pm1))
        np.testing.assert_array_equal(a.valid.numpy(), np.asarray(b.valid))
        v = a.valid.numpy()
        np.testing.assert_allclose(a.uv.numpy()[v], np.asarray(b.uv)[v], rtol=0, atol=1e-4)
    assert all(int(f.valid.sum()) > 100 for f in out.frames)


def test_pack_bits_matches_reference():
    bits = np.random.RandomState(0).rand(5, 3, 256) > 0.5
    np.testing.assert_array_equal(synthetic._pack_bits(bits), np.asarray(jsyn._pack_bits(bits)))


def test_textured_sequence_matches_reference():
    with jax.enable_x64(False):
        ref_imgs, ref_poses, ref_k = jsyn.textured_sequence(jax.random.PRNGKey(5), n_frames=4)
    imgs, poses, k = synthetic.textured_sequence(prng.PRNGKey(5), n_frames=4, device="cpu")
    for a, b in zip(imgs, ref_imgs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-3)
    np.testing.assert_allclose(poses, np.asarray(ref_poses), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(k, np.asarray(ref_k))


# --- export and the TUM loader ----------------------------------------------------

def _assert_same_tum(root):
    a, b = tum.load(root), jtum.load(root)
    assert len(a.frames) == len(b.frames)
    np.testing.assert_array_equal(a.k, b.k)
    assert a.wh == b.wh
    for fa, fb in zip(a.frames, b.frames):
        assert fa.timestamp == fb.timestamp
        np.testing.assert_array_equal(fa.pose_gt, fb.pose_gt)
    for i in range(len(a.frames)):
        np.testing.assert_array_equal(a.load_image(i), b.load_image(i))
    batch = a.load_images_batch(range(len(a.frames)), n_threads=2)
    for i, img in enumerate(batch):
        np.testing.assert_array_equal(img, b.load_image(i))
    return a


def test_export_tum_cross_loads(tmp_path, course, monkeypatch):
    """The port's export loads through both packages' `tum.load` with the
    rendered pixels; the reference's exporter, given the same frames,
    writes the same text files and pixels, which the port loads."""
    imgs, poses, k = course
    mine = render.write_tum(str(tmp_path / "port"), imgs, poses, k)
    seq = _assert_same_tum(mine)
    for i in range(len(imgs)):
        np.testing.assert_array_equal(seq.load_image(i), imgs[i])
        np.testing.assert_allclose(seq.frames[i].pose_gt, poses[i], rtol=0, atol=2e-6)

    monkeypatch.setattr(jrender, "render_sequence", lambda key, **kw: (imgs, poses, k))
    theirs = jrender.export_tum(str(tmp_path / "ref"), n_frames=len(imgs), wh=COURSE["wh"])
    _assert_same_tum(theirs)
    for name in ("rgb.txt", "groundtruth.txt", "calib.txt", "VERSION"):
        assert open(os.path.join(mine, name)).read() == open(os.path.join(theirs, name)).read()
    for i in range(len(imgs)):
        np.testing.assert_array_equal(tum.load(theirs).load_image(i), seq.load_image(i))


def test_export_tum_renders(tmp_path):
    root = render.export_tum(str(tmp_path / "d"), seed=2, n_frames=2, wh=(64, 48),
                             tex_size=128, device="cpu")
    seq = tum.load(root)
    assert len(seq.frames) == 2 and seq.wh == (64, 48)
    assert seq.load_image(1).shape == (48, 64)


# --- the native decoder -----------------------------------------------------------

def _pngs(tmp, rng):
    """The formats of tests/test_native_io.py, written by PIL."""
    cases = {
        "gray8": ((rng.rand(37, 53) * 255).astype(np.uint8), 1.0),
        "rgb8": ((rng.rand(40, 30, 3) * 255).astype(np.uint8), 1.0),
        "rgba8": ((rng.rand(25, 31, 4) * 255).astype(np.uint8), 1.0),
        "depth16": ((rng.rand(48, 64) * 30000).astype(np.uint16), 1.0 / 5000.0),
    }
    out = {}
    for name, (arr, scale) in cases.items():
        path = str(tmp / f"{name}.png")
        Image.fromarray(arr).save(path)
        out[name] = (path, arr, scale)
    return out


@pytest.mark.parametrize("fmt", ["gray8", "rgb8", "rgba8", "depth16"])
def test_decoder_matches_reference_and_pil(tmp_path, fmt):
    path, arr, scale = _pngs(tmp_path, np.random.RandomState(0))[fmt]
    img = native.load_png_f32(path, scale16=scale)
    np.testing.assert_array_equal(img, jnative.load_png_f32(path, scale16=scale))
    if fmt in ("gray8", "depth16"):
        np.testing.assert_array_equal(img, arr.astype(np.float32) * np.float32(scale))
    else:
        pil = np.asarray(Image.open(path).convert("L"), np.float32)
        np.testing.assert_allclose(img, pil, rtol=0, atol=0.51)


@pytest.mark.parametrize("hw", [(37, 53), (1, 1), (480, 640)])
def test_png_writer_reads_back(tmp_path, hw):
    arr = (np.random.RandomState(1).rand(*hw) * 255).astype(np.uint8)
    path = str(tmp_path / "w.png")
    native.write_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(native.load_png_f32(path), arr.astype(np.float32))
    with pytest.raises(ValueError):
        native.write_png(path, arr.astype(np.uint16))


def test_batch_and_trajectory_parse_match_reference(tmp_path):
    rng = np.random.RandomState(3)
    paths = []
    for i in range(7):
        p = str(tmp_path / f"b{i}.png")
        native.write_png(p, (rng.rand(32, 48) * 255).astype(np.uint8))
        paths.append(p)
    for a, b in zip(native.load_batch_f32(paths, n_threads=3), jnative.load_batch_f32(paths)):
        np.testing.assert_array_equal(a, b)
    p = tmp_path / "gt.txt"
    rows = rng.randn(50, 8)
    with open(p, "w") as f:
        f.write("# header\n\n")
        for r in rows:
            f.write(" ".join(f"{v:.9f}" for v in r) + "\n")
    np.testing.assert_array_equal(native.parse_trajectory(str(p)),
                                  jnative.parse_trajectory(str(p)))


def test_decoder_raises(tmp_path):
    with pytest.raises(IOError, match="cannot read"):
        native.load_png_f32(str(tmp_path / "missing.png"))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png at all, just text")
    with pytest.raises(IOError, match="not a PNG"):
        native.load_png_f32(str(bad))
    assert native.available()


# --- KITTI and Middlebury loaders ---------------------------------------------------

def test_kitti_loader_matches_reference(tmp_path, course):
    imgs, poses, k = course
    seq_dir = tmp_path / "sequences" / "00"
    (seq_dir / "image_0").mkdir(parents=True)
    (tmp_path / "poses").mkdir()
    for i, img in enumerate(imgs):
        native.write_png(str(seq_dir / "image_0" / f"{i:06d}.png"), img.astype(np.uint8))
    np.savetxt(seq_dir / "times.txt", np.arange(len(imgs)) / 10.0)
    P = np.array([[k[0], 0, k[2], 0], [0, k[1], k[3], 0], [0, 0, 1, 0]])
    (seq_dir / "calib.txt").write_text("P0: " + " ".join(f"{v:.6e}" for v in P.ravel()) + "\n")
    R, t = poses[:, :, :3].astype(np.float64), poses[:, :, 3].astype(np.float64)
    c2w = np.concatenate([R.transpose(0, 2, 1), -np.einsum("fji,fj->fi", R, t)[..., None]], -1)
    np.savetxt(tmp_path / "poses" / "00.txt", c2w.reshape(len(imgs), 12))
    for args in ((0, None, 1), (1, 4, 2)):
        a, b = kitti.load(str(tmp_path), "00", *args), jkitti.load(str(tmp_path), "00", *args)
        assert a.image_paths == b.image_paths
        np.testing.assert_array_equal(a.timestamps, b.timestamps)
        np.testing.assert_array_equal(a.k, b.k)
        np.testing.assert_array_equal(a.poses_gt, b.poses_gt)
        for i in range(len(a.image_paths)):
            np.testing.assert_array_equal(a.load_image(i), b.load_image(i))
    np.testing.assert_allclose(kitti.load(str(tmp_path)).poses_gt, poses, rtol=0, atol=1e-6)


def test_middlebury_loader_matches_reference(tmp_path):
    rng = np.random.RandomState(4)
    lines = []
    for i in range(3):
        name = f"temple{i:04d}.png"
        Image.fromarray((rng.rand(30, 40, 3) * 255).astype(np.uint8)).save(tmp_path / name)
        K = [500.0 + i, 0, 20.0, 0, 505.0, 15.0, 0, 0, 1]
        R = np.linalg.qr(rng.randn(3, 3))[0].ravel()
        t = rng.randn(3)
        lines.append(" ".join([name] + [f"{v:.9g}" for v in (*K, *R, *t)]))
    (tmp_path / "temple_par.txt").write_text(f"{len(lines)}\n" + "\n".join(lines) + "\n")
    for args in ((0, None, 1), (1, 3, 1)):
        a, b = middlebury.load(str(tmp_path), *args), jmid.load(str(tmp_path), *args)
        assert a.image_paths == b.image_paths
        np.testing.assert_array_equal(a.k, b.k)
        np.testing.assert_array_equal(a.poses_gt, b.poses_gt)
        for i in range(len(a.image_paths)):
            # the port decodes colour as 0.299 R + 0.587 G + 0.114 B in float,
            # PIL's convert("L") in integers
            np.testing.assert_allclose(a.load_image(i), b.load_image(i), rtol=0, atol=0.51)


# --- trajectory, PLY and snapshot files ------------------------------------------------

def test_trajectory_files_cross_read(tmp_path):
    poses = synthetic.arc_trajectory(12).astype(np.float64)
    ts = np.arange(12) * 0.1
    valid = np.ones(12, bool)
    valid[[3, 7]] = False
    trajectory.write_tum(str(tmp_path / "a.txt"), poses, ts, valid)
    jtraj.write_tum(str(tmp_path / "b.txt"), poses, ts, valid)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    for reader in (trajectory.read_tum, jtraj.read_tum):
        t2, p2 = reader(str(tmp_path / "a.txt"))
        np.testing.assert_allclose(t2, ts[valid], atol=1e-6)
        np.testing.assert_allclose(p2, poses[valid], atol=1e-7)


def test_ply_files_cross_read(tmp_path):
    rng = np.random.RandomState(0)
    xyz = rng.randn(100, 3)
    rgb = (rng.rand(100, 3) * 255).astype(np.uint8)
    ply.write_ply_points(str(tmp_path / "a.ply"), xyz, rgb)
    jply.write_ply_points(str(tmp_path / "b.ply"), xyz, rgb)
    assert (tmp_path / "a.ply").read_text() == (tmp_path / "b.ply").read_text()
    np.testing.assert_array_equal(ply.read_ply_points(str(tmp_path / "a.ply")),
                                  jply.read_ply_points(str(tmp_path / "a.ply")))
    faces = np.array([[0, 1, 2], [2, 3, 0]])
    ply.write_ply_mesh(str(tmp_path / "m.ply"), xyz[:4], faces)
    for reader in (ply.read_ply_mesh, jply.read_ply_mesh):
        v, f = reader(str(tmp_path / "m.ply"))
        np.testing.assert_allclose(v, xyz[:4], atol=1e-6)
        np.testing.assert_array_equal(f, faces)


def _filled_state_np(seed=0):
    """Numpy fields of a small SlamState with random contents."""
    cfg = SlamConfig(max_frames=6, max_points=40, frontend=FrontendConfig(n_features=16))
    d = tstate.state_to_numpy(tstate.empty_state(cfg))
    rng = np.random.RandomState(seed)
    d["poses"] = rng.randn(*d["poses"].shape).astype(np.float32)
    d["pose_valid"] = rng.rand(6) > 0.5
    d["desc"] = rng.randint(0, 2**32, d["desc"].shape, dtype=np.uint64).astype(np.uint32)
    d["desc_pm1"] = (rng.rand(*d["desc_pm1"].shape) > 0.5).astype(np.int8) * 2 - 1
    d["feat_point"] = rng.randint(-1, 40, d["feat_point"].shape).astype(np.int32)
    d["points"] = rng.randn(40, 3).astype(np.float32)
    d["point_valid"] = rng.rand(40) > 0.3
    d["n_points"] = np.int32(d["point_valid"].sum())
    d["n_frames"] = np.int32(5)
    return d


def test_state_snapshots_cross_read(tmp_path):
    d = _filled_state_np()
    st = tstate.state_from_numpy(d, device="cpu")
    snapshot.save_state(str(tmp_path / "port.npz"), st)
    ref = jsnap.load_state(str(tmp_path / "port.npz"))
    for f in jstate.SlamState._fields:
        a = np.asarray(getattr(ref, f))
        assert a.dtype == d[f].dtype, f
        np.testing.assert_array_equal(a, d[f], err_msg=f)
    jsnap.save_state(str(tmp_path / "ref.npz"), ref)
    back = tstate.state_to_numpy(snapshot.load_state(str(tmp_path / "ref.npz"), device="cpu"))
    for f in d:
        assert back[f].dtype == d[f].dtype, f
        np.testing.assert_array_equal(back[f], d[f], err_msg=f)
    # round trip through the port alone
    again = tstate.state_to_numpy(snapshot.load_state(str(tmp_path / "port.npz"), device="cpu"))
    assert all(np.array_equal(again[f], d[f]) for f in d)


def test_ba_problem_snapshots_cross_read(tmp_path):
    from monocular_slam_tpu.optim.ba import BAProblem as JProblem
    from monocular_slam_tpu_torch.optim.ba import BAProblem

    rng = np.random.RandomState(1)
    fields = dict(
        poses=rng.randn(3, 3, 4).astype(np.float32), points=rng.randn(10, 3).astype(np.float32),
        k=rng.rand(3, 4).astype(np.float32), cam_idx=rng.randint(0, 3, 20).astype(np.int32),
        pt_idx=rng.randint(0, 10, 20).astype(np.int32), uv=rng.randn(20, 2).astype(np.float32),
        info=rng.rand(20).astype(np.float32), valid=rng.rand(20) > 0.2,
        fixed=np.array([True, False, False]))
    snapshot.save_ba_problem(str(tmp_path / "p.npz"),
                             BAProblem(**{f: torch.as_tensor(v) for f, v in fields.items()}))
    ref = jsnap.load_ba_problem(str(tmp_path / "p.npz"))
    jsnap.save_ba_problem(str(tmp_path / "r.npz"), JProblem(**{f: getattr(ref, f) for f in fields}))
    back = snapshot.load_ba_problem(str(tmp_path / "r.npz"), device="cpu")
    for f, v in fields.items():
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), v, err_msg=f)
        np.testing.assert_array_equal(getattr(back, f).numpy(), v, err_msg=f)


# --- evaluation ----------------------------------------------------------------------

def _noisy(poses, rng, scale=1.7, sigma=0.02):
    out = poses.astype(np.float64).copy()
    out[:, :, 3] = out[:, :, 3] * scale + sigma * rng.randn(len(poses), 3)
    return out


def test_rpe_and_compare_match_reference(tmp_path):
    rng = np.random.RandomState(2)
    gt = synthetic.arc_trajectory(40, radius=1.8, ang_step=0.06).astype(np.float64)
    est = _noisy(gt, rng)
    for delta in (1, 3):
        assert abs(ate.rpe(est, gt, delta) - jate.rpe(est, gt, delta)) <= 1e-10
    ts = np.arange(40) / 30.0
    trajectory.write_tum(str(tmp_path / "est.txt"), est, ts + 1e-4)
    trajectory.write_tum(str(tmp_path / "gt.txt"), gt, ts)
    a = compare.compare(str(tmp_path / "est.txt"), str(tmp_path / "gt.txt"))
    b = jcompare.compare(str(tmp_path / "est.txt"), str(tmp_path / "gt.txt"))
    assert a.keys() == b.keys() and a["n_associated"] == b["n_associated"] == 40
    for key in a:
        assert abs(a[key] - b[key]) <= 1e-10, key
    ia, ib = compare.associate_trajectories(ts[::2], None, ts, None)
    ja, jb = jcompare.associate_trajectories(ts[::2], None, ts, None)
    np.testing.assert_array_equal(ia, ja)
    np.testing.assert_array_equal(ib, jb)


def test_compare_main_prints_json(tmp_path, capsys):
    gt = synthetic.arc_trajectory(10).astype(np.float64)
    ts = np.arange(10) / 30.0
    trajectory.write_tum(str(tmp_path / "a.txt"), gt, ts)
    trajectory.write_tum(str(tmp_path / "b.txt"), gt, ts)
    assert compare.main([str(tmp_path / "a.txt"), str(tmp_path / "b.txt"),
                         "--plot", str(tmp_path / "cmp.png")]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["n_associated"] == 10 and res["ate_rmse"] < 1e-6
    assert (tmp_path / "cmp.png").stat().st_size > 0


# --- depth --------------------------------------------------------------------------------

def test_depth_to_cloud_matches_reference():
    rng = np.random.RandomState(5)
    d = (rng.rand(48, 64) * 6.0).astype(np.float32)
    d[3, 5] = np.nan
    k = np.array([60.0, 61.0, 32.0, 24.0], np.float32)
    T = synthetic.arc_trajectory(3)[2]
    for pose in (None, T):
        X, v = depth.depth_to_cloud(torch.as_tensor(d), k, pose, stride=3)
        jX, jv = jdepth.depth_to_cloud(d, k, pose, stride=3)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_allclose(X.numpy()[v.numpy()], np.asarray(jX)[np.asarray(jv)],
                                   rtol=0, atol=1e-5)
    img = (rng.rand(48, 64) * 255).astype(np.float32)
    a, b = depth.colored_cloud(img, d, k, T, device="cpu"), jdepth.colored_cloud(img, d, k, T)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_allclose(a[0][a[2]], b[0][b[2]], rtol=0, atol=1e-5)


# --- profiling, roofline, plots -----------------------------------------------------------

def test_ba_stats_and_log_match_reference():
    from monocular_slam_tpu_torch.optim import ba

    rng = np.random.RandomState(6)
    F, P = 3, 30
    poses = synthetic.arc_trajectory(F, radius=4.0, ang_step=0.1)
    X = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    cam_idx = np.repeat(np.arange(F), P)
    pt_idx = np.tile(np.arange(P), F)
    Xc = np.einsum("eij,ej->ei", poses[cam_idx, :, :3], X[pt_idx]) + poses[cam_idx, :, 3]
    k = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
    uv = (k[:2] * Xc[:, :2] / Xc[:, 2:] + k[2:] + rng.randn(F * P, 2)).astype(np.float32)
    t = torch.as_tensor
    prob = ba.BAProblem(
        poses=t(poses), points=t(X + 0.05 * rng.randn(P, 3).astype(np.float32)),
        k=t(np.tile(k, (F, 1))), cam_idx=t(cam_idx), pt_idx=t(pt_idx), uv=t(uv),
        info=torch.ones(F * P), valid=torch.ones(F * P, dtype=torch.bool),
        fixed=t(np.array([True, True, False])))
    res = ba.bundle_adjust(prob, n_iters=5)
    as_np = res._replace(**{f: getattr(res, f).numpy() for f in
                            ("chi2_initial", "chi2_history", "lambda_history", "accepted")})
    assert ([dataclasses.astuple(r) for r in profiling.ba_stats(res)]
            == [dataclasses.astuple(r) for r in jprof.ba_stats(as_np)])
    assert profiling.format_ba_log(res, "GBA") == jprof.format_ba_log(as_np, "GBA")
    assert len(profiling.ba_stats(res)) == 5


def test_stage_timer_counts():
    timer = profiling.StageTimer()
    x = torch.ones(4)
    for _ in range(3):
        with timer.stage("extract", block_on=x):
            pass
    with timer.stage("track", block_on={"a": (x, [x])}):
        pass
    assert timer.counts == {"extract": 3, "track": 1}
    assert timer.ms_per_call("extract") >= 0.0 and "x3" in timer.report()


def test_device_trace_writes(tmp_path):
    with profiling.device_trace(str(tmp_path / "tr")):
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("flops,byts,wall", [(1e12, 1e9, 0.1), (1e9, 1e10, 0.01), (0.0, 5e8, 1e-3)])
def test_roofline_arithmetic_matches_reference(flops, byts, wall):
    class Compiled:
        def cost_analysis(self):
            return {"flops": flops, "bytes accessed": byts}

    peaks = roofline.H100_SXM
    ref = jroof.analyze(Compiled(), wall, jroof.DevicePeaks("h100", peaks.peak_flops(), peaks.peak_bw))
    out = roofline.analyze(flops, byts, wall, peaks)
    for name in ("flops", "bytes", "wall_s", "intensity", "mfu", "hbm_frac", "sol_frac"):
        assert getattr(out, name) == pytest.approx(getattr(ref, name), rel=1e-12), name
    assert out.bound == {"mxu": "compute", "hbm": "memory"}[ref.bound]
    assert roofline.analyze(flops, byts, wall, peaks, "int8").mfu == pytest.approx(
        out.mfu * 67e12 / 1979e12)
    assert roofline.device_peaks("cpu") is roofline.CPU_NOMINAL


def test_plots_write_files(tmp_path):
    poses = synthetic.arc_trajectory(20)
    valid = np.ones(20, bool)
    valid[4] = False
    plots.plot_trajectory(str(tmp_path / "t.png"), poses, valid, poses)
    plots.plot_map(str(tmp_path / "m.png"), np.random.RandomState(0).randn(500, 3), poses, valid)
    img = np.random.RandomState(1).rand(40, 50) * 255
    uv = np.random.RandomState(2).rand(10, 2) * 40
    plots.draw_matches(str(tmp_path / "d.png"), img, img, uv, uv + 1.0)
    F = np.array([[0, -1e-3, 0.1], [1e-3, 0, -0.2], [-0.1, 0.2, 1.0]])
    plots.draw_epipolar(str(tmp_path / "e.png"), img, F, uv, uv)
    for name in ("t", "m", "d", "e"):
        assert (tmp_path / f"{name}.png").stat().st_size > 1000
