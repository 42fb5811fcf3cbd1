"""The benchmark's frozen copies against the program's originals, on the
CPU: the course generator bit for bit, the lens model, the kernels' work
formulas and the card's peaks."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from monocular_slam_tpu_torch import bench as port_bench
from monocular_slam_tpu_torch.datasets import render, synthetic
from monocular_slam_tpu_torch.geometry import camera as port_camera
from monocular_slam_tpu_torch.ops import pyramid
from monocular_slam_tpu_torch.utils import prng, roofline
from slambench import course, work
from slambench.reference import camera

REPO = Path(__file__).resolve().parents[2]
EUROC = json.loads((REPO / "slambench/configs/euroc_mav.json").read_text())["camera"]


@pytest.mark.parametrize("seed", [11, 19, 2**31 + 12345])
def test_threefry_is_the_ports(seed):
    key = course.prng_key(seed)
    np.testing.assert_array_equal(key, prng.PRNGKey(seed))
    np.testing.assert_array_equal(course.split(key, 10), prng.split(key, 10))
    np.testing.assert_array_equal(course.uniform(key, (7, 33)), prng.uniform(key, (7, 33)))


@pytest.mark.parametrize("seed,step", [(11, 0.06), (19, 0.05)])  # the bench's course, long_run's
def test_course_is_the_ports_render_sequence(seed, step):
    wh, n = (96, 72), 4
    k = render.SYNTH_K * np.array([wh[0] / 640, wh[1] / 480] * 2)
    frames, gt = course.render(seed, n, [[0, step]], wh, k, "cpu", tex_size=128)
    ref, ref_gt, _ = render.render_sequence(seed=seed, n_frames=n, wh=wh, ang_step=step,
                                            tex_size=128, device="cpu")
    np.testing.assert_array_equal(gt, ref_gt)
    np.testing.assert_array_equal(frames, ref.numpy().astype(np.uint8))


def test_segmented_orbit():
    poses = course.orbit_poses(100, [[40, 0.0136], [0, 0.0035]])
    np.testing.assert_array_equal(poses[:40], synthetic.arc_trajectory(40, radius=1.8,
                                                                        ang_step=0.0136))
    ang = course.orbit_angles(100, [[40, 0.0136], [0, 0.0035]])
    np.testing.assert_allclose(np.diff(ang), [0.0136] * 40 + [0.0035] * 59, rtol=1e-9)
    c = -np.einsum("nji,nj->ni", poses[..., :3].astype(np.float64), poses[..., 3])
    np.testing.assert_allclose(np.hypot(c[:, 0], c[:, 2]), 1.8, rtol=1e-6)


@pytest.mark.parametrize("cell", ["tum1_vga.desk30", "kitti_wide.orbit10"])
def test_pinhole_cells_render_as_before(cell):
    """A zero lens leaves the course the pinhole's: each existing cell's
    first frames, with `dist` None and all zero, are the port's pinhole
    render of the same room, camera and step (textures at a CPU size)."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    w = next(w for w in spec["workloads"] if w["name"] == cell)
    conf = json.loads((REPO / f"slambench/configs/{w['config']}.json").read_text())
    traffic = json.loads((REPO / f"slambench/traffic/{w['traffic']}.json").read_text())
    cam, wh, n = conf["camera"], tuple(conf["slam"]["image_wh"]), 2
    assert camera.coefficients(cam) is None
    k = np.array([cam["fx"], cam["fy"], cam["cx"], cam["cy"]], np.float32)
    ref, ref_gt, _ = render.render_sequence(seed=traffic["scene_seed"], n_frames=n, wh=wh,
                                            ang_step=traffic["segments"][0][1], tex_size=64,
                                            device="cpu", k=k)
    for dist in (None, np.zeros(5)):
        frames, gt = course.render(traffic["scene_seed"], n, traffic["segments"], wh, k, "cpu",
                                   tex_size=64, dist=dist)
        np.testing.assert_array_equal(gt, ref_gt)
        np.testing.assert_array_equal(frames, ref.numpy().astype(np.uint8))


def test_reference_lens_is_the_ports():
    """The frozen radtan model is the port's `distort_radtan` and, at the
    port's 10 steps, its `undistort_radtan`, to float32 rounding."""
    dist = camera.coefficients(EUROC)
    xy = np.random.default_rng(3).uniform(-0.8, 0.8, (500, 2)) * [1.0, 0.6]
    port_d = port_camera.distort_radtan(torch.tensor(dist, dtype=torch.float32),
                                        torch.tensor(xy, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(camera.distort(dist, xy), port_d, rtol=0, atol=2e-6)
    xy_d = camera.distort(dist, xy)
    port_u = port_camera.undistort_radtan(torch.tensor(dist, dtype=torch.float32),
                                          torch.tensor(xy_d, dtype=torch.float32)).numpy()
    ours, n, _ = camera.undistort(dist, xy_d, iters=10)
    assert n == 10
    np.testing.assert_allclose(ours, port_u, rtol=0, atol=2e-6)
    conv, n, step = camera.undistort(dist, xy_d)
    assert step < camera.TOL and n < camera.MAX_ITER
    np.testing.assert_allclose(conv, xy, rtol=0, atol=1e-12)


def test_lens_round_trip():
    """A world point on a rendered pixel's ray: its true pinhole pixel,
    distorted by the frozen model, lands on that pixel's centre within
    1e-3 px, over every pixel of EuRoC's frame."""
    dist = camera.coefficients(EUROC)
    k = np.array([EUROC[c] for c in ("fx", "fy", "cx", "cy")], np.float32)
    rays = course.lens_rays(k, (752, 480), dist)
    assert rays.shape == (480, 752, 2) and rays.dtype == np.float32
    depth = np.random.default_rng(5).uniform(0.5, 4.0, rays.shape[:2])
    X = np.concatenate([rays * depth[..., None], depth[..., None]], axis=-1)
    k64 = k.astype(np.float64)
    pinhole = X[..., :2] / X[..., 2:]
    uv = camera.distort(dist, pinhole) * k64[:2] + k64[2:]
    ys, xs = np.meshgrid(np.arange(480), np.arange(752), indexing="ij")
    centre = np.stack([xs + 0.5, ys + 0.5], axis=-1)
    assert np.abs(uv - centre).max() < 1e-3
    # the lens bends: the corner rays lie well outside the pinhole's
    assert np.abs(rays[0, 0, 0]) > 1.2 * np.abs((0.5 - k64[2]) / k64[0])


@pytest.mark.parametrize("hw", [(480, 640), (376, 1241), (1000, 1000)])
def test_work_formulas_are_the_ports(hw):
    for lv in range(8):
        assert work.level_shape(hw, lv) == pyramid.level_shape(hw, lv)
    px = hw[0] * hw[1]
    one_level = work.K1_BYTES_PER_PX * px
    assert one_level == port_bench.K1_BYTES_PER_PX * px
    assert work.k1_bytes(hw, 1) == one_level
    assert work.k1_bytes(hw, 8) == 12 * sum(h * w for h, w in (pyramid.level_shape(hw, lv)
                                                                for lv in range(8)))


def test_k2_formula_is_the_benchs():
    # bench.py counts 2 N M 256 int8 operations a launch for one database
    assert work.k2_ops(1000, 1, 1000) == 2.0 * 1000 * 1000 * 256
    assert work.k2_ops(1000, 5, 1000) == 5 * work.k2_ops(1000, 1, 1000)


def test_peaks_are_the_ports():
    p = work.peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == roofline.H100_SXM.peak_bw
    assert p["int8_ops_per_s"] == roofline.H100_SXM.peak_flops("int8")
    with pytest.raises(KeyError):
        work.peaks("cpu")


def test_reference_extraction_is_the_ports_plain_path():
    from monocular_slam_tpu_torch.ops import features
    from slambench.reference import orb as ref_orb

    frames, _ = course.render(5, 1, [[0, 0.01]], (160, 120),
                              render.SYNTH_K * np.array([0.25] * 4), "cpu", tex_size=128)
    img = torch.as_tensor(frames[0])
    for mode in ("binned", "continuous"):
        port = features.extract(img.float(), n_features=300, n_levels=8, steer_mode=mode)
        ref = ref_orb.extract(img, 300, 8, 20.0, mode)
        torch.testing.assert_close(ref["uv"], port.uv, rtol=0, atol=0)
        assert torch.equal(ref["desc"], port.desc) and torch.equal(ref["valid"], port.valid)
