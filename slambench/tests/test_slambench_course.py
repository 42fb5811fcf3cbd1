"""The benchmark's frozen copies against the program's originals, on the
CPU: the course generator bit for bit, the kernels' work formulas and the
card's peaks."""

import numpy as np
import pytest
import torch

from monocular_slam_tpu_torch import bench as port_bench
from monocular_slam_tpu_torch.datasets import render, synthetic
from monocular_slam_tpu_torch.ops import pyramid
from monocular_slam_tpu_torch.utils import prng, roofline
from slambench import course, work


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
