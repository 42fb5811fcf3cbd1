"""Parity of the port's core math and geometry with the JAX reference:
SO(3)/SE(3), camera, small linear algebra, triangulation, epipolar RANSAC
and PnP RANSAC (the last two with the reference's own uniforms injected).
Tolerance 1e-5 (float32) unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_slam_tpu.geometry import camera as jcam
from monocular_slam_tpu.geometry import epipolar as jepi
from monocular_slam_tpu.geometry import pnp as jpnp
from monocular_slam_tpu.geometry import se3 as jse3
from monocular_slam_tpu.geometry import so3 as jso3
from monocular_slam_tpu.geometry import triangulate as jtri
from monocular_slam_tpu.utils import linalg as jlin
from monocular_slam_tpu_torch.geometry import camera as tcam
from monocular_slam_tpu_torch.geometry import epipolar as tepi
from monocular_slam_tpu_torch.geometry import pnp as tpnp
from monocular_slam_tpu_torch.geometry import se3 as tse3
from monocular_slam_tpu_torch.geometry import so3 as tso3
from monocular_slam_tpu_torch.geometry import triangulate as ttri
from monocular_slam_tpu_torch.utils import linalg as tlin
from port_util import assert_close, jnp32, np32, random_poses, t32, uniforms
from port_util import one_torch_thread  # noqa: F401 (autouse)

K = np.array([517.3, 516.5, 318.6, 255.3], np.float32)


@pytest.mark.parametrize("scale", [1e-4, 0.5, 3.0])
def test_so3_exp_log(scale):
    rng = np.random.RandomState(0)
    w = (rng.randn(64, 3) * scale).astype(np.float32)
    R_j = jso3.exp(jnp32(w))
    R_t = tso3.exp(t32(w))
    assert_close(R_t, R_j)
    assert_close(tso3.log(R_t), jso3.log(jnp32(np32(R_t))), atol=2e-5)
    assert_close(tso3.matrix_to_quat(R_t), jso3.matrix_to_quat(jnp32(np32(R_t))))
    q = rng.randn(16, 4).astype(np.float32)
    assert_close(tso3.quat_to_matrix(t32(q)), jso3.quat_to_matrix(jnp32(q)))


def test_so3_project():
    rng = np.random.RandomState(1)
    M = (np.eye(3) + 0.1 * rng.randn(8, 3, 3)).astype(np.float32)
    assert_close(tso3.project_to_so3(t32(M)), jso3.project_to_so3(jnp32(M)))


def test_se3_ops():
    rng = np.random.RandomState(2)
    A, B = random_poses(rng, 32), random_poses(rng, 32)
    X = rng.randn(32, 3).astype(np.float32)
    xi = (rng.randn(32, 6) * 0.4).astype(np.float32)
    assert_close(tse3.compose(t32(A), t32(B)), jse3.compose(jnp32(A), jnp32(B)))
    assert_close(tse3.inverse(t32(A)), jse3.inverse(jnp32(A)))
    assert_close(tse3.apply(t32(A), t32(X)), jse3.apply(jnp32(A), jnp32(X)))
    assert_close(tse3.camera_center(t32(A)), jse3.camera_center(jnp32(A)))
    assert_close(tse3.exp(t32(xi)), jse3.exp(jnp32(xi)))
    assert_close(tse3.log(t32(A)), jse3.log(jnp32(A)), atol=3e-5)
    # round trip through the port alone
    assert_close(tse3.log(tse3.exp(t32(xi))), xi, atol=3e-5)
    assert_close(tse3.to_homogeneous(t32(A)), jse3.to_homogeneous(jnp32(A)))
    noisy = A + 0.01 * rng.randn(*A.shape).astype(np.float32)
    assert_close(tse3.normalize(t32(noisy)), jse3.normalize(jnp32(noisy)))


def test_camera():
    rng = np.random.RandomState(3)
    Xc = (rng.randn(100, 3) + [0, 0, 5]).astype(np.float32)
    uv = rng.uniform(0, 640, (100, 2)).astype(np.float32)
    dist = np.array([0.26, -0.95, -0.005, 0.003, 1.16], np.float32)
    assert_close(tcam.project(t32(K), t32(Xc)), jcam.project(jnp32(K), jnp32(Xc)), rtol=1e-6, atol=1e-3)
    assert_close(tcam.normalize_points(t32(K), t32(uv)), jcam.normalize_points(jnp32(K), jnp32(uv)))
    assert_close(tcam.undistort_pixels(t32(K), t32(dist), t32(uv)),
                 jcam.undistort_pixels(jnp32(K), jnp32(dist), jnp32(uv)), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(
        np32(tcam.in_image(t32(uv), 600, 400, 2.0)), np.asarray(jcam.in_image(jnp32(uv), 600, 400, 2.0)))


def test_linalg():
    rng = np.random.RandomState(4)
    A = rng.randn(16, 12, 9).astype(np.float32)
    AtA = np.einsum("bri,brj->bij", A, A).astype(np.float32)
    for method in ("eigh", "inv_iter"):
        vt = np32(tlin.nullspace_vector(t32(AtA), method))
        vj = np32(jlin.nullspace_vector(jnp32(AtA), method))
        # unit eigenvectors agree up to sign
        s = np.sign(np.sum(vt * vj, axis=-1, keepdims=True))
        np.testing.assert_allclose(vt * s, vj, atol=2e-4)
    M = (np.eye(3) * 2 + 0.2 * rng.randn(16, 3, 3)).astype(np.float32)
    assert_close(tlin.inv3x3(t32(M)), jlin.inv3x3(jnp32(M)), rtol=1e-5, atol=1e-5)
    assert_close(tlin.polar_orthogonalize(t32(M)), jlin.polar_orthogonalize(jnp32(M)), atol=1e-5)


def _two_view_scene(rng, n=200, outliers=0.3, noise=0.4):
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (n, 3)).astype(np.float32)
    T1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    T2 = random_poses(rng, 1, rot=0.1, trans=0.4)[0]
    uv1 = np32(jcam.project(jnp32(K), jse3.apply(jnp32(T1), jnp32(X))))
    uv2 = np32(jcam.project(jnp32(K), jse3.apply(jnp32(T2), jnp32(X))))
    uv1 = uv1 + noise * rng.randn(n, 2).astype(np.float32)
    uv2 = uv2 + noise * rng.randn(n, 2).astype(np.float32)
    bad = rng.rand(n) < outliers
    uv2[bad] = rng.uniform(0, 640, (bad.sum(), 2))
    mask = rng.rand(n) > 0.05
    return X, T2, uv1.astype(np.float32), uv2.astype(np.float32), mask


def test_triangulate_parallax():
    rng = np.random.RandomState(5)
    X, T2, uv1, uv2, _ = _two_view_scene(rng, outliers=0.0, noise=0.0)
    T1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    Xt = ttri.triangulate_two_view(t32(K), t32(T1), t32(K), t32(T2), t32(uv1), t32(uv2))
    Xj = jtri.triangulate_two_view(jnp32(K), jnp32(T1), jnp32(K), jnp32(T2), jnp32(uv1), jnp32(uv2))
    assert_close(Xt, Xj, rtol=1e-4, atol=1e-4)
    assert_close(ttri.parallax_cosine(t32(T1), t32(T2), Xt),
                 jtri.parallax_cosine(jnp32(T1), jnp32(T2), jnp32(np32(Xt))))


def test_ransac_fundamental_injected():
    rng = np.random.RandomState(6)
    _, _, uv1, uv2, mask = _two_view_scene(rng)
    key = jax.random.PRNGKey(7)
    rj = jepi.ransac_fundamental(key, jnp32(uv1), jnp32(uv2), jnp.asarray(mask), n_iters=300)
    rt = tepi.ransac_fundamental(None, t32(uv1), t32(uv2), torch.as_tensor(mask), n_iters=300,
                                 u=torch.as_tensor(uniforms(key, 300, len(mask))))
    np.testing.assert_array_equal(np32(rt.inliers), np.asarray(rj.inliers))
    Fj, Ft = np32(rj.F), np32(rt.F)
    s = np.sign(np.sum(Fj * Ft))
    np.testing.assert_allclose(Ft * s, Fj, atol=1e-4)
    assert int(rt.num_inliers) == int(rj.num_inliers) > 100


def test_pnp_ransac_injected():
    rng = np.random.RandomState(8)
    n = 300
    X = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (n, 3)).astype(np.float32)
    T = random_poses(rng, 1, rot=0.2, trans=0.3)[0]
    uv = np32(jcam.project(jnp32(K), jse3.apply(jnp32(T), jnp32(X))))
    uv = (uv + 0.5 * rng.randn(n, 2)).astype(np.float32)
    bad = rng.rand(n) < 0.3
    uv[bad] = rng.uniform(0, 640, (bad.sum(), 2))
    mask = rng.rand(n) > 0.05
    T_init = T.copy()
    T_init[:, 3] += 0.05
    key = jax.random.PRNGKey(9)
    rj = jpnp.solve_pnp_ransac(key, jnp32(X), jnp32(uv), jnp32(K), jnp.asarray(mask),
                               n_iters=256, T_init=jnp32(T_init))
    rt = tpnp.solve_pnp_ransac(None, t32(X), t32(uv), t32(K), torch.as_tensor(mask),
                               n_iters=256, T_init=t32(T_init),
                               u=torch.as_tensor(uniforms(key, 256, n)))
    np.testing.assert_array_equal(np32(rt.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(np32(rt.T), np32(rj.T), atol=1e-4)
    assert int(rt.n_inliers) == int(rj.n_inliers) > 150
