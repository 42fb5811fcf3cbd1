"""Parity of the port's solvers with the JAX reference: robust kernel,
residual Jacobians, Gauss-Newton motion-only BA, and the windowed LM bundle
adjustment on the (P, F) observation grid."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_slam_tpu.geometry import camera as jcam
from monocular_slam_tpu.geometry import se3 as jse3
from monocular_slam_tpu.optim import pose_ba as jpba
from monocular_slam_tpu.optim import residuals as jres
from monocular_slam_tpu.optim import robust as jrob
from monocular_slam_tpu.optim import window_ba as jwba
from monocular_slam_tpu_torch.optim import pose_ba as tpba
from monocular_slam_tpu_torch.optim import residuals as tres
from monocular_slam_tpu_torch.optim import robust as trob
from monocular_slam_tpu_torch.optim import window_ba as twba
from port_util import assert_close, jnp32, np32, random_poses, t32
from port_util import one_torch_thread  # noqa: F401 (autouse)

K = np.array([517.3, 516.5, 318.6, 255.3], np.float32)


def test_huber_and_linearize():
    rng = np.random.RandomState(0)
    e2 = (rng.rand(200) * 20).astype(np.float32)
    for a, b in zip(trob.huber(t32(e2), 2.4), jrob.huber(jnp32(e2), 2.4)):
        assert_close(a, b)
    T = random_poses(rng, 50)
    X = (rng.randn(50, 3) + [0, 0, 5]).astype(np.float32)
    uv = rng.uniform(0, 600, (50, 2)).astype(np.float32)
    for a, b in zip(tres.linearize(t32(T), t32(X), t32(K), t32(uv)),
                    jres.linearize(jnp32(T), jnp32(X), jnp32(K), jnp32(uv))):
        assert_close(a, b, rtol=1e-5, atol=1e-3)


def _window_problem(seed, F=6, N=48, P=64, noise=0.5, drop=0.2, perturb=0.02, dup=True):
    """`tests/test_window_ba.py`'s construction, with numpy draws: F frames
    x N feature slots over P landmarks, dropout, perturbed initial state;
    optionally one duplicated observation per frame (the dedup rule)."""
    rng = np.random.RandomState(seed)
    X = (rng.uniform(-2, 2, (P, 3)) + [0, 0, 6.0]).astype(np.float32)
    poses = []
    for i in range(F):
        w = np.array([0.0, 0.12 * i, 0.0])
        c, s = np.cos(w[1]), np.sin(w[1])
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses.append(np.concatenate([R, np.array([[-0.3 * i], [0.02 * i], [0.05 * i]])], 1))
    poses = np.asarray(poses, np.float32)
    pt_slot = np.stack([rng.permutation(P)[:N] for _ in range(F)]).astype(np.int32)
    if dup:
        pt_slot[:, 1] = pt_slot[:, 0]
    uv = np32(jcam.project(jnp32(K), jse3.apply(jnp32(poses)[:, None], jnp32(X[pt_slot]))))
    uv = (uv + noise * rng.randn(*uv.shape)).astype(np.float32)
    valid = rng.rand(F, N) > drop
    info = np.ones((F, N), np.float32)
    fixed = np.zeros(F, bool)
    fixed[0] = True
    xi = (perturb * rng.randn(F, 6)).astype(np.float32)
    poses0 = np32(jse3.compose(jse3.exp(jnp32(xi)), jnp32(poses)))
    poses0[0] = poses[0]
    X0 = (X + perturb * rng.randn(*X.shape)).astype(np.float32)
    ks = np.broadcast_to(K, (F, 4)).astype(np.float32)
    return poses0, X0, ks, pt_slot, uv, info, valid, fixed


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_window_bundle_adjust(seed, dtype):
    """Same grid (dedup winners included) and, in float64, the same LM run:
    poses/points within 1e-4, chi2 history rtol 1e-5, same accept flags.
    In float32 the scale gauge left free by one fixed frame lets rounding
    move the points along it, and a late stall decision can flip, so there
    the check is the outcome: chi2 history rtol 1e-4 and convergence."""
    args = _window_problem(seed)
    fd = np.dtype(dtype)
    cast = [a if a.dtype in (bool, np.int32) else a.astype(fd) for a in args]
    jp = jwba.build(*[jnp.asarray(a) for a in cast])
    tp = twba.build(*[torch.as_tensor(a) for a in cast])
    np.testing.assert_array_equal(np32(tp.valid), np.asarray(jp.valid))
    np.testing.assert_array_equal(np32(tp.obs_table), np.asarray(jp.obs_table))
    assert not np.asarray(jp.valid)[:, 1][np.asarray(jp.valid)[:, 0]].any()  # dedup happened
    rj = jwba.bundle_adjust(jp, n_iters=10)
    rt = twba.bundle_adjust(tp, n_iters=10)
    np.testing.assert_allclose(float(rt.chi2_initial), float(rj.chi2_initial), rtol=1e-5)
    if dtype == "float64":
        np.testing.assert_allclose(rt.poses.numpy(), np.asarray(rj.poses), atol=1e-4)
        np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), atol=1e-4)
        np.testing.assert_allclose(rt.chi2_history.numpy(), np.asarray(rj.chi2_history), rtol=1e-5)
        np.testing.assert_array_equal(rt.accepted.numpy(), np.asarray(rj.accepted))
    else:
        np.testing.assert_allclose(np32(rt.chi2_history), np32(rj.chi2_history), rtol=1e-4)
    assert float(rt.chi2_history[-1]) < 0.5 * float(rt.chi2_initial)


def test_refine_pose_gn():
    rng = np.random.RandomState(3)
    n = 400
    X = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (n, 3)).astype(np.float32)
    T = random_poses(rng, 1, rot=0.2, trans=0.3)[0]
    uv = np32(jcam.project(jnp32(K), jse3.apply(jnp32(T), jnp32(X))))
    uv = (uv + 0.7 * rng.randn(n, 2)).astype(np.float32)
    uv[rng.rand(n) < 0.2] += 40.0
    w = (rng.rand(n) > 0.1).astype(np.float32)
    T0 = np32(jse3.compose(jse3.exp(jnp32(0.01 * rng.randn(6))), jnp32(T)))
    rj = jpba.refine_pose(jnp32(T0), jnp32(X), jnp32(uv), jnp32(K), jnp32(w), n_rounds=3, solver="gn")
    rt = tpba.refine_pose(t32(T0), t32(X), t32(uv), t32(K), t32(w), n_rounds=3, solver="gn")
    np.testing.assert_allclose(np32(rt.T), np32(rj.T), atol=1e-4)
    np.testing.assert_array_equal(np32(rt.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(float(rt.chi2), float(rj.chi2), rtol=1e-4)
    assert int(rt.n_inliers) > 250
