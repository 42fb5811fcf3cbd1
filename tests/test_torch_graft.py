"""The port's graft entry (`monocular_slam_tpu_torch/graft_entry.py`)
against the reference's `__graft_entry__.py` on the CPU: `entry()`'s
tracking step (frame 3 of the bootstrapped 6-frame, 128-feature,
512-point state from keys 0/1/2) gives the reference's PnP inlier count
and its poses to 2e-3 (`test_torch_slice.py::test_track_step`'s
tolerance), and `dryrun_problem` is the reference's BA problem from the
same keys. `dryrun_multichip(2)` on two gloo ranks is in
`test_torch_scaling.py`. The reference runs with x64 off, as outside the
tests, so that its draws are the port's float32 ones."""

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as jgraft
from monocular_slam_tpu.geometry import camera, se3, so3
from monocular_slam_tpu_torch import graft_entry
from port_util import one_torch_thread  # noqa: F401 (autouse)


def test_entry_tracks_like_reference():
    fn, (st, key) = graft_entry.entry("cpu")
    poses, n_inl = fn(st, key)
    with jax.enable_x64(False):
        jfn, jargs = jgraft.entry()
        jposes, jn = jax.jit(jfn)(*jargs)
    assert int(n_inl) == int(jn) > 0
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=2e-3)
    np.testing.assert_array_equal(key, np.asarray(jargs[1]))


def test_dryrun_problem_is_the_reference():
    F, P = 4, 64
    with jax.enable_x64(False):
        X = jax.random.uniform(jax.random.PRNGKey(0), (P, 3), minval=-2, maxval=2) + jnp.array(
            [0, 0, 5.0])
        k = jnp.array([300.0, 300.0, 160.0, 120.0])
        poses = jnp.stack([se3.from_Rt(so3.exp(jnp.array([0.0, 0.1 * i, 0.0])),
                                       jnp.array([-0.3 * i, 0.0, 0.0])) for i in range(F)])
        uv = camera.project(k, se3.apply(poses[:, None], X[None])).reshape(-1, 2)
        poses0 = se3.compose(se3.exp(0.01 * jax.random.normal(jax.random.PRNGKey(1), (F, 6))),
                             poses).at[0].set(poses[0])
        pts = X + 0.05 * jax.random.normal(jax.random.PRNGKey(2), X.shape)
    prob = graft_entry.dryrun_problem("cpu")
    for got, want in ((prob.poses, poses0), (prob.points, pts), (prob.uv, uv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(prob.cam_idx.numpy(), np.repeat(np.arange(F), P))
    np.testing.assert_array_equal(prob.pt_idx.numpy(), np.tile(np.arange(P), F))
    assert prob.fixed.tolist() == [True, False, False, False]
