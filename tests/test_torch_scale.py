"""Parity of the port's scale solvers with the JAX reference on the CPU:
the matrix-free PCG bundle adjustment (`optim/cg_ba.py`), the matrix-free
pose graph (`pose_graph.optimize_cg`), Gauss-Newton and dogleg BA, the
marginal covariances, `refine_pose(solver="lm")` and the robust kernels.

Inputs are numpy draws from a seed. The solvers run in float64 on both
sides (the test session has JAX's x64 on), so the tolerances are those of
float64 arithmetic in a different order unless stated beside an assertion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_slam_tpu.geometry import camera as jcam
from monocular_slam_tpu.geometry import se3 as jse3
from monocular_slam_tpu.optim import ba as jba
from monocular_slam_tpu.optim import cg_ba as jcg
from monocular_slam_tpu.optim import marginal as jmarg
from monocular_slam_tpu.optim import pose_ba as jpba
from monocular_slam_tpu.optim import pose_graph as jpg
from monocular_slam_tpu.optim import robust as jrob
from monocular_slam_tpu_torch.geometry import sim3 as tsim3
from monocular_slam_tpu_torch.optim import ba as tba
from monocular_slam_tpu_torch.optim import cg_ba as tcg
from monocular_slam_tpu_torch.optim import marginal as tmarg
from monocular_slam_tpu_torch.optim import pose_ba as tpba
from monocular_slam_tpu_torch.optim import pose_graph as tpg
from monocular_slam_tpu_torch.optim import robust as trob
from port_util import one_torch_thread  # noqa: F401 (autouse)

K = np.array([517.3, 516.5, 318.6, 255.3])


def _roty(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _ba_problem(seed, n_frames=8, n_points=200, vis=0.6, pix_noise=0.4, noise_poses=0.02,
                noise_points=0.05, n_fixed=1):
    """`tests/test_cg_ba.py:make_problem` with numpy draws, float64: cameras
    stepping along x while turning about y, points in a box at depth ~6,
    sparse visibility, perturbed initial state; the first `n_fixed` poses
    fixed at the truth. Returns (JAX BAProblem, port BAProblem, true poses)."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(-2, 2, (n_points, 3)) + [0, 0, 6.0]
    poses = np.stack([np.concatenate([_roty(0.12 * i), [[-0.3 * i], [0.02 * i], [0.05 * i]]], 1)
                      for i in range(n_frames)])
    uv = np.asarray(jcam.project(jnp.asarray(K), jse3.apply(jnp.asarray(poses)[:, None],
                                                            jnp.asarray(X)[None])))
    uv = uv + pix_noise * rng.randn(*uv.shape)
    cam_idx = np.repeat(np.arange(n_frames), n_points).astype(np.int32)
    pt_idx = np.tile(np.arange(n_points), n_frames).astype(np.int32)
    valid = rng.rand(n_frames * n_points) < vis
    poses0 = np.array(jse3.compose(jse3.exp(jnp.asarray(noise_poses * rng.randn(n_frames, 6))),
                                     jnp.asarray(poses)))
    poses0[:n_fixed] = poses[:n_fixed]
    fixed = np.arange(n_frames) < n_fixed
    args = (poses0, X + noise_points * rng.randn(*X.shape), np.tile(K, (n_frames, 1)), cam_idx,
            pt_idx, uv.reshape(-1, 2), np.ones(n_frames * n_points), valid, fixed)
    return (jba.BAProblem(*(jnp.asarray(a) for a in args)),
            tba.BAProblem(*(torch.as_tensor(a) for a in args)), poses)


def _lin_pair(pj, pt, lam):
    lj = jba._linearize_graph(pj, pj.poses, pj.points, jba.THRESH_HUBER_FULL_BA)
    lt = tba._linearize_graph(pt, pt.poses, pt.points, tba.THRESH_HUBER_FULL_BA)
    return lj, lt, jnp.asarray(lam), torch.tensor(lam, dtype=torch.float64)


def _close(a, b, rtol=1e-8, atol=1e-8):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


# --- cg_ba ------------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 3])
def test_schur_matvec_and_diag_blocks(seed):
    pj, pt, _ = _ba_problem(seed, n_frames=5, n_points=60)
    lj, lt, lamj, lamt = _lin_pair(pj, pt, 3e-3)
    Hj = jnp.linalg.inv(lj["Hll"] + lamj * jnp.eye(3))
    Ht = torch.as_tensor(np.array(Hj))
    x = np.random.RandomState(seed + 10).randn(5, 6)
    for free in (~np.asarray(pj.fixed), np.ones(5, bool)):
        yj = jcg.schur_matvec(pj, lj, Hj, lamj, jnp.asarray(free), jnp.asarray(x))
        yt = tcg.schur_matvec(pt, lt, Ht, lamt, torch.as_tensor(free), torch.as_tensor(x))
        _close(yt, yj)
    _close(tcg.schur_diag_blocks(pt, lt, Ht, lamt), jcg.schur_diag_blocks(pj, lj, Hj, lamj))


def test_cg_solve_matches_reference_and_dense():
    # two fixed poses pin the monocular scale mode: with one, lam = 1e-4
    # alone holds it, and float64 CG rounding moves dxp by ~1e-5 between any
    # two implementations (the reference against its own dense solve too)
    pj, pt, _ = _ba_problem(0, n_fixed=2)
    lj, lt, lamj, lamt = _lin_pair(pj, pt, 1e-4)
    solve_j = jcg.make_cg_solve_fn(max_cg_iters=300, rtol=1e-14)
    solve_t = tcg.make_cg_solve_fn(max_cg_iters=300, rtol=1e-14)
    for a, b in zip(solve_t(pt, lt, lamt), solve_j(pj, lj, lamj)):
        _close(a, b)
    # and the port's dense Schur Cholesky (the reference's own CG-vs-dense
    # tolerances, `tests/test_cg_ba.py`)
    dxp_d, dxl_d, b_d = tba._schur_solve(pt, lt, lamt)
    dxp_c, dxl_c, b_c = solve_t(pt, lt, lamt)
    _close(b_c, b_d, rtol=1e-8, atol=1e-10)
    _close(dxp_c, dxp_d, rtol=1e-5, atol=1e-8)
    _close(dxl_c, dxl_d, rtol=1e-5, atol=1e-8)


def test_pcg_freezes_on_convergence():
    """The fixed trip count does not move a converged solution, and the step
    count stops at convergence (the reference's `lax.cond` freeze)."""
    rng = np.random.RandomState(4)
    A = rng.randn(12, 12)
    A = A @ A.T + 12 * np.eye(12)
    b = rng.randn(2, 6)
    mv = lambda x: (torch.as_tensor(A) @ x.reshape(-1)).reshape(2, 6)  # noqa: E731
    x_a, st_a = tcg.pcg(mv, lambda r: r, torch.as_tensor(b), 40, 1e-12)
    x_b, st_b = tcg.pcg(mv, lambda r: r, torch.as_tensor(b), 80, 1e-12)
    assert int(st_a.n_iters) == int(st_b.n_iters) <= 13 and float(st_a.rel_residual) < 1e-12
    assert torch.equal(x_a, x_b)
    _close(x_a.reshape(-1), np.linalg.solve(A, b.reshape(-1)), rtol=1e-10, atol=1e-12)
    Aj = jnp.asarray(A)
    xj, stj = jcg.pcg(lambda x: (Aj @ x.reshape(-1)).reshape(2, 6), lambda r: r, jnp.asarray(b), 40,
                      1e-12)
    assert int(stj.n_iters) == int(st_a.n_iters)
    _close(x_a, xj, rtol=1e-12, atol=1e-14)


def test_bundle_adjust_cg_matches_reference():
    pj, pt, _ = _ba_problem(4)
    rj = jax.jit(lambda p: jcg.bundle_adjust_cg(p, n_iters=8, max_cg_iters=50))(pj)
    rt = tcg.bundle_adjust_cg(pt, n_iters=8, max_cg_iters=50)
    np.testing.assert_array_equal(rt.accepted.numpy(), np.asarray(rj.accepted))
    _close(rt.chi2_history, rj.chi2_history, rtol=1e-6, atol=0)
    _close(rt.poses, rj.poses, rtol=0, atol=1e-6)
    _close(rt.points, rj.points, rtol=0, atol=1e-6)
    assert float(rt.chi2_history[-1]) < 0.2 * float(rt.chi2_initial)
    np.testing.assert_array_equal(rt.poses[0].numpy(), np.asarray(pj.poses[0]))  # gauge pinned


# --- pose graph -----------------------------------------------------------------------

def _drifted_loop(n=30, drift=0.03, seed=12):
    """`tests/test_pose_graph_cg.py`'s drifted circle with numpy draws (the
    Sim3 chain composed by the port's float64 Sim3 math), and its graph:
    odometry from the drifted estimate, one loop edge n-1 -> 0 measured
    from the truth, weight 20."""
    rng = np.random.RandomState(seed)
    ang = 2 * np.pi * np.arange(n) / n
    R = np.stack([_roty(a) for a in ang])
    c = np.stack([-2.0 * np.sin(ang), np.zeros(n), 2.0 - 2.0 * np.cos(ang)], 1)
    gt = tsim3.from_se3(torch.as_tensor(np.concatenate([R, -(R @ c[:, :, None])], 2)))
    noise = tsim3.exp(torch.as_tensor(np.concatenate([drift * rng.randn(n, 6), np.full((n, 1), 0.01)], 1)))
    est = [gt[0]]
    for i in range(1, n):
        rel = tsim3.compose(gt[i], tsim3.inverse(gt[i - 1]))
        est.append(tsim3.compose(noise[i], tsim3.compose(rel, est[i - 1])))
    est = torch.stack(est).numpy()
    meas = tsim3.compose(gt[n - 1], tsim3.inverse(gt[0]))[None].numpy()
    gj = jpg.sequential_graph(jnp.asarray(est), jnp.ones(n, bool), extra_i=[n - 1], extra_j=[0],
                              extra_meas=jnp.asarray(meas), loop_weight=20.0)
    gt_ = tpg.sequential_graph(torch.as_tensor(est), torch.ones(n, dtype=torch.bool), extra_i=[n - 1],
                               extra_j=[0], extra_meas=torch.as_tensor(meas), loop_weight=20.0)
    return gj, gt_


def test_pose_graph_blocks_and_matvec():
    gj, gt = _drifted_loop()
    delta = 1.0
    lj = jax.jit(lambda g: jpg._linearize_blocks(g, g.vertices, delta))(gj)
    lt = tpg._linearize_blocks(gt, gt.vertices, delta)
    for n in ("r", "Ji", "Jj", "w", "chi2", "b", "D"):
        _close(lt[n], lj[n], rtol=1e-9, atol=1e-9)
    x = np.random.RandomState(0).randn(30, 7)
    free = ~np.asarray(gj.fixed)
    yj = jpg._hessian_matvec(gj, lj, jnp.asarray(1e-3), jnp.asarray(free), jnp.asarray(x))
    yt = tpg._hessian_matvec(gt, lt, torch.tensor(1e-3, dtype=torch.float64), torch.as_tensor(free),
                             torch.as_tensor(x))
    _close(yt, yj)


def test_optimize_cg_matches_reference():
    gj, gt = _drifted_loop()
    delta = 1.0  # Huber on the odometry edges, none on the loop edge
    rj = jax.jit(lambda g: jpg.optimize_cg(g, n_iters=12, max_cg_iters=100, huber_delta=delta))(gj)
    rt = tpg.optimize_cg(gt, n_iters=12, max_cg_iters=100, huber_delta=delta)
    assert int(rt.n_iters_run) == int(rj.n_iters_run)
    _close(rt.chi2_history, rj.chi2_history, rtol=1e-6, atol=1e-12)
    _close(rt.vertices, rj.vertices, rtol=0, atol=1e-6)
    assert float(rt.chi2_history[-1]) < 0.2 * float(rt.chi2_initial)


def test_optimize_cg_matches_dense():
    """Solved to rounding, the CG steps are the dense Cholesky's, so the LM
    runs agree (the reference's CG-vs-dense tolerances); vertex 0 is pinned."""
    _, gt = _drifted_loop()
    delta = 1.0
    rc = tpg.optimize_cg(gt, n_iters=12, max_cg_iters=220, rtol=1e-13, huber_delta=delta)
    rd = tpg.optimize(gt, n_iters=12, huber_delta=delta)
    _close(rc.chi2_history, rd.chi2_history, rtol=1e-5, atol=1e-12)
    _close(rc.vertices, rd.vertices, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(rc.vertices[0].numpy(), gt.vertices[0].numpy())


# --- Gauss-Newton, dogleg, marginals -----------------------------------------------------

@pytest.mark.parametrize("algorithm,kw", [("lm", {}), ("gn", {}), ("dogleg", {}),
                                          ("dogleg", {"radius0": 0.01})])
def test_bundle_adjust_with(algorithm, kw):
    """Same accept flags, chi2 and lambda (dogleg: radius) histories and
    states; a small initial radius drives the dogleg's steepest-descent and
    blended steps. Two fixed poses pin the 7-dof monocular gauge (GN and
    dogleg have no damping to hold the scale mode)."""
    pj, pt, _ = _ba_problem(40, n_frames=5, n_points=80, vis=0.8, pix_noise=0.3, noise_poses=0.01,
                            noise_points=0.02, n_fixed=2)
    rj = jba.bundle_adjust_with(algorithm, pj, n_iters=12, **kw)
    rt = tba.bundle_adjust_with(algorithm, pt, n_iters=12, **kw)
    np.testing.assert_array_equal(rt.accepted.numpy(), np.asarray(rj.accepted))
    assert int(rt.n_iters_run) == int(rj.n_iters_run)
    _close(rt.chi2_history, rj.chi2_history, rtol=1e-9, atol=0)
    _close(rt.lambda_history, rj.lambda_history, rtol=1e-9, atol=0)
    _close(rt.poses, rj.poses, rtol=0, atol=1e-10)
    _close(rt.points, rj.points, rtol=0, atol=1e-10)
    assert float(rt.chi2_history[-1]) < 0.8 * float(rt.chi2_initial)


def test_hessian_vecprod():
    pj, pt, _ = _ba_problem(2, n_frames=4, n_points=50)
    lj, lt, _, _ = _lin_pair(pj, pt, 0.0)
    rng = np.random.RandomState(2)
    xp, xl = rng.randn(4, 6), rng.randn(50, 3)
    for a, b in zip(tba._hessian_vecprod(pt, lt, torch.as_tensor(xp), torch.as_tensor(xl)),
                    jba._hessian_vecprod(pj, lj, jnp.asarray(xp), jnp.asarray(xl))):
        _close(a, b)


def test_marginal_covariance():
    pj, pt, _ = _ba_problem(8, n_frames=4, n_points=40, vis=0.9, pix_noise=0.3, n_fixed=2)
    res = jba.bundle_adjust(pj, n_iters=10)
    pj = pj._replace(poses=res.poses, points=res.points)
    pt = pt._replace(poses=torch.as_tensor(np.array(res.poses)),
                     points=torch.as_tensor(np.array(res.points)))
    for damping in (0.0, 1e-9):
        mj = jmarg.marginal_covariance(pj, damping=damping)
        mt = tmarg.marginal_covariance(pt, damping=damping)
        for n in ("pose_ok", "point_ok"):
            np.testing.assert_array_equal(getattr(mt, n).numpy(), np.asarray(getattr(mj, n)))
        for n in ("pose_cov", "point_cov", "pose_cov_full"):
            a, b = getattr(mt, n).numpy(), np.asarray(getattr(mj, n))
            _close(a, b, rtol=1e-7, atol=1e-7 * np.abs(b).max())
    assert mt.pose_ok.numpy().tolist() == [False, False, True, True]
    assert (np.linalg.eigvalsh(mt.pose_cov[2].numpy()) > 0).all()


# --- motion-only BA, LM --------------------------------------------------------------------

@pytest.mark.parametrize("n_rounds", [1, 3])
def test_refine_pose_lm(n_rounds):
    rng = np.random.RandomState(3 + n_rounds)
    n = 300
    X = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (n, 3))
    T = np.concatenate([_roty(0.1), [[0.1], [-0.05], [0.2]]], 1)
    uv = np.array(jcam.project(jnp.asarray(K), jse3.apply(jnp.asarray(T), jnp.asarray(X))))
    uv = uv + 0.7 * rng.randn(n, 2)
    uv[rng.rand(n) < 0.2] += 40.0
    w = (rng.rand(n) > 0.1).astype(np.float64)
    T0 = np.array(jse3.compose(jse3.exp(jnp.asarray(0.02 * rng.randn(6))), jnp.asarray(T)))
    args = (T0, X, uv, K, w)
    rj = jpba.refine_pose(*(jnp.asarray(a) for a in args), n_rounds=n_rounds)  # solver="lm"
    rt = tpba.refine_pose(*(torch.as_tensor(a) for a in args), n_rounds=n_rounds)
    _close(rt.T, rj.T, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    _close(rt.chi2, rj.chi2, rtol=1e-9)
    assert int(rt.n_inliers) > 200
    # the LM default differs from the tracker's GN rounds
    rg = tpba.refine_pose(*(torch.as_tensor(a) for a in args), n_rounds=n_rounds, solver="gn")
    assert not torch.equal(rg.T, rt.T)
    with pytest.raises(ValueError):
        tpba.refine_pose(*(torch.as_tensor(a) for a in args), solver="dogleg")


# --- robust kernels ------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cauchy", "tukey", "pseudo_huber", "saturated", "dcs",
                                  "scale_delta", "none_"])
def test_robust_kernel(name):
    e2 = np.concatenate([np.random.RandomState(5).rand(200) * 30, [0.0, 4.0, 5.76]])
    delta = 2.4
    if name == "scale_delta":
        got = trob.scale_delta(trob.cauchy, torch.as_tensor(e2), delta)
        ref = jrob.scale_delta(jrob.cauchy, jnp.asarray(e2), delta)
    else:
        got = getattr(trob, name)(torch.as_tensor(e2), delta)
        ref = getattr(jrob, name)(jnp.asarray(e2), delta)
    for a, b in zip(got, ref):
        _close(a, b, rtol=1e-12, atol=1e-12)
    assert set(trob.KERNELS) == set(jrob.KERNELS)
