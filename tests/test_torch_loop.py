"""Parity of the port's loop-closing slice with the JAX reference on the
CPU. Inputs come from numpy seeds or from a reference session; the RANSAC
stages get the reference's own uniforms. Tolerances: 1e-5 for float32
geometry unless stated beside an assertion, exact for integers and masks.

  - Sim3 exp/log/compose/inverse (small-angle and small-scale branches),
    Horn alignment, the reprojection-gated Sim3 RANSAC and the Euclidean one;
  - the pose graph: edge Jacobians, `_linearize`, `optimize`;
  - `ba.bundle_adjust` (edge-list engine) on a global-BA problem;
  - on the state of a reference loop-closing session: `cull_frames_device`,
    `tracker.relocalize`, `detect_step`, `_correct_impl` and `_gba_impl`;
  - the session: the feature-path revisit of `tests/test_loop_closure.py`
    through both sessions, and the relocalization blackout of
    `tests/test_long_trajectory.py` through the port's;
  - the scale routes: `correct` with a keyframe bucket past 128 vertices
    (`pose_graph.optimize_cg`), `_global_ba` past F*P = 4e6
    (`cg_ba.bundle_adjust_cg`), and the revisit session on both.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_slam_tpu.datasets import synthetic
from monocular_slam_tpu.eval import ate as jate
from monocular_slam_tpu.geometry import alignment as jal
from monocular_slam_tpu.geometry import camera as jcam
from monocular_slam_tpu.geometry import se3 as jse3
from monocular_slam_tpu.geometry import sim3 as jsim3
from monocular_slam_tpu.optim import ba as jba
from monocular_slam_tpu.optim import cg_ba as jcg
from monocular_slam_tpu.optim import pose_graph as jpg
from monocular_slam_tpu.retrieval import vocabulary as jvoc
from monocular_slam_tpu.slam import keyframes as jkf
from monocular_slam_tpu.slam import loop_closer as jlc
from monocular_slam_tpu.slam import state as jstate
from monocular_slam_tpu.slam import tracker as jtrack
from monocular_slam_tpu.slam.config import FrontendConfig as JFrontend
from monocular_slam_tpu.slam.config import SlamConfig as JConfig
from monocular_slam_tpu.slam.session import SlamSession as JSession
from monocular_slam_tpu_torch.eval import ate as tate
from monocular_slam_tpu_torch.geometry import alignment as tal
from monocular_slam_tpu_torch.geometry import sim3 as tsim3
from monocular_slam_tpu_torch.ops import orb
from monocular_slam_tpu_torch.optim import ba as tba
from monocular_slam_tpu_torch.optim import cg_ba as tcg
from monocular_slam_tpu_torch.optim import pose_graph as tpg
from monocular_slam_tpu_torch.retrieval import vocabulary as tvoc
from monocular_slam_tpu_torch.slam import keyframes as tkf
from monocular_slam_tpu_torch.slam import loop_closer as tlc
from monocular_slam_tpu_torch.slam import state as tstate
from monocular_slam_tpu_torch.slam import tracker as ttrack
from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
from monocular_slam_tpu_torch.slam.session import SlamSession as TSession
from port_util import assert_close, jnp32, np32, random_poses, t32, uniforms
from port_util import one_torch_thread  # noqa: F401 (autouse)

K = np.array([517.3, 516.5, 318.6, 255.3], np.float32)


def _xi(rng, n, rot, trans, sig):
    return np.concatenate([rng.uniform(-rot, rot, (n, 3)), rng.uniform(-trans, trans, (n, 3)),
                           rng.uniform(-sig, sig, (n, 1))], 1).astype(np.float32)


# --- Sim3 ------------------------------------------------------------------------

@pytest.mark.parametrize("rot,sig", [(1e-5, 1e-5), (1e-3, 0.3), (0.5, 1e-4), (0.015, 0.017),
                                     (0.03, 0.025), (1.2, 0.4)])
def test_sim3_exp_log_compose(rot, sig):
    """Every branch of `_V_matrix`: small/large angle x small/large scale,
    and both sides of the eps^(1/4) ~ 0.019 threshold."""
    rng = np.random.RandomState(int(rot * 1e5 + sig * 1e3))
    xa, xb = _xi(rng, 32, rot, 0.5, sig), _xi(rng, 32, rot, 0.5, sig)
    Sa_j, Sb_j = jsim3.exp(jnp32(xa)), jsim3.exp(jnp32(xb))
    Sa_t, Sb_t = tsim3.exp(t32(xa)), tsim3.exp(t32(xb))
    assert_close(Sa_t, Sa_j)
    assert_close(tsim3.log(Sa_t), jsim3.log(jnp32(np32(Sa_t))), atol=2e-5)
    assert_close(tsim3.log(Sa_t), xa, atol=5e-5)  # exp/log round trip in the port
    assert_close(tsim3.compose(Sa_t, Sb_t), jsim3.compose(Sa_j, Sb_j))
    assert_close(tsim3.inverse(Sa_t), jsim3.inverse(Sa_j))
    X = rng.randn(32, 3).astype(np.float32)
    assert_close(tsim3.apply(Sa_t, t32(X)), jsim3.apply(Sa_j, jnp32(X)))
    T = random_poses(rng, 32)
    assert_close(tsim3.to_se3(Sa_t), jsim3.to_se3(Sa_j))
    assert_close(tsim3.from_se3(t32(T)), jsim3.from_se3(jnp32(T)))


def _sim3_scene(rng, n=300, outliers=0.25):
    """Map points of two reconstructions of one place: X in the drifted
    frame, Y = S_true(X) in the consistent one, seen by cameras T_x, T_y."""
    T_y = random_poses(rng, 1, rot=0.1, trans=0.3)[0]
    Yc = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (n, 3)).astype(np.float32)
    Y = np32(jse3.apply(jse3.inverse(jnp32(T_y)), jnp32(Yc)))
    S_true = jsim3.exp(jnp32(np.array([0.05, -0.03, 0.08, 0.2, -0.1, 0.15, 0.1], np.float32)))
    X = np32(jsim3.apply(jsim3.inverse(S_true), jnp32(Y)))
    # camera x sees X where camera y sees Y = S(X): T_x = T_y o S, scaled by 1/s
    R, t, s = (np32(a) for a in jsim3.unpack(S_true))
    T_x = np.concatenate([T_y[:, :3] @ R, ((T_y[:, :3] @ t + T_y[:, 3]) / s)[:, None]], 1)
    uv_y = np32(jcam.project(jnp32(K), jse3.apply(jnp32(T_y), jnp32(Y)))) + 0.5 * rng.randn(n, 2)
    uv_x = np32(jcam.project(jnp32(K), jse3.apply(jnp32(T_x), jnp32(X)))) + 0.5 * rng.randn(n, 2)
    bad = rng.rand(n) < outliers
    X[bad] += rng.randn(bad.sum(), 3).astype(np.float32)
    mask = rng.rand(n) > 0.05
    return [a.astype(np.float32) for a in (X, Y, uv_x, uv_y, T_x, T_y)] + [mask]


def test_horn_sim3_batched():
    rng = np.random.RandomState(1)
    X = rng.randn(16, 20, 3).astype(np.float32)
    Y = rng.randn(16, 20, 3).astype(np.float32) * 0.1 + X * 1.7 + 0.3
    w = (rng.rand(16, 20) > 0.3).astype(np.float32)
    assert_close(tal.horn_sim3(t32(X), t32(Y), t32(w)), jal.horn_sim3(jnp32(X), jnp32(Y), jnp32(w)),
                 atol=2e-5)
    assert_close(tal.horn_sim3(t32(X), t32(Y)), jal.horn_sim3(jnp32(X), jnp32(Y)), atol=2e-5)


def test_ransac_sim3_reproj_injected():
    rng = np.random.RandomState(2)
    X, Y, uv_x, uv_y, T_x, T_y, mask = _sim3_scene(rng)
    key = jax.random.PRNGKey(5)
    args_j = [jnp32(a) for a in (X, Y)] + [jnp.asarray(mask)] + [jnp32(a) for a in (uv_x, uv_y, K, K, T_x, T_y)]
    rj = jax.jit(lambda *a: jal.ransac_sim3_reproj(*a, n_iters=128, px_thresh=10.0,
                                                   min_inliers=15))(key, *args_j)
    args_t = [t32(a) for a in (X, Y)] + [torch.as_tensor(mask)] + [t32(a) for a in (uv_x, uv_y, K, K, T_x, T_y)]
    rt = tal.ransac_sim3_reproj(None, *args_t, n_iters=128, px_thresh=10.0, min_inliers=15,
                                u=torch.as_tensor(uniforms(key, 128, len(mask))))
    np.testing.assert_array_equal(np32(rt.inliers), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) > 150 and bool(rt.ok)
    # the polish is four GN steps per anneal stage on float32 Jacobians
    assert_close(rt.S, rj.S, atol=1e-4)


def test_ransac_sim3_euclidean_injected():
    rng = np.random.RandomState(3)
    X, Y, *_, mask = _sim3_scene(rng)
    key = jax.random.PRNGKey(6)
    rj = jal.ransac_sim3(key, jnp32(X), jnp32(Y), jnp.asarray(mask), n_iters=128, thresh=0.05)
    rt = tal.ransac_sim3(None, t32(X), t32(Y), torch.as_tensor(mask), n_iters=128, thresh=0.05,
                         u=torch.as_tensor(uniforms(key, 128, len(mask))))
    np.testing.assert_array_equal(np32(rt.inliers), np.asarray(rj.inliers))
    assert_close(rt.S, rj.S, atol=2e-5)


# --- pose graph --------------------------------------------------------------------

def _graph(rng, F=12, n_loop=3):
    xi = np.cumsum(_xi(rng, F, 0.1, 0.3, 0.02), 0)
    truth = np32(jsim3.exp(jnp32(xi)))
    noisy = np32(jsim3.compose(jsim3.exp(jnp32(_xi(rng, F, 0.02, 0.05, 0.01))), jnp32(truth)))
    li = rng.randint(F // 2, F, n_loop).astype(np.int32)
    lj = rng.randint(0, 3, n_loop).astype(np.int32)
    meas = np32(jsim3.compose(jnp32(truth[li]), jsim3.inverse(jnp32(truth[lj]))))
    valid = np.ones(F, bool)
    valid[F - 2] = False
    ew = np.full(n_loop, 20.0, np.float32)
    ev = np.array([True] * (n_loop - 1) + [False])
    gj = jpg.sequential_graph(jnp32(noisy), jnp.asarray(valid), li, lj, jnp32(meas), jnp32(ew), ev)
    gt = tpg.sequential_graph(t32(noisy), torch.as_tensor(valid), torch.as_tensor(li),
                              torch.as_tensor(lj), t32(meas), t32(ew), torch.as_tensor(ev))
    return gj, gt


def test_pose_graph_jacobians_and_linearize():
    gj, gt = _graph(np.random.RandomState(4))
    S_i, S_j = gj.vertices[gj.i_idx], gj.vertices[gj.j_idx]
    z7 = jnp.zeros(7, jnp.float32)
    Ji_t, Jj_t = tpg.edge_jacobians(gt.vertices[gt.i_idx.long()], gt.vertices[gt.j_idx.long()], gt.meas)
    assert_close(Ji_t, jax.jit(jpg._jac_i)(z7, z7, S_i, S_j, gj.meas), atol=5e-5)
    assert_close(Jj_t, jax.jit(jpg._jac_j)(z7, z7, S_i, S_j, gj.meas), atol=5e-5)
    for delta in (None, 1.0):
        Hj, bj, cj = jax.jit(lambda g, v: jpg._linearize(g, v, delta))(gj, gj.vertices)
        Ht, bt, ct = tpg._linearize(gt, gt.vertices, delta)
        assert_close(Ht, Hj, rtol=1e-4, atol=1e-3)
        assert_close(bt, bj, rtol=1e-4, atol=1e-5)
        assert_close(ct, cj, rtol=1e-5)


@pytest.mark.parametrize("delta", [None, 1.0])
def test_pose_graph_optimize(delta):
    gj, gt = _graph(np.random.RandomState(5))
    rj = jax.jit(lambda g: jpg.optimize(g, n_iters=20, huber_delta=delta))(gj)
    rt = tpg.optimize(gt, n_iters=20, huber_delta=delta)
    assert float(rt.chi2_history[-1]) < 0.1 * float(rt.chi2_initial)
    assert_close(rt.chi2_initial, rj.chi2_initial, rtol=1e-5)
    assert_close(rt.chi2_history[-1], rj.chi2_history[-1], rtol=1e-3, atol=1e-6)
    assert_close(rt.vertices, rj.vertices, atol=1e-4)  # 20 LM steps, float32


# --- global BA (edge-list engine) ----------------------------------------------------

def test_bundle_adjust_global_problem():
    rng = np.random.RandomState(6)
    F, P = 6, 80
    poses = random_poses(rng, F, rot=0.1, trans=0.4)
    pts = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (P, 3)).astype(np.float32)
    cam_idx = np.repeat(np.arange(F), P).astype(np.int32)
    pt_idx = np.tile(np.arange(P), F).astype(np.int32)
    uv = np32(jcam.project(jnp32(K), jse3.apply(jnp32(poses[cam_idx]), jnp32(pts[pt_idx]))))
    uv = (uv + 0.5 * rng.randn(*uv.shape)).astype(np.float32)
    valid = rng.rand(F * P) > 0.2
    info = rng.choice([1.0, 1 / 1.2, 1 / 1.44], F * P).astype(np.float32)
    p0 = poses.copy()
    p0[1:, :, 3] += 0.02 * rng.randn(F - 1, 3).astype(np.float32)
    x0 = (pts + 0.03 * rng.randn(P, 3)).astype(np.float32)
    fixed = np.zeros(F, bool)
    fixed[0] = True
    kk = np.tile(K, (F, 1))
    pj = jba.BAProblem(*(jnp32(a) for a in (p0, x0, kk, cam_idx, pt_idx, uv, info, valid, fixed)))
    pt = tba.BAProblem(*(torch.as_tensor(a) for a in (p0, x0, kk, cam_idx, pt_idx, uv, info, valid, fixed)))
    rj = jba.global_bundle_adjust(pj, n_iters=6)
    rt = tba.global_bundle_adjust(pt, n_iters=6)
    np.testing.assert_array_equal(np32(rt.accepted), np.asarray(rj.accepted))
    assert_close(rt.chi2_history, rj.chi2_history, rtol=1e-4)
    assert_close(rt.poses, rj.poses, atol=2e-5)
    assert_close(rt.points, rj.points, atol=2e-4)


# --- on a reference loop-closing session -------------------------------------------------

N_FRAMES = 46


def _t_features(f) -> orb.Features:
    def conv(x):
        a = np.array(x)
        return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)

    return orb.Features(*[conv(x) for x in f])


@pytest.fixture(scope="module")
def loop_run():
    """The revisit of `tests/test_loop_closure.py` through the reference
    session with a loop closer; its vocabulary, keyframes and final state."""
    seq = synthetic.feature_sequence(jax.random.PRNGKey(1), n_frames=N_FRAMES, n_world_points=900,
                                     n_features=256, pix_noise=0.4, drop_prob=0.08, ang_step=0.14)
    desc = np.concatenate([np.asarray(f.desc_pm1)[np.asarray(f.valid)] for f in seq.frames[:10]])
    jv = jvoc.train(desc, k=8, L=3, seed=0)
    kw = dict(max_frames=64, max_points=6000)
    jcfg = JConfig(frontend=JFrontend(n_features=256), **kw)
    lcfg = dict(min_gap=20, min_score=0.05, consistency=2, run_global_ba=True)
    lc = jlc.LoopCloser(voc=jv, cfg=jcfg, lc=jlc.LoopClosureConfig(**lcfg))
    sess = JSession(jcfg, seed=3, run_ba=True, loop_closer=lc)
    for i, f in enumerate(seq.frames):
        sess.add_frame_features(f, seq.k, seq.timestamps[i])
    poses, valid, _ = sess.trajectory()
    gt = np.asarray(seq.poses_gt)
    return dict(
        seq=seq, jv=jv, jcfg=jcfg, lcfg=lcfg, lc=lc, keyframes=sess.keyframes,
        state={k: np.array(v) for k, v in sess.state._asdict().items()}, db=np.array(lc._db),
        ate=jate.ate(poses[valid], gt[valid]).rmse, valid=valid,
        tcfg=SlamConfig(frontend=FrontendConfig(n_features=256), **kw),
        tv=tvoc.vocabulary_from_numpy([np.asarray(n) for n in jv.nodes], np.asarray(jv.weights),
                                      jv.k, jv.L, device="cpu"),
    )


def _jstate(d):
    return jstate.SlamState(**{k: jnp.asarray(v) for k, v in d.items()})


def _assert_states_close(ts, js, atol):
    got = tstate.state_to_numpy(ts)
    for k, v in js._asdict().items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v.astype(got[k].dtype), err_msg=k)


@pytest.mark.parametrize("redundancy", [0.9, 0.3])
def test_cull_frames_device(loop_run, redundancy):
    kfs = loop_run["keyframes"]
    F = loop_run["jcfg"].max_frames
    flags = np.zeros(F, bool)
    flags[kfs] = True
    protect = np.zeros(F, bool)
    protect[kfs[0]] = True
    protect[kfs[-2:]] = True
    kw = dict(redundancy=redundancy, min_other_obs=3 if redundancy > 0.5 else 1)
    ref = jkf.cull_frames_device(_jstate(loop_run["state"]), jnp.asarray(flags), jnp.asarray(protect),
                                 **kw)
    got = tkf.cull_frames_device(tstate.state_from_numpy(loop_run["state"]), flags, protect, **kw)
    np.testing.assert_array_equal(np32(got), np.asarray(ref))
    if redundancy < 0.5:
        assert np32(got).sum() < flags.sum()  # the check is not vacuous
    host = tkf.cull_frames(tstate.state_from_numpy(loop_run["state"]), flags, **kw)
    np.testing.assert_array_equal(host, jkf.cull_frames(_jstate(loop_run["state"]), flags, **kw))


def test_relocalize_injected(loop_run):
    st = loop_run["state"]
    i = N_FRAMES - 1
    cand = [f for f in loop_run["keyframes"] if f < i - 2][-1]
    key = jax.random.PRNGKey(11)
    jcfg, tcfg = loop_run["jcfg"], loop_run["tcfg"]
    lost = dict(st, pose_valid=st["pose_valid"].copy())
    lost["pose_valid"][i] = False
    rj = jtrack.relocalize(_jstate(lost), i, cand, key, jcfg)
    u = uniforms(key, tcfg.track.pnp_iters, tcfg.frontend.n_features)
    rt = ttrack.relocalize(tstate.state_from_numpy(lost), i, cand, None, tcfg, u=torch.as_tensor(u))
    assert bool(rt.ok) == bool(rj.ok) is True
    assert int(rt.n_inliers) == int(rj.n_inliers) >= tcfg.track.reloc_min_inliers
    # pose through the LO refit's float32 eigh (see PERF.md, open questions)
    _assert_states_close(rt.state, rj.state, atol=2e-3)


@pytest.mark.parametrize("is_kf", [True, False])
def test_detect_step(loop_run, is_kf):
    i = N_FRAMES - 1
    lcfg = jlc.LoopClosureConfig(**loop_run["lcfg"])
    db = loop_run["db"].copy()
    db[i] = 0.0
    dbj, dj = jlc.detect_step(loop_run["jv"], lcfg, jnp.asarray(db), _jstate(loop_run["state"]), i,
                              jnp.asarray(is_kf))
    dbt, dt = tlc.detect_step(loop_run["tv"], tlc.LoopClosureConfig(**loop_run["lcfg"]),
                              torch.as_tensor(db), tstate.state_from_numpy(loop_run["state"]), i, is_kf)
    assert int(dt.best_j) == int(dj.best_j) >= 0 and int(dt.n_cand) == int(dj.n_cand) > 3
    assert_close(dt.score, dj.score, atol=1e-6)
    assert_close(dt.floor, dj.floor, atol=1e-6)
    assert_close(dbt, dbj, atol=1e-7)
    # with a covisibility gate too
    lc2 = dataclasses.replace(lcfg, min_covis=30)
    _, dj2 = jlc.detect_step(loop_run["jv"], lc2, jnp.asarray(db), _jstate(loop_run["state"]), i, False)
    _, dt2 = tlc.detect_step(loop_run["tv"], tlc.LoopClosureConfig(**loop_run["lcfg"], min_covis=30),
                             torch.as_tensor(db), tstate.state_from_numpy(loop_run["state"]), i, False)
    assert (int(dt2.best_j), int(dt2.n_cand)) == (int(dj2.best_j), int(dj2.n_cand))


def _closure_inputs(loop_run):
    i = N_FRAMES - 1
    j = loop_run["keyframes"][1]
    S = np.array(jsim3.exp(jnp32(np.array([0.02, -0.01, 0.03, 0.1, 0.05, -0.08, 0.05], np.float32))))
    return i, j, S


def test_correct_impl(loop_run):
    """The keyframe graph with the new loop edge, LM, non-keyframe and
    map-point propagation (global BA off here; `test_gba_impl` below)."""
    i, j, S = _closure_inputs(loop_run)
    lcfg = dict(loop_run["lcfg"], run_global_ba=False, kf_bucket=32)
    jl = jlc.LoopCloser(voc=loop_run["jv"], cfg=loop_run["jcfg"], lc=jlc.LoopClosureConfig(**lcfg))
    tl = tlc.LoopCloser(loop_run["tv"], loop_run["tcfg"], tlc.LoopClosureConfig(**lcfg), device="cpu")
    # one remembered edge, so the padded loop-edge list is exercised
    edge = (30, 2, np.asarray(jsim3.identity()), 5.0)
    jl.loop_edges.append(edge)
    tl.loop_edges.append(edge)
    kfs = loop_run["keyframes"]
    js, jok = jl.correct(_jstate(loop_run["state"]), i, j, jnp.asarray(S), keyframes=kfs)
    ts, tok = tl.correct(tstate.state_from_numpy(loop_run["state"]), i, j, torch.as_tensor(S),
                         keyframes=kfs)
    assert tok is jok is True
    moved = np.abs(np32(ts.poses) - loop_run["state"]["poses"]).max()
    assert moved > 1e-3  # the correction did move the trajectory
    _assert_states_close(ts, js, atol=2e-4)  # 20 float32 LM steps on the graph
    assert len(tl.loop_edges) == len(jl.loop_edges) == 2
    assert_close(tl.loop_edges[-1][2], jl.loop_edges[-1][2], atol=2e-4)


def test_gba_impl(loop_run):
    lcfg = dict(loop_run["lcfg"], global_ba_iters=4)
    jl = jlc.LoopCloser(voc=loop_run["jv"], cfg=loop_run["jcfg"], lc=jlc.LoopClosureConfig(**lcfg))
    tl = tlc.LoopCloser(loop_run["tv"], loop_run["tcfg"], tlc.LoopClosureConfig(**lcfg), device="cpu")
    st = loop_run["state"]
    F = st["poses"].shape[0]
    kfs = [f for f in loop_run["keyframes"] if st["pose_valid"][f]]
    pad = np.zeros(F, np.int64)
    pad[: len(kfs)] = kfs
    # perturb the keyframe poses so the BA has work to do
    rng = np.random.RandomState(7)
    st = dict(st, poses=st["poses"].copy())
    st["poses"][kfs[1:], :, 3] += 0.01 * rng.randn(len(kfs) - 1, 3).astype(np.float32)
    js = jl._global_ba(_jstate(st), pad.astype(np.int32), len(kfs))
    ts = tl._global_ba(tstate.state_from_numpy(st), torch.as_tensor(pad), len(kfs))
    assert np.abs(np32(ts.poses) - st["poses"]).max() > 1e-3
    _assert_states_close(ts, js, atol=2e-4)


def test_session_loop_revisit(loop_run):
    """The feature-path revisit through the port's session: a closure
    against one of the first keyframes, and an ATE within
    max(1.5 x reference, reference + 5 mm)."""
    seq = loop_run["seq"]
    tcfg = loop_run["tcfg"]
    tl = tlc.LoopCloser(loop_run["tv"], tcfg, tlc.LoopClosureConfig(**loop_run["lcfg"]), device="cpu")
    sess = TSession(tcfg, seed=3, run_ba=True, loop_closer=tl, device="cpu")
    k = np.asarray(seq.k, np.float32)
    for i, f in enumerate(seq.frames):
        sess.add_frame_features(_t_features(f), k, float(seq.timestamps[i]))
    poses, valid, _ = sess.trajectory()
    assert len(tl.closures) >= 1, "no loop closure fired"
    i, j = tl.closures[0]
    assert i - j >= 20 and j <= 8
    assert any(s.loop_closed for s in sess.stats)
    ref = loop_run["ate"]
    r = tate.ate(poses[valid], np.asarray(seq.poses_gt)[valid]).rmse
    assert valid.sum() >= loop_run["valid"].sum() - 2
    assert r <= max(1.5 * ref, ref + 0.005), (r, ref)
    st = sess.stats[-1]
    assert st.cand_n >= 0 and np.isfinite(st.cand_score)


# --- the scale routes -----------------------------------------------------------------

def _count_calls(monkeypatch, module, name):
    """Wrap module.name to count its calls (the JAX closer reaches its
    solvers through module attributes while tracing)."""
    calls = []
    orig = getattr(module, name)

    def counted(*a, **kw):
        calls.append(name)
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_correct_cg_route(loop_run, monkeypatch):
    """`correct` with a 160-vertex keyframe bucket: both closers take the
    matrix-free pose graph (the port at the reference's dense/CG switch,
    128), and the corrected states agree."""
    i, j, S = _closure_inputs(loop_run)
    lcfg = dict(loop_run["lcfg"], run_global_ba=False, kf_bucket=160)
    jl = jlc.LoopCloser(voc=loop_run["jv"], cfg=loop_run["jcfg"], lc=jlc.LoopClosureConfig(**lcfg))
    monkeypatch.setattr(tlc, "POSE_GRAPH_DENSE_MAX", 128)
    tl = tlc.LoopCloser(loop_run["tv"], loop_run["tcfg"], tlc.LoopClosureConfig(**lcfg), device="cpu")
    j_calls = _count_calls(monkeypatch, jpg, "optimize_cg")
    t_calls = _count_calls(monkeypatch, tpg, "optimize_cg")
    kfs = loop_run["keyframes"]
    js, jok = jl.correct(_jstate(loop_run["state"]), i, j, jnp.asarray(S), keyframes=kfs)
    ts, tok = tl.correct(tstate.state_from_numpy(loop_run["state"]), i, j, torch.as_tensor(S),
                         keyframes=kfs)
    assert tok is jok is True and len(j_calls) == len(t_calls) == 1
    assert np.abs(np32(ts.poses) - loop_run["state"]["poses"]).max() > 1e-3
    _assert_states_close(ts, js, atol=5e-4)


def test_global_ba_cg_route(loop_run, monkeypatch):
    """`_global_ba` on the fixture's state with its point tier padded by
    invalid rows to P = 65536 (F*P > 4e6): both take the CG engine."""
    st = dict(loop_run["state"])
    P = 65536
    n = st["points"].shape[0]
    st["points"] = np.concatenate([st["points"], np.zeros((P - n, 3), np.float32)])
    st["point_valid"] = np.concatenate([st["point_valid"], np.zeros(P - n, bool)])
    F = st["poses"].shape[0]
    assert F * P > 4_000_000
    kfs = [f for f in loop_run["keyframes"] if st["pose_valid"][f]]
    pad = np.zeros(F, np.int64)
    pad[: len(kfs)] = kfs
    rng = np.random.RandomState(7)
    st["poses"] = st["poses"].copy()
    st["poses"][kfs[1:], :, 3] += 0.01 * rng.randn(len(kfs) - 1, 3).astype(np.float32)
    lcfg = dict(loop_run["lcfg"], global_ba_iters=4)
    jl = jlc.LoopCloser(voc=loop_run["jv"], cfg=loop_run["jcfg"], lc=jlc.LoopClosureConfig(**lcfg))
    tl = tlc.LoopCloser(loop_run["tv"], loop_run["tcfg"], tlc.LoopClosureConfig(**lcfg), device="cpu")
    j_calls = _count_calls(monkeypatch, jcg, "bundle_adjust_cg")
    t_calls = _count_calls(monkeypatch, tcg, "bundle_adjust_cg")
    js = jl._global_ba(_jstate(st), pad.astype(np.int32), len(kfs))
    ts = tl._global_ba(tstate.state_from_numpy(st), torch.as_tensor(pad), len(kfs))
    assert len(j_calls) == len(t_calls) == 1
    assert np.abs(np32(ts.poses) - st["poses"]).max() > 1e-3
    _assert_states_close(ts, js, atol=5e-4)


def test_session_loop_revisit_scale_routes(loop_run, monkeypatch):
    """The feature-path revisit with max_points 65536 and a 160-vertex
    keyframe bucket, through both sessions, with the near-identity gate off
    so that the closure is corrected (this course's drift is below it): the
    correction takes both CG routes (the port at the reference's dense/CG
    switch of the pose graph, 128), the port closes the same loops as the
    reference, and its ATE stays within max(1.5 x reference,
    reference + 5 mm)."""
    seq = loop_run["seq"]
    kw = dict(max_frames=64, max_points=65536)
    lcfg = dict(loop_run["lcfg"], kf_bucket=160, id_rot_rad=0.0, id_trans=0.0, id_log_scale=0.0)
    jcfg = JConfig(frontend=JFrontend(n_features=256), **kw)
    jl = jlc.LoopCloser(voc=loop_run["jv"], cfg=jcfg, lc=jlc.LoopClosureConfig(**lcfg))
    js = JSession(jcfg, seed=3, run_ba=True, loop_closer=jl)
    for i, f in enumerate(seq.frames):
        js.add_frame_features(f, seq.k, seq.timestamps[i])
    jposes, jvalid, _ = js.trajectory()
    gt = np.asarray(seq.poses_gt)
    ref = jate.ate(jposes[jvalid], gt[jvalid]).rmse

    pg_calls = _count_calls(monkeypatch, tpg, "optimize_cg")
    ba_calls = _count_calls(monkeypatch, tcg, "bundle_adjust_cg")
    tcfg = SlamConfig(frontend=FrontendConfig(n_features=256), **kw)
    monkeypatch.setattr(tlc, "POSE_GRAPH_DENSE_MAX", 128)
    tl = tlc.LoopCloser(loop_run["tv"], tcfg, tlc.LoopClosureConfig(**lcfg), device="cpu")
    sess = TSession(tcfg, seed=3, run_ba=True, loop_closer=tl, device="cpu")
    k = np.asarray(seq.k, np.float32)
    for i, f in enumerate(seq.frames):
        sess.add_frame_features(_t_features(f), k, float(seq.timestamps[i]))
    poses, valid, _ = sess.trajectory()
    assert tl.closures == jl.closures and len(tl.closures) >= 1
    assert tl.corrected == jl.corrected
    assert len(pg_calls) >= 1 and len(ba_calls) >= 1
    r = tate.ate(poses[valid], gt[valid]).rmse
    assert valid.sum() >= jvalid.sum() - 2
    assert r <= max(1.5 * ref, ref + 0.005), (r, ref)


def test_session_relocalizes_after_blackout():
    """`tests/test_long_trajectory.py`'s blackout through the port: garbage
    frames fail, then a real view relocalizes against the BoW-nearest
    keyframe and carries map associations."""
    n_feat = 300
    seq = synthetic.feature_sequence(jax.random.PRNGKey(6), n_frames=30, n_world_points=1500,
                                     n_features=n_feat, pix_noise=0.3, drop_prob=0.05)
    desc = np.concatenate([np.asarray(f.desc_pm1)[np.asarray(f.valid)] for f in seq.frames[:8]])
    voc = tvoc.train(desc, k=8, L=3, seed=0, device="cpu")
    cfg = SlamConfig(max_frames=64, max_points=8000, frontend=FrontendConfig(n_features=n_feat))
    sess = TSession(cfg, seed=1, run_ba=True, loop_closer=tlc.LoopCloser(voc, cfg, device="cpu"),
                    device="cpu")
    k = np.asarray(seq.k, np.float32)
    frames = [_t_features(f) for f in seq.frames]
    for i in range(20):
        assert sess.add_frame_features(frames[i], k, float(seq.timestamps[i])).tracked
    garbage = frames[0]._replace(desc_pm1=torch.as_tensor(
        np.random.RandomState(9).choice(np.array([-1, 1], np.int8), size=(n_feat, 256))))
    n_fail = sum(not sess.add_frame_features(garbage, k, 100.0 + j).tracked for j in range(4))
    assert n_fail >= 3
    st = None
    for i in range(20, 26):
        st = sess.add_frame_features(frames[i], k, float(seq.timestamps[i]))
        if st.tracked:
            break
    assert st.tracked, "relocalization never recovered tracking"
    sl = int(sess.state.slot_of[st.frame])
    assert (np32(sess.state.feat_point[sl]) >= 0).sum() >= cfg.track.reloc_min_inliers


def test_session_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU;
    without a card they raise instead of falling back."""
    cfg = SlamConfig(max_frames=4, max_points=100, frontend=FrontendConfig(n_features=16))
    if torch.cuda.is_available():
        assert TSession(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        TSession(cfg)
    voc = tvoc.load_default(device="cpu")
    with pytest.raises(RuntimeError):
        tlc.LoopCloser(voc, cfg)
    with pytest.raises(ValueError):
        TSession(cfg, device="cpu", loop_closer=tlc.LoopCloser(voc, cfg, device="meta"))


def test_global_ba_cg_solver_tracks_dense(loop_run):
    """The closer's CG global-BA solver against its dense one on the
    fixture's state after a 1 cm perturbation of the keyframes (the rule of
    `chip_smoke.py`'s scale phase): the CG route ends within 10% of the dense
    route's largest pose move. With the reference's 50 PCG steps the card's
    rendered revisit state ended 10.1-10.5% away (ROADMAP Queue 3); the port
    runs `GLOBAL_BA_CG_ITERS` = 100 (and `POSE_GRAPH_CG_ITERS` = 800, which
    the long run's K_pad 512 graphs need)."""
    st = tstate.state_from_numpy(loop_run["state"], device="cpu")
    kfs = [f for f in loop_run["keyframes"] if loop_run["state"]["pose_valid"][f]]
    F = st.poses.shape[0]
    pad = torch.zeros(F, dtype=torch.long)
    pad[: len(kfs)] = torch.as_tensor(kfs)
    poses = st.poses.clone()
    rng = np.random.RandomState(3)
    poses[kfs[1:], :, 3] += torch.as_tensor(0.01 * rng.randn(len(kfs) - 1, 3).astype(np.float32))
    st = st._replace(poses=poses)
    tl = tlc.LoopCloser(loop_run["tv"], loop_run["tcfg"], tlc.LoopClosureConfig(**loop_run["lcfg"]),
                        device="cpu")
    assert (tlc.GLOBAL_BA_CG_ITERS, tlc.POSE_GRAPH_CG_ITERS) == (100, 800)
    dense = tl._gba_impl(st, pad, len(kfs), tl.global_ba_solver(cg=False))
    cg = tl._gba_impl(st, pad, len(kfs), tl.global_ba_solver(cg=True))
    v = st.pose_valid
    moved = (dense.poses - st.poses)[v].abs().max().item()
    diff = (cg.poses - dense.poses)[v].abs().max().item()
    assert moved > 1e-3 and diff <= 0.1 * moved, (diff, moved)
