"""The session's programs outside the tracked step, on the CPU (the card's
captures are in `test_torch_cuda.py` and `chip_smoke.py`'s loop phase):
relocalization and its scores, the Sim3, the loop correction with its
global BA, FrameCulling and the bootstrap.

  - each program's function under `port_util.sync_audit` with device-tensor
    arguments: no host read and no host-to-device copy, except in K3's
    plain stand-ins (`torch.linalg.eigh` / `svd`), which are the kernel on
    a card;
  - each held to its jitted JAX counterpart on the same inputs (a port
    session's state over a threefry feature course, and a hand-made state
    with a chain of mutually redundant keyframes), at the tolerances the
    loop and tracker tests use for the same functions;
  - the LM steps the captured CG routes replay (`optimize_cg_step`,
    `bundle_adjust_step`, `bundle_adjust_cg_step`), replayed through
    static buffers as the loop closer replays them: the loop's result bit
    for bit;
  - `horn_sim3`, `eight_point` and `pose_from_essential` with K3's `svd3`
    (`tests/k3_emulation.py`) in place of `torch.linalg.svd`, the card's
    route: the same fit as the CPU's route and as JAX.

The reference runs with x64 off, so that its draws are the float32 uniforms
the port draws from the same key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k3_emulation as emu
from monocular_slam_tpu.geometry import alignment as jal
from monocular_slam_tpu.geometry import epipolar as jepi
from monocular_slam_tpu.optim import ba as jba
from monocular_slam_tpu.retrieval import vocabulary as jvoc
from monocular_slam_tpu.slam import config as jconf
from monocular_slam_tpu.slam import keyframes as jkf
from monocular_slam_tpu.slam import loop_closer as jlc
from monocular_slam_tpu.slam import state as jstate
from monocular_slam_tpu.slam import tracker as jtrack
from monocular_slam_tpu.utils import linalg as jlinalg
from monocular_slam_tpu_torch.datasets import synthetic as tsyn
from monocular_slam_tpu_torch.geometry import alignment as tal
from monocular_slam_tpu_torch.geometry import epipolar as tepi
from monocular_slam_tpu_torch.geometry import sim3 as tsim3
from monocular_slam_tpu_torch.ops import small_eigh
from monocular_slam_tpu_torch.optim import ba as tba
from monocular_slam_tpu_torch.optim import cg_ba as tcg
from monocular_slam_tpu_torch.optim import pose_graph as tpg
from monocular_slam_tpu_torch.retrieval import vocabulary as tvoc
from monocular_slam_tpu_torch.slam import config as tconf
from monocular_slam_tpu_torch.slam import keyframes as tkf
from monocular_slam_tpu_torch.slam import loop_closer as tlc
from monocular_slam_tpu_torch.slam import session as tsess
from monocular_slam_tpu_torch.slam import state as tstate
from monocular_slam_tpu_torch.slam import tracker as ttrack
from monocular_slam_tpu_torch.utils import graph, prng
from port_util import np32, sync_audit
from port_util import one_torch_thread  # noqa: F401 (autouse)

N_FEAT = 200
N_FRAMES = 14
KEY = 11
POSE_TOL = 2e-3  # tracker tests: the LO refit's float32 eigh moves a pose by up to ~1.5e-3
CORRECT_TOL = 2e-4  # test_torch_loop.test_correct_impl: 20 float32 LM steps on the graph
GBA_TOL = 2e-4  # test_torch_loop.test_gba_impl
SIM3_TOL = 1e-4  # test_torch_loop: four GN steps per anneal stage on float32 Jacobians
SVD_TOL = 1e-5
# the revisit course of test_torch_loop.py (its 0.14 rad steps give the
# two-view geometry a baseline; at 0.04 rad a relocalization's pose moves by
# up to 0.17 between XLA's and torch's float32 solves)
COURSE = dict(n_world_points=900, pix_noise=0.4, drop_prob=0.08, ang_step=0.14)


def _cfg(mod):
    return mod.SlamConfig(
        frontend=mod.FrontendConfig(n_features=N_FEAT, steer_mode="binned"),
        ba=mod.BAConfig(window=3, local_iters=2), track=mod.TrackConfig(pnp_iters=64),
        init=mod.InitConfig(ransac_iters=256), max_frames=16, max_points=2000)


def _jstate(d: dict):
    return jstate.SlamState(**{n: jnp.asarray(v) for n, v in d.items()})


def _t(x, dtype=torch.int64):
    return torch.tensor(x, dtype=dtype)


def _key_words(key):
    return prng.key_on(key, "cpu")


@pytest.fixture(scope="module")
def course():
    """The port's session (with a loop closer) over the threefry revisit
    course's first frames; its state, the state of frames 0 and 1 before the bootstrap,
    both closers on one vocabulary and the port closer's database."""
    seq = tsyn.feature_sequence(prng.PRNGKey(1), n_frames=N_FRAMES, n_features=N_FEAT, **COURSE,
                                device="cpu")
    cfg = _cfg(tconf)
    desc = np.concatenate([np.asarray(f.desc_pm1)[np.asarray(f.valid)] for f in seq.frames[:6]])
    jv = jvoc.train(desc, k=6, L=2, seed=0)
    tv = tvoc.vocabulary_from_numpy([np.asarray(n) for n in jv.nodes], np.asarray(jv.weights),
                                    jv.k, jv.L, device="cpu")
    lcfg = dict(min_gap=3, sim3_iters=64, global_ba_iters=3)
    tl = tlc.LoopCloser(tv, cfg, tlc.LoopClosureConfig(**lcfg), device="cpu")
    sess = tsess.SlamSession(cfg, seed=0, loop_closer=tl, device="cpu")
    boot = None
    for i, f in enumerate(seq.frames):
        if i == 1:
            boot = tstate.add_frame_features(sess.state, 1, 1, f.uv, f.scale, f.valid, f.desc,
                                             f.desc_pm1, torch.as_tensor(np.asarray(seq.k)))
        sess.add_frame_features(f, seq.k, float(i))
    sess.flush()
    assert all(s.tracked for s in sess.stats)
    with torch.inference_mode():
        for f in range(0, N_FRAMES - 3, 2):
            tl.insert_from_state(sess.state, f)
    return dict(state=tstate.state_to_numpy(sess.state), boot=tstate.state_to_numpy(boot),
                cfg=cfg, jv=jv, tv=tv, lcfg=lcfg, db=tl._db.numpy().copy())


def _closers(course, **over):
    lcfg = dict(course["lcfg"], **over)
    jl = jlc.LoopCloser(voc=course["jv"], cfg=_cfg(jconf), lc=jlc.LoopClosureConfig(**lcfg))
    tl = tlc.LoopCloser(course["tv"], course["cfg"], tlc.LoopClosureConfig(**lcfg), device="cpu")
    tl._db.copy_(torch.as_tensor(course["db"]))
    return jl, tl


def _audited(fn, *args, **kw):
    """fn(*args) under `sync_audit`, after one run that fills the per-device
    constant caches (as a capture's warm-up run does); the events outside
    K3's plain stand-ins."""
    with torch.inference_mode():
        fn(*args, **kw)
        with sync_audit(raise_on_sync=False) as audit:
            out = fn(*args, **kw)
    return out, [e for e in audit.events if not e[1].startswith("ops/small_eigh.py")]


# --- relocalization -------------------------------------------------------------------

def _lost(course):
    st = dict(course["state"], pose_valid=course["state"]["pose_valid"].copy())
    i = N_FRAMES - 1
    st["pose_valid"][i] = False
    return st, i, 4


def test_relocalize_program(course):
    """`tracker.relocalize` with the frame ids and the key as device tensors
    (the relocalization program) against the jitted reference: flags and
    inliers equal, poses within POSE_TOL; no host round trip."""
    lost, i, cand = _lost(course)
    key = prng.PRNGKey(KEY)
    with jax.enable_x64(False):
        jcfg = _cfg(jconf)
        rj = jax.jit(lambda st, i, c, k: jtrack.relocalize(st, i, c, k, jcfg))(
            _jstate(lost), i, cand, jnp.asarray(key))
        ref = {n: np.array(v) for n, v in rj.state._asdict().items()}
    rt, bad = _audited(ttrack.relocalize, tstate.state_from_numpy(lost), _t(i), _t(cand),
                       _key_words(key), course["cfg"])
    assert not bad, bad
    assert bool(rt.ok) == bool(rj.ok) is True
    assert int(rt.n_inliers) == int(rj.n_inliers)
    got = tstate.state_to_numpy(rt.state)
    np.testing.assert_array_equal(got["pose_valid"], ref["pose_valid"])
    np.testing.assert_array_equal(got["feat_point"], ref["feat_point"])
    np.testing.assert_allclose(got["poses"], ref["poses"], atol=POSE_TOL)


def test_reloc_scores_program(course):
    """The scores program's `reloc_scores` with a device frame id against
    the reference's `_reloc_scores`: the same inserted rows, scores within
    1e-6; no host round trip."""
    jl, tl = _closers(course)
    i = N_FRAMES - 1
    with jax.enable_x64(False):
        ref = np.asarray(jax.jit(jl._reloc_scores_impl)(jnp.asarray(course["db"]),
                                                         _jstate(course["state"]), i))
    got, bad = _audited(tl.reloc_scores, tstate.state_from_numpy(course["state"]), _t(i))
    assert not bad, bad
    got = np32(got)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.isfinite(got).sum() >= 4
    np.testing.assert_allclose(got[np.isfinite(got)], ref[np.isfinite(ref)], atol=1e-6)


# --- Sim3 -----------------------------------------------------------------------------

def test_sim3_program(course):
    """The Sim3 program's body (K2 route's match, RANSAC and polish) with
    device frame ids and key against the reference's `compute_sim3`
    (`_sim3_fn` jitted): ok and inliers equal, S within SIM3_TOL; no host
    round trip; a frame without a slot gives ok
    False and 0 inliers."""
    jl, tl = _closers(course)
    i, j = N_FRAMES - 1, 6
    key = prng.PRNGKey(KEY)
    with jax.enable_x64(False):
        S_ref, n_ref = jl.compute_sim3(_jstate(course["state"]), i, j, jnp.asarray(key))
    st = tstate.state_from_numpy(course["state"])
    (S, packed), bad = _audited(tl._sim3_device, st, _t(i), _t(j), _key_words(key))
    assert not bad, bad
    assert S_ref is not None and bool(packed[0]) and int(packed[1]) == n_ref >= 15
    np.testing.assert_allclose(np32(S), np.asarray(S_ref), atol=SIM3_TOL)
    S_host, n_host = tl.compute_sim3(st, i, j, key)
    assert n_host == n_ref and torch.equal(S_host, S)
    evicted = st._replace(slot_of=torch.where(torch.arange(16) == j, -1, st.slot_of))
    assert tl.compute_sim3(evicted, i, j, key) == (None, 0)


# --- correction and global BA ----------------------------------------------------------

def _correction_inputs(course, K_pad):
    st = course["state"]
    i, j = N_FRAMES - 1, 2
    kf = [f for f in range(0, N_FRAMES, 2) if st["pose_valid"][f]] + [i]
    kf_pad = np.zeros(K_pad, np.int32)
    kf_pad[: len(kf)] = kf
    L = tlc.LoopClosureConfig().max_loop_edges
    le_i, le_j = np.zeros(L, np.int32), np.zeros(L, np.int32)
    le_meas = np.tile(np32(tsim3.identity()), (L, 1, 1))
    le_valid, le_w = np.zeros(L, bool), np.ones(L, np.float32)
    le_i[0], le_j[0], le_valid[0], le_w[0] = len(kf) - 2, 1, True, 5.0
    S = np32(tsim3.exp(torch.tensor([0.02, -0.01, 0.03, 0.1, 0.05, -0.08, 0.05])))
    return i, j, kf, kf_pad, S, (le_i, le_j, le_meas, le_valid, le_w)


def test_correct_program(course):
    """`_correct_impl` at K_pad 128 (the dense pose graph), every id and
    count a device tensor, against the jitted reference: the corrected
    poses within CORRECT_TOL, the valid points within CORRECT_TOL of the
    scene's extent (a point moves with its anchor frame's pose, over a
    lever arm of up to that extent; measured 5.9e-4 at an extent of 13);
    no host round trip."""
    jl, tl = _closers(course, run_global_ba=False)
    i, j, kf, kf_pad, S, le = _correction_inputs(course, 128)
    pos_i, pos_j = kf.index(i), kf.index(j)
    with jax.enable_x64(False):
        js, jok = jax.jit(jl._correct_impl)(
            _jstate(course["state"]), jnp.asarray(kf_pad), len(kf), pos_i, pos_j, i, j,
            jnp.asarray(S), *[jnp.asarray(a) for a in le])
    (ts, tok), bad = _audited(
        tl._correct_impl, tstate.state_from_numpy(course["state"]), torch.as_tensor(kf_pad),
        _t(len(kf)), _t(pos_i), _t(pos_j), _t(i), _t(j), torch.as_tensor(S),
        *[torch.as_tensor(a) for a in le])
    assert not bad, bad
    assert bool(tok) is bool(jok) is True
    assert np.abs(np32(ts.poses) - course["state"]["poses"]).max() > 1e-3
    np.testing.assert_allclose(np32(ts.poses), np.asarray(js.poses), atol=CORRECT_TOL)
    pv = course["state"]["point_valid"]
    extent = np.abs(course["state"]["points"][pv]).max()
    np.testing.assert_allclose(np32(ts.points)[pv], np.asarray(js.points)[pv],
                               atol=CORRECT_TOL * extent)


def _perturbed(course):
    st = dict(course["state"], poses=course["state"]["poses"].copy())
    kfs = [f for f in range(0, N_FRAMES, 2) if st["pose_valid"][f]]
    st["poses"][kfs[1:], :, 3] += 0.01 * np.random.RandomState(7).randn(len(kfs) - 1, 3)
    pad = np.zeros(16, np.int32)
    pad[: len(kfs)] = kfs
    return st, pad, len(kfs)


def test_gba_program(course):
    """The dense global-BA program's `_gba_impl` with a device keyframe
    count against the jitted reference on perturbed keyframes: poses and
    points within GBA_TOL; no host round trip."""
    jl, tl = _closers(course)
    st, pad, K = _perturbed(course)
    n = course["lcfg"]["global_ba_iters"]
    with jax.enable_x64(False):
        js = jax.jit(lambda s, p, k: jl._gba_impl(s, p, k, lambda pr: jba.bundle_adjust(
            pr, n_iters=n)))(_jstate(st), jnp.asarray(pad), K)
    ts, bad = _audited(tl._gba_impl, tstate.state_from_numpy(st), torch.as_tensor(pad), _t(K),
                       tl.global_ba_solver(cg=False))
    assert not bad, bad
    assert np.abs(np32(ts.poses) - st["poses"]).max() > 1e-3
    np.testing.assert_allclose(np32(ts.poses), np.asarray(js.poses), atol=GBA_TOL)
    np.testing.assert_allclose(np32(ts.points), np.asarray(js.points), atol=GBA_TOL)


def _loop(steps, carry, n):
    """The carry in static buffers, `steps` replayed n times, as the loop
    closer's CG programs run: each step's result copied into the buffers."""
    carry = graph.cloned(carry)
    leaves = graph.leaves(carry)
    for _ in range(n):
        graph.copy_leaves(leaves, steps(carry))
    return carry


def test_lm_steps_replayed_equal_the_loops(course):
    """`optimize_cg_step` (the CG pose graph), `bundle_adjust_step` (the
    dense Schur) and `bundle_adjust_cg_step` (the CG global BA), replayed
    through static buffers from their start: the whole solve's result bit
    for bit; each step without a host round trip."""
    _, tl = _closers(course)
    i, j, kf, kf_pad, S, le = _correction_inputs(course, 32)
    st = tstate.state_from_numpy(course["state"])
    with torch.inference_mode():
        g, _ = tl._correct_graph(st, torch.as_tensor(kf_pad), _t(len(kf)), _t(kf.index(i)),
                                 _t(kf.index(j)), _t(i), _t(j), torch.as_tensor(S),
                                 *[torch.as_tensor(a) for a in le])
        whole = tpg.optimize_cg(g, n_iters=5, max_cg_iters=20, huber_delta=1.0)
        start, chi2_0 = tpg.optimize_cg_start(g, huber_delta=1.0)
        c = _loop(lambda c: tpg.optimize_cg_step(g, c, max_cg_iters=20, huber_delta=1.0), start, 5)
    assert torch.equal(c.verts, whole.vertices) and torch.equal(chi2_0, whole.chi2_initial)
    assert torch.equal(c.st.chi2, whole.chi2_history[-1]) and torch.equal(c.n_run, whole.n_iters_run)
    _, bad = _audited(tpg.optimize_cg_step, g, start, max_cg_iters=20, huber_delta=1.0)
    assert not bad, bad

    pst, pad, K = _perturbed(course)
    with torch.inference_mode():
        prob, _ = tl._gba_problem(tstate.state_from_numpy(pst), torch.as_tensor(pad), _t(K))
        for whole_fn, step in (
                (lambda p: tba.bundle_adjust(p, n_iters=4),
                 lambda c: tba.bundle_adjust_step(prob, c)[0]),
                (lambda p: tcg.bundle_adjust_cg(p, n_iters=4, max_cg_iters=30),
                 lambda c: tcg.bundle_adjust_cg_step(prob, c, max_cg_iters=30))):
            whole = whole_fn(prob)
            c = _loop(step, tba.bundle_adjust_start(prob), 4)
            assert torch.equal(c.poses, whole.poses) and torch.equal(c.points, whole.points)
            assert torch.equal(c.st.chi2, whole.chi2_history[-1]) and torch.equal(c.st.it,
                                                                                 whole.n_iters_run)
            assert not torch.equal(whole.poses, prob.poses)
        start = tba.bundle_adjust_start(prob)
    for step in (tba.bundle_adjust_step, tcg.bundle_adjust_cg_step):
        _, bad = _audited(step, prob, start)
        assert not bad, bad


# --- FrameCulling ---------------------------------------------------------------------

def _chain_state():
    """A hand-made state: keyframes 0, 2, ..., 14 (slot = frame), each
    seeing its own 20 points, and keyframes 4, 6, 8 and 10 all seeing the
    same 40 points besides: a chain of mutually redundant keyframes, where
    each cull lowers the counts the next decision sees; frame 12 is
    evicted."""
    cfg = tconf.SlamConfig(frontend=tconf.FrontendConfig(n_features=64), max_frames=16,
                           max_points=400)
    d = tstate.state_to_numpy(tstate.empty_state(cfg, "cpu"))
    kfs = list(range(0, 16, 2))
    for f in kfs:
        d["slot_of"][f], d["frame_of"][f] = f, f
        d["pose_valid"][f] = True
        own = 200 + 20 * (f // 2) + np.arange(20)
        d["feat_point"][f, :20] = own
        d["kp_valid"][f, :60] = True
        if f in (4, 6, 8, 10):
            d["feat_point"][f, 20:60] = np.arange(40)
    d["slot_of"][12] = -1
    d["point_valid"][:360] = True
    return d, kfs


@pytest.mark.parametrize("case", ["chain", "course"])
def test_cull_program(course, case):
    """`cull_keyframes` over the padded keyframe list (the culling program)
    and `cull_frames_device` over every frame, against the jitted
    reference: equal flags; no host round trip. In the chain, FrameCulling
    keeps enough of the mutually redundant keyframes."""
    if case == "chain":
        d, kfs = _chain_state()
        kw = dict(redundancy=0.6, min_other_obs=2)
    else:
        d = course["state"]
        kfs = [f for f in range(N_FRAMES) if d["pose_valid"][f]]
        kw = dict(redundancy=0.3, min_other_obs=1)
    F = d["poses"].shape[0]
    flags = np.zeros(F, bool)
    flags[kfs] = True
    protect = np.zeros(F, bool)
    protect[kfs[0]] = True
    protect[kfs[-2:]] = True
    with jax.enable_x64(False):
        ref = np.asarray(jax.jit(lambda s, f, p: jkf.cull_frames_device(s, f, p, **kw))(
            _jstate(d), jnp.asarray(flags), jnp.asarray(protect)))
    pad = np.zeros(32, np.int64)
    pad[: len(kfs)] = kfs
    st = tstate.state_from_numpy(d)
    got, bad = _audited(tkf.cull_keyframes, st, torch.as_tensor(pad), _t(len(kfs)), 2, **kw)
    assert not bad, bad
    np.testing.assert_array_equal(np32(got), ref)
    with torch.inference_mode():
        np.testing.assert_array_equal(np32(tkf.cull_frames_device(st, flags, protect, **kw)), ref)
    assert ref.sum() < flags.sum()  # something was culled
    if case == "chain":
        assert ref[[4, 6, 8, 10]].sum() >= 1 and not ref[[4, 6, 8, 10]].all()


# --- bootstrap ------------------------------------------------------------------------

def test_bootstrap_program(course):
    """`tracker.bootstrap` with f0, f1 and the key as device tensors (the
    bootstrap program) against the jitted reference on frames 0 and 1:
    flags, inliers and points equal, poses within POSE_TOL; no host round
    trip."""
    key = prng.split(prng.PRNGKey(0))[1]
    with jax.enable_x64(False):
        jcfg = _cfg(jconf)
        rj = jax.jit(lambda st, k: jtrack.bootstrap(st, k, jcfg, 0, 1))(
            _jstate(course["boot"]), jnp.asarray(key))
        ref = {n: np.array(v) for n, v in rj.state._asdict().items()}
    rt, bad = _audited(ttrack.bootstrap, tstate.state_from_numpy(course["boot"]),
                       _key_words(key), course["cfg"], _t(0), _t(1))
    assert not bad, bad
    assert bool(rt.ok) == bool(rj.ok) is True
    assert int(rt.n_inliers) == int(rj.n_inliers) and int(rt.n_points) == int(rj.n_points)
    got = tstate.state_to_numpy(rt.state)
    for n in ("pose_valid", "point_valid", "feat_point"):
        np.testing.assert_array_equal(got[n], ref[n], err_msg=n)
    np.testing.assert_allclose(got["poses"], ref["poses"], atol=POSE_TOL)


# --- the card's SVD route -------------------------------------------------------------

def _emulated_svd3(M):
    U, S, Vt, _ = emu.svd3(M.detach().double().numpy())
    return tuple(torch.as_tensor(x, dtype=M.dtype) for x in (U, S, Vt))


def _two_view(rng, n=120):
    """Two views of n points in normalized image coordinates (unit
    intrinsics, 0.3 px of noise at a 400 px focal length): F is E, with no
    pixel-scale denormalization to round in float32."""
    K = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (n, 3))
    R = np32(tsim3.to_se3(tsim3.exp(torch.tensor([0.0, 0.0, 0.0, 0.02, -0.05, 0.03, 0.0]))))[:, :3]
    t = np.array([0.3, 0.02, 0.05])
    X2 = X @ R.T + t

    def proj(P):
        return np.stack([K[0] * P[:, 0] / P[:, 2] + K[2], K[1] * P[:, 1] / P[:, 2] + K[3]], 1)

    uv1 = proj(X) + 0.3 / 400 * rng.randn(n, 2)
    uv2 = proj(X2) + 0.3 / 400 * rng.randn(n, 2)
    return K, uv1.astype(np.float32), uv2.astype(np.float32)


def test_svd3_route(monkeypatch):
    """`horn_sim3` (minimal 3-point fits and a weighted fit), `eight_point`
    and `pose_from_essential` with K3's `svd3` patched in for the card's
    kernel, against the `torch.linalg.svd` route and JAX: the Horn fit's
    R, t and s, the rank-2 F and the chosen pose of one E within SVD_TOL
    of both, with equal votes. The eight-point's nullspace vector is the
    same 9-vector on all three (the 9x9 float32 `eigh` of XLA and torch
    alone moves F by up to ~2e-3 on this scene). LAPACK and K3 may differ
    in the signs of singular vectors and in the basis of E's repeated
    singular value; these results are invariant to both."""
    rng = np.random.RandomState(5)
    X = rng.randn(64, 3, 3).astype(np.float32)
    S_true = tsim3.exp(torch.tensor([0.1, -0.2, 0.3, 0.4, -0.2, 0.1, 0.2]))
    Y = np32(tsim3.apply(S_true, torch.as_tensor(X))) + 0.01 * rng.randn(64, 3, 3).astype(np.float32)
    Xw = rng.randn(200, 3).astype(np.float32)
    Yw = np32(tsim3.apply(S_true, torch.as_tensor(Xw)))
    w = (rng.rand(200) > 0.2).astype(np.float32)
    K, uv1, uv2 = _two_view(rng)
    A = tepi._constraint_rows(*(tepi.hartley_normalize(torch.as_tensor(u))[0] for u in (uv1, uv2)))
    f = np32(tepi.nullspace_vector(tepi.gram(A)))
    monkeypatch.setattr(tepi, "nullspace_vector", lambda *a, **kw: torch.as_tensor(f))
    monkeypatch.setattr(jlinalg, "nullspace_vector", lambda *a, **kw: jnp.asarray(f))
    with jax.enable_x64(False):
        jhorn = (jal.horn_sim3(jnp.asarray(X), jnp.asarray(Y)),
                 jal.horn_sim3(jnp.asarray(Xw), jnp.asarray(Yw), jnp.asarray(w)))
        jF = jepi.eight_point(jnp.asarray(uv1), jnp.asarray(uv2))
        E = jepi.essential_from_fundamental(jF, jnp.asarray(K), jnp.asarray(K))
        jtv = jepi.pose_from_essential(E, jnp.asarray(K), jnp.asarray(K), jnp.asarray(uv1),
                                       jnp.asarray(uv2), jnp.ones(len(uv1), bool))
    E = np.array(E)

    def port():
        with torch.inference_mode():
            horn = (tal.horn_sim3(torch.as_tensor(X), torch.as_tensor(Y)),
                    tal.horn_sim3(torch.as_tensor(Xw), torch.as_tensor(Yw), torch.as_tensor(w)))
            F = tepi.eight_point(torch.as_tensor(uv1), torch.as_tensor(uv2))
            tv = tepi.pose_from_essential(torch.as_tensor(E), torch.as_tensor(K),
                                          torch.as_tensor(K), torch.as_tensor(uv1),
                                          torch.as_tensor(uv2),
                                          torch.ones(len(uv1), dtype=torch.bool))
        return horn, F, tv

    plain = port()
    calls = []
    monkeypatch.setattr(small_eigh, "svd3", lambda M: calls.append(M.shape) or _emulated_svd3(M))
    card = port()
    assert len(calls) == 4  # two Horn fits, the rank-2 projection, the decomposition
    for other in (plain, (jhorn, jF, jtv)):
        for a, b in zip(card[0], other[0]):
            np.testing.assert_allclose(np32(a), np.asarray(b), atol=SVD_TOL)
        np.testing.assert_allclose(np32(card[1]), np.asarray(other[1]), atol=SVD_TOL)
        np.testing.assert_allclose(np32(card[2].T_21), np.asarray(other[2].T_21), atol=SVD_TOL)
        assert int(card[2].n_good) == int(other[2].n_good) >= 100
