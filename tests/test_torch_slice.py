"""The port's main path against the JAX reference on the reference's own
rendered course (key 3, 12 frames, 320x240, the configuration of
`tests/test_render_e2e.py`; see `port_util.rendered_course`), plus one
640x480 frame of the same scene:

  - K1's plain version on every pyramid level of the 640x480 frame, against
    the reference's XLA path and its Pallas kernel (interpret mode);
  - the pyramid and `extract` (both steer modes) on a course frame;
  - one `tracker.track` step from the reference session's mid-run state,
    with the reference's PnP uniforms injected, and the mapping block's
    functions on the state it produces;
  - the whole slice: the reference `SlamSession` and the port's, each run
    over the 12 frames, against each other and the ground truth. The
    sessions draw different random numbers, so this check is on outcomes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_slam_tpu.eval import ate as jate
from monocular_slam_tpu.geometry import camera as jcam
from monocular_slam_tpu.ops import fast as jfast
from monocular_slam_tpu.ops import features as jfeat
from monocular_slam_tpu.ops import pyramid as jpyr
from monocular_slam_tpu.ops.pallas import fast_score as jfs
from monocular_slam_tpu.slam import local_ba as jlba
from monocular_slam_tpu.slam import mapping as jmap
from monocular_slam_tpu.slam import state as jstate
from monocular_slam_tpu.slam import tracker as jtrack
from monocular_slam_tpu.slam.config import FrontendConfig as JFrontend
from monocular_slam_tpu.slam.config import SlamConfig as JConfig
from monocular_slam_tpu.slam.session import SlamSession as JSession
from monocular_slam_tpu_torch.eval import ate as tate
from monocular_slam_tpu_torch.ops import fast_score as tfs
from monocular_slam_tpu_torch.ops import features as tfeat
from monocular_slam_tpu_torch.ops import pyramid as tpyr
from monocular_slam_tpu_torch.slam import local_ba as tlba
from monocular_slam_tpu_torch.slam import mapping as tmap
from monocular_slam_tpu_torch.slam import state as tstate
from monocular_slam_tpu_torch.slam import tracker as ttrack
from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
from monocular_slam_tpu_torch.slam.session import SlamSession as TSession
from port_util import COURSE_FRAMES, COURSE_WH, jnp32, np32, rendered_course, t32, uniforms
from port_util import one_torch_thread  # noqa: F401 (autouse)

N_FEAT = 600
SNAP = 6  # the track-step test starts from the state after frame SNAP - 1


def _cfg_kw():
    return dict(max_frames=16, max_points=4000, image_wh=COURSE_WH)


@pytest.fixture(scope="module")
def course():
    return rendered_course()


@pytest.fixture(scope="module")
def reference_run(course):
    """The reference session over the course, with a snapshot of its state
    after frame SNAP - 1."""
    imgs, _, k, _ = course
    cfg = JConfig(frontend=JFrontend(n_features=N_FEAT), **_cfg_kw())
    sess = JSession(cfg, seed=0, run_ba=True)
    snap = None
    for i in range(COURSE_FRAMES):
        if i == SNAP:
            snap = {n: np.array(v) for n, v in sess.state._asdict().items()}
            steer = sess._steer
        sess.add_frame(imgs[i], k, i / 30.0)
    poses, valid, _ = sess.trajectory()
    return dict(poses=poses, valid=valid, snap=snap, steer=steer, cfg=cfg)


def _check_maps(img, thr=20.0):
    nms_t, raw_t = (np32(x) for x in tfs.corner_maps(t32(img), thr))
    j = jnp32(img)
    np.testing.assert_allclose(nms_t, np32(jfast.nms3(jfast.corner_score(j, thr))), atol=1e-5)
    np.testing.assert_allclose(raw_t[3:-3, 3:-3], np32(jfast.corner_score_raw(j))[3:-3, 3:-3],
                               atol=1e-5)
    nms_p, raw_p = jfs.corner_maps(j, thr, interpret=True)
    np.testing.assert_allclose(nms_t, np32(nms_p), atol=1e-5)
    np.testing.assert_allclose(raw_t[3:-3, 3:-3], np32(raw_p)[3:-3, 3:-3], atol=1e-5)
    return int((nms_t > 0).sum())


def test_k1_plain_on_rendered_640x480_levels(course):
    levels = tpyr.build_pyramid(t32(course[3]))
    assert [tuple(x.shape) for x in levels] == [
        (480, 640), (400, 533), (333, 444), (278, 370), (231, 309), (193, 257),
        (161, 214), (134, 179)]
    for lvl in levels:
        assert _check_maps(np32(lvl)) > 50


def test_pyramid_levels(course):
    """Shapes equal; values within 5e-3 on the 0-255 scale. The port builds
    the reference's resize weight matrices, so the gap is float32 rounding
    (~5e-5) and moves no FAST detection (see the extract test)."""
    img = course[0][1]
    lj = jpyr.build_pyramid(jnp32(img))
    lt = tpyr.build_pyramid(t32(img))
    for a, b in zip(lj, lt):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(np32(b), np32(a), atol=5e-3)
    np.testing.assert_allclose(np32(tpyr.gaussian_blur(t32(img))),
                               np32(jpyr.gaussian_blur(jnp32(img))), atol=1e-3)


@pytest.mark.parametrize("steer_mode", ["binned", "continuous"])
def test_extract_rendered_frame(course, steer_mode):
    """600 features: equal valid count, equal (level, y, x) sets, uv within
    1e-3 px, descriptor bits equal on >= 99.5% (the rest would be
    round/arctan2 ties); with the reference's own angles, exact bits."""
    from monocular_slam_tpu.ops import orb as jorb
    from monocular_slam_tpu_torch.ops import orb as torb

    img = course[0][0]
    fj = jfeat.extract(jnp32(img), n_features=N_FEAT, use_pallas=False, steer_mode=steer_mode)
    ft = tfeat.extract(t32(img), n_features=N_FEAT, steer_mode=steer_mode)
    vj, vt = np.asarray(fj.valid), np32(ft.valid)
    assert vj.sum() == vt.sum() > 200

    def keyset(f, v):
        lvl = np.round(np.log(np32(f.scale)) / np.log(1.2)).astype(int)
        yx = np.round(np32(f.uv)[:, ::-1] / np32(f.scale)[:, None]).astype(int)
        return {(int(a), int(b), int(c)) for a, (b, c), ok in zip(lvl, yx, v) if ok}

    assert keyset(fj, vj) == keyset(ft, vt)
    np.testing.assert_allclose(np32(ft.uv)[vt], np32(fj.uv)[vj], atol=1e-3)
    assert (np32(ft.desc_pm1)[vt] == np.asarray(fj.desc_pm1)[vj]).mean() >= 0.995

    blurred = jpyr.gaussian_blur(jnp32(img), sigma=2.0, radius=3)
    n0 = tfeat._level_budgets(N_FEAT, 8)[0]
    yx = np.round(np32(fj.uv)[:n0, ::-1]).astype(np.float32)
    ang = np32(fj.angle)[:n0]
    dj, pj = jorb.descriptors_and_pm1(blurred, jnp32(yx), jnp32(ang), steer_mode=steer_mode)
    dt, pt = torb.descriptors_and_pm1(t32(np32(blurred)), t32(yx), t32(ang), steer_mode=steer_mode)
    np.testing.assert_array_equal(np32(dt).view(np.uint32), np.asarray(dj))
    np.testing.assert_array_equal(np32(pt), np.asarray(pj))


@pytest.fixture(scope="module")
def track_step(course, reference_run):
    """Frame SNAP ingested into the reference's snapshot state, then one
    reference `track` step; returns both packages' inputs and results."""
    imgs, _, k, _ = course
    jcfg = reference_run["cfg"]
    feats = jfeat.extract(jnp32(imgs[SNAP]), n_features=N_FEAT, use_pallas=False,
                          steer_mode=reference_run["steer"])
    uv = jcam.undistort_pixels(jnp32(k), jnp.zeros(5, jnp.float32), feats.uv)
    st = jstate.SlamState(**{n: jnp.asarray(v) for n, v in reference_run["snap"].items()})
    st = jstate.add_frame_features(st, SNAP, SNAP, uv, feats.scale, feats.valid, feats.desc,
                                   feats.desc_pm1, jnp32(k))
    key = jax.random.PRNGKey(5)
    res = jtrack.track(st, SNAP, key, jcfg)
    u = uniforms(jax.random.split(key)[0], jcfg.track.pnp_iters, N_FEAT)
    tcfg = SlamConfig(frontend=FrontendConfig(n_features=N_FEAT), **_cfg_kw())
    pre = {n: np.array(v) for n, v in st._asdict().items()}
    return dict(pre=pre, res=res, u=u, jcfg=jcfg, tcfg=tcfg)


def test_track_step(track_step):
    """Same outcome as the reference step: tracked, PnP inlier count, new
    point count, every association (feat_point), every point and pose
    validity flag, and the untouched map points bit for bit.

    The pose agrees to 2e-3, not 1e-4. Here the motion-model prediction
    wins the hypothesis pool (identical on both sides) and the first LO
    round replaces it with the exact weighted DLT over its 121 inliers: the
    null vector of a 12x12 float32 normal matrix whose two smallest
    eigenvalues (0.021, 2.1) lie ~2e-5 of its largest (8.7e4) apart. On
    identical input the reference's `eigh` and torch's differ by ~1e-4 in
    that vector (each is ~1e-4 from the float64 answer), which moves the
    pose by 1.5e-3. The GN polish after it brings both poses within 6e-6 of
    each other but is rejected on both sides (120 < 122 inliers), so the LO
    pose stands. New points triangulated from that pose inherit the
    difference, so they are compared by count."""
    res_j = track_step["res"]
    res_t = ttrack.track(tstate.state_from_numpy(track_step["pre"]), SNAP, None,
                         track_step["tcfg"], u=torch.as_tensor(track_step["u"]))
    assert bool(res_j.ok) and bool(res_t.ok)
    assert int(res_t.n_pnp_inliers) == int(res_j.n_pnp_inliers) > 50
    assert int(res_t.n_new_points) == int(res_j.n_new_points) > 10
    got = tstate.state_to_numpy(res_t.state)
    ref = {n: np.asarray(v) for n, v in res_j.state._asdict().items()}
    for n in ("feat_point", "pose_valid", "point_valid", "n_points"):
        np.testing.assert_array_equal(got[n], ref[n].astype(got[n].dtype), err_msg=n)
    np.testing.assert_allclose(got["poses"][SNAP], ref["poses"][SNAP], atol=2e-3)
    old = track_step["pre"]["point_valid"]
    np.testing.assert_array_equal(got["points"][old], ref["points"][old])


@pytest.mark.parametrize("use_kernel", [True, False])
def test_window_matches_equal_reference(track_step, use_kernel):
    """The tracker's back-traverse window on the reference's state, by the
    K2 route (its plain version on the CPU: forward pass batched over the
    window, cross-check as one query set of every window row) and by the
    dense route, against the reference's vmapped dense match: the whole
    `Matches`, every row."""
    js = jstate.SlamState(**{n: jnp.asarray(v) for n, v in track_step["pre"].items()})
    jsafe, jok, mj = jtrack._window_matches(js, SNAP, track_step["jcfg"])
    tsafe, tok, mt = ttrack._window_matches(tstate.state_from_numpy(track_step["pre"]), SNAP,
                                            track_step["tcfg"], use_kernel=use_kernel)
    np.testing.assert_array_equal(np32(tsafe), np.asarray(jsafe))
    np.testing.assert_array_equal(np32(tok), np.asarray(jok))
    for f in ("idx", "dist", "ok", "n_matches"):
        np.testing.assert_array_equal(np32(getattr(mt, f)), np.asarray(getattr(mj, f)), err_msg=f)
    assert np32(mt.n_matches).min() > 40


def test_mapping_block_functions(track_step):
    """frame_overlap, fuse, cull_points and local_bundle_adjust on the
    reference's post-track state."""
    post = {n: np.array(v) for n, v in track_step["res"].state._asdict().items()}
    js = jstate.SlamState(**{n: jnp.asarray(v) for n, v in post.items()})
    ts = tstate.state_from_numpy(post)
    jcfg, tcfg = track_step["jcfg"], track_step["tcfg"]
    m = tcfg.mapping
    for j in range(SNAP):
        np.testing.assert_allclose(float(tmap.frame_overlap(ts, SNAP, j)),
                                   float(jmap.frame_overlap(js, SNAP, j)), rtol=1e-6)
    fj = jmap.fuse(js, SNAP, radius_px=m.fuse_radius_px, max_hamming=m.fuse_max_hamming,
                   image_wh=COURSE_WH)
    ft = tmap.fuse(ts, SNAP, radius_px=m.fuse_radius_px, max_hamming=m.fuse_max_hamming,
                   image_wh=COURSE_WH)
    assert int(ft.n_associated) == int(fj.n_associated)
    np.testing.assert_array_equal(np32(ft.state.feat_point), np.asarray(fj.state.feat_point))
    cj, ncj = jmap.cull_points(fj.state, SNAP, min_obs=3, grace=0)
    ct, nct = tmap.cull_points(ft.state, SNAP, min_obs=3, grace=0)
    assert int(nct) == int(ncj) > 0
    np.testing.assert_array_equal(np32(ct.point_valid), np.asarray(cj.point_valid))
    np.testing.assert_array_equal(np32(ct.feat_point), np.asarray(cj.feat_point))
    for covis in (True, False):
        jc = dataclasses.replace(jcfg, ba=dataclasses.replace(jcfg.ba, use_covisibility=covis))
        tc = dataclasses.replace(tcfg, ba=dataclasses.replace(tcfg.ba, use_covisibility=covis))
        for a, b in zip(tlba._select_window(ct, SNAP, tc), jlba._select_window(cj, SNAP, jc)):
            np.testing.assert_array_equal(np32(a), np.asarray(b))
    bj = jlba.local_bundle_adjust(cj, SNAP, jcfg)
    bt = tlba.local_bundle_adjust(ct, SNAP, tcfg)
    np.testing.assert_allclose(float(bt.chi2_initial), float(bj.chi2_initial), rtol=1e-5)
    np.testing.assert_allclose(float(bt.chi2_final), float(bj.chi2_final), rtol=1e-3)
    np.testing.assert_allclose(np32(bt.state.poses), np32(bj.state.poses), atol=1e-3)


def test_slice_against_reference(course, reference_run):
    """Port session vs reference session on the 12-frame course: port
    tracked >= reference - 1 and >= 10; port ATE < 4 cm and <=
    max(1.5 x reference ATE, reference + 0.5 cm)."""
    imgs, gt, k, _ = course
    cfg = SlamConfig(frontend=FrontendConfig(n_features=N_FEAT), **_cfg_kw())
    sess = TSession(cfg, seed=0, run_ba=True, device="cpu")
    for i in range(COURSE_FRAMES):
        sess.add_frame(imgs[i], k, i / 30.0)
    poses, valid, stamps = sess.trajectory()
    assert poses.shape == (COURSE_FRAMES, 3, 4) and np.isfinite(poses).all()
    assert len(stamps) == COURSE_FRAMES
    ref_valid = reference_run["valid"]
    ref_ate = jate.ate(reference_run["poses"][ref_valid], gt[ref_valid]).rmse
    port_ate = tate.ate(poses[valid], gt[valid]).rmse
    assert valid.sum() >= max(ref_valid.sum() - 1, 10), (valid.sum(), ref_valid.sum())
    assert port_ate < 0.04, port_ate
    assert port_ate <= max(1.5 * ref_ate, ref_ate + 0.005), (port_ate, ref_ate)
    assert sess.n_map_points > 100 and len(sess.keyframes) >= 2
