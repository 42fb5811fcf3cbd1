"""The port's per-frame step program against the JAX reference's, on the
CPU (the card's captures are in `test_torch_cuda.py` and `chip_smoke.py`'s
program phase):

  - `session_step`, `image_session_step` and `pack_step` against the
    reference's `_session_step`, `_image_session_step` and `_pack_step`,
    from the same mid-run state (the port's session over a threefry
    feature course, frames 0-7) and the same key, on a keyframe and a
    non-keyframe frame, with local BA on and off and at keyframe rate and
    per frame, so that both sides of every `cond` run;
  - the device-key threefry route against the host-key route, bit for bit;
  - `utils/graph.cond`'s eager semantics;
  - the step's functions under `port_util.sync_audit`: no host read and no
    host-to-device copy anywhere but in K3's plain stand-ins;
  - a session whose outcomes are read lagged against one that reads them at
    once.

The reference runs with x64 off, as outside the tests, so that its draws
are the float32 uniforms the port draws from the same key, and its step
functions run under `jax.jit`, as its session compiles them (op by op, the
first step compiled for ~35 s on the CPU; one program compiles in ~6 s).
Its local BA window (3) and iterations (2) and its PnP hypotheses (64) are
cut, and the image step extracts over 2 pyramid levels."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_slam_tpu.datasets import synthetic as jsyn
from monocular_slam_tpu.retrieval import vocabulary as jvoc
from monocular_slam_tpu.slam import loop_closer as jlc
from monocular_slam_tpu.slam import session as jsess
from monocular_slam_tpu.slam import state as jstate
from monocular_slam_tpu.slam import config as jconf
from monocular_slam_tpu_torch.datasets import synthetic as tsyn
from monocular_slam_tpu_torch.geometry import epipolar
from monocular_slam_tpu_torch.retrieval import vocabulary as tvoc
from monocular_slam_tpu_torch.slam import config as tconf
from monocular_slam_tpu_torch.slam import loop_closer as tlc
from monocular_slam_tpu_torch.slam import session as tsess
from monocular_slam_tpu_torch.slam import state as tstate
from monocular_slam_tpu_torch.utils import graph, prng
from port_util import HostSyncError, np32, sync_audit
from port_util import one_torch_thread  # noqa: F401 (autouse)

N_FEAT = 300
FRAME = 8  # the stepped frame; the state holds frames 0-7
KEY = 11
KW = dict(max_frames=16, max_points=3000)


def _cfg(mod, keyframe_only=True, warmup=10, cadence=2, fuse_every=4, cull_every=8,
         n_levels=8):
    return mod.SlamConfig(
        frontend=mod.FrontendConfig(n_features=N_FEAT, steer_mode="binned", n_levels=n_levels),
        ba=mod.BAConfig(window=3, local_iters=2, keyframe_only=keyframe_only,
                        warmup_frames=warmup, cadence_floor=cadence),
        track=mod.TrackConfig(pnp_iters=64),
        mapping=mod.MappingConfig(fuse_every=fuse_every, cull_every=cull_every), **KW)


@pytest.fixture(scope="module")
def course():
    """The port's session over frames 0-7 of a threefry feature course
    (`feature_sequence(PRNGKey(0))`, the reference's course), its state,
    and frame 8's features as numpy."""
    seq = tsyn.feature_sequence(prng.PRNGKey(0), n_frames=FRAME + 1, n_features=N_FEAT,
                                device="cpu")
    sess = tsess.SlamSession(_cfg(tconf), seed=0, device="cpu")
    for i in range(FRAME):
        sess.add_frame_features(seq.frames[i], seq.k, float(i))
    assert sess.stats[-1].tracked
    return dict(state=tstate.state_to_numpy(sess.state), k=np.asarray(seq.k, np.float32),
                feats={n: np.array(v) for n, v in seq.frames[FRAME]._asdict().items()},
                keyframes=sess.keyframes)


def _jstate(d: dict):
    return jstate.SlamState(**{n: jnp.asarray(v) for n, v in d.items()})


def _ingest_ref(course):
    f = course["feats"]
    return jstate.add_frame_features(
        _jstate(course["state"]), FRAME, FRAME, jnp.asarray(f["uv"]), jnp.asarray(f["scale"]),
        jnp.asarray(f["valid"]), jnp.asarray(f["desc"].view(np.uint32)),
        jnp.asarray(f["desc_pm1"]), jnp.asarray(course["k"]))


def _ingest_port(course):
    f = {n: torch.as_tensor(v) for n, v in course["feats"].items()}
    return tstate.add_frame_features(
        tstate.state_from_numpy(course["state"]), torch.tensor(FRAME), torch.tensor(FRAME),
        f["uv"], f["scale"], f["valid"], f["desc"], f["desc_pm1"], torch.as_tensor(course["k"]))


def _pnp_key():
    """The PnP key `tracker.track` splits off the session subkey KEY."""
    return prng.key_on(prng.split(prng.PRNGKey(KEY))[0], "cpu")


# (name, config overrides, run_ba, last_kf, expected is_kf, fuse, BA, cull)
CASES = [
    ("keyframe", dict(), True, -1, True, True, True, True),
    ("warmup_block", dict(), True, FRAME - 1, False, False, True, False),
    ("no_block", dict(warmup=0, cadence=0), False, FRAME - 1, False, False, False, False),
    ("per_frame_all", dict(keyframe_only=False), True, FRAME - 1, False, True, True, True),
    ("per_frame_none", dict(keyframe_only=False, fuse_every=3, cull_every=5), False, FRAME - 1,
     False, False, False, False),
]


@pytest.fixture(scope="module")
def reference_steps(course):
    out = {}
    step = jax.jit(jsess._session_step, static_argnums=(4, 5))  # (cfg, run_ba)
    with jax.enable_x64(False):
        st = _ingest_ref(course)
        for name, over, run_ba, last_kf, *_ in CASES:
            cfg = _cfg(jconf, **over)
            s, stats = step(st, FRAME, jnp.asarray(last_kf, jnp.int32), jax.random.PRNGKey(KEY),
                            cfg, run_ba)
            out[name] = ({n: np.array(v) for n, v in s._asdict().items()},
                         {n: np.array(v) for n, v in stats._asdict().items()})
    return out


def _assert_states(got, ref: dict):
    """Associations, validity flags and counts exactly; every pose to 2e-3
    (`test_torch_slice.test_track_step`: the LO refit's 12x12 `eigh`
    differs by ~1e-4 between XLA and torch, which moves the tracked pose by
    up to ~1.5e-3); every valid point to 1e-2 of its coordinates (points
    triangulated from that pose at depths up to ~50, and the local BA's
    window points solved against it, inherit its difference: measured up to
    0.45%)."""
    got = tstate.state_to_numpy(got)
    for n in ("feat_point", "pose_valid", "point_valid", "n_points", "slot_of", "frame_of"):
        np.testing.assert_array_equal(got[n], ref[n].astype(got[n].dtype), err_msg=n)
    np.testing.assert_allclose(got["poses"], ref["poses"], atol=2e-3)
    np.testing.assert_allclose(got["points"][ref["point_valid"]],
                               ref["points"][ref["point_valid"]], rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_session_step_like_reference(course, reference_steps, case):
    name, over, run_ba, last_kf, want_kf, want_fuse, want_ba, want_cull = case
    ref_state, ref_stats = reference_steps[name]
    assert bool(ref_stats["is_keyframe"]) == want_kf  # the case runs the branches it names
    assert bool(ref_stats["tracked"])
    with torch.inference_mode():
        s, stats = tsess.session_step(_ingest_port(course), torch.tensor(FRAME),
                                      torch.tensor(last_kf, dtype=torch.int32), _pnp_key(),
                                      _cfg(tconf, **over), run_ba)
    assert isinstance(stats, tsess.StepStats) and stats._fields == tuple(ref_stats)
    for n in ("tracked", "n_inliers", "n_new_points", "n_fused", "n_culled", "is_keyframe",
              "last_kf"):
        assert int(getattr(stats, n)) == int(ref_stats[n]), n
    assert np.isfinite(float(stats.chi2_after)) == want_ba == np.isfinite(ref_stats["chi2_after"])
    if want_ba:
        # the first linearization sees the pose of the LO refit (see above)
        np.testing.assert_allclose(float(stats.chi2_before), ref_stats["chi2_before"], rtol=1e-2)
        np.testing.assert_allclose(float(stats.chi2_after), ref_stats["chi2_after"], rtol=1e-2)
    if not want_fuse:
        assert int(stats.n_fused) == 0
    if not want_cull:
        assert int(stats.n_culled) == 0
    _assert_states(s, ref_state)


@pytest.fixture(scope="module")
def vocab(course):
    desc = course["state"]["desc_pm1"][:FRAME][course["state"]["kp_valid"][:FRAME]]
    jv = jvoc.train(desc, k=6, L=2, seed=0)
    tv = tvoc.vocabulary_from_numpy([np.asarray(n) for n in jv.nodes], np.asarray(jv.weights),
                                    jv.k, jv.L, device="cpu")
    return jv, tv


@pytest.mark.parametrize("closer", [True, False])
def test_pack_step_like_reference(course, reference_steps, vocab, closer):
    """The keyframe case's state and outcome through both `pack_step`s
    with the same BoW database (frames 0-7's rows): the packed vector's
    integer lanes exactly, its float lanes (chi2, score, floor) to 1e-5 of
    the same float32 inputs, and the database row the keyframe writes."""
    ref_state, ref_stats = reference_steps["keyframe"]
    jv, tv = vocab
    lcfg = dict(min_gap=3, min_score=0.0)
    st = tstate.state_from_numpy(ref_state)
    db = torch.stack([tvoc.bow_vector(tv, st.desc_pm1[s], st.kp_valid[s]) for s in range(FRAME)]
                     + [torch.zeros(tv.n_words)] * (KW["max_frames"] - FRAME))
    with jax.enable_x64(False):
        jstats = jsess.StepStats(**{n: jnp.asarray(v) for n, v in ref_stats.items()})
        _, jdb, jkf, jpacked = jsess._pack_step(
            _jstate(ref_state), jstats, jnp.asarray(db.numpy()), FRAME,
            jv if closer else None, jlc.LoopClosureConfig(**lcfg))
    tstats = tsess.StepStats(**{n: torch.as_tensor(v) for n, v in ref_stats.items()})
    tdb = db.clone()
    _, tdb, tkf, tpacked = tsess.pack_step(st, tstats, tdb, torch.tensor(FRAME),
                                           tv if closer else None,
                                           tlc.LoopClosureConfig(**lcfg) if closer else None)
    jp, tp = np.asarray(jpacked), np32(tpacked)
    assert tp.dtype == np.int32 and tp.shape == (tsess.PACKED_LEN,) == jp.shape
    n_i = len(tsess._I32_FIELDS)
    np.testing.assert_array_equal(tp[:n_i], jp[:n_i])
    np.testing.assert_allclose(tp[n_i:].view(np.float32), jp[n_i:].view(np.float32), rtol=1e-5)
    assert int(tkf) == int(jkf) == FRAME
    vals = tsess.unpack(tp)
    assert vals["is_keyframe"] and vals["tracked"]
    if closer:
        assert vals["cand_n"] > 0 and vals["cand_j"] >= 0
        np.testing.assert_allclose(np32(tdb), np.asarray(jdb), atol=1e-6)
        assert float(tdb[FRAME].sum()) > 0.5
    else:
        assert vals["cand_j"] == -1 and vals["cand_n"] == 0


def test_image_session_step_like_reference(course):
    """A 160x120 textured frame (`textured_sequence(PRNGKey(4))`, the same
    image in both packages) into slot 8 of the course state: extraction,
    undistortion and ingest, then the step, which fails to track it (the
    plane is not the course's scene) on both sides: outcome equal, the
    state unchanged but for the ingested slot, whose keypoints agree.
    Extraction runs over 2 pyramid levels, to keep the reference's compile
    short."""
    img = np.asarray(jsyn.textured_sequence(jax.random.PRNGKey(4), n_frames=1,
                                            wh=(160, 120))[0][0], np.float32)
    k = course["k"]
    dist = np.zeros(5, np.float32)
    cfg_j, cfg_t = _cfg(jconf, n_levels=2), _cfg(tconf, n_levels=2)
    with jax.enable_x64(False):
        s_j, stats_j = jax.jit(jsess._image_session_step, static_argnums=(8, 9))(
            _jstate(course["state"]), jnp.asarray(img), FRAME, FRAME, jnp.asarray(-1, jnp.int32),
            jax.random.PRNGKey(KEY), jnp.asarray(k), jnp.asarray(dist), cfg_j, True)
    with torch.inference_mode():
        s_t, stats_t = tsess.image_session_step(
            tstate.state_from_numpy(course["state"]), torch.as_tensor(img), torch.tensor(FRAME),
            torch.tensor(FRAME), torch.tensor(-1, dtype=torch.int32), _pnp_key(),
            torch.as_tensor(k), torch.as_tensor(dist), cfg_t, True)
    for n in ("tracked", "is_keyframe", "n_new_points", "n_fused", "n_culled", "last_kf"):
        assert int(getattr(stats_t, n)) == int(np.asarray(getattr(stats_j, n))), n
    assert not bool(stats_t.tracked)
    got = tstate.state_to_numpy(s_t)
    ref = {n: np.asarray(v) for n, v in s_j._asdict().items()}
    for n in ("poses", "pose_valid", "points", "point_valid", "feat_point", "slot_of", "frame_of"):
        np.testing.assert_array_equal(got[n], ref[n].astype(got[n].dtype), err_msg=n)
    vj, vt = ref["kp_valid"][FRAME], got["kp_valid"][FRAME]
    np.testing.assert_array_equal(vt, vj)
    assert vt.sum() > 50
    np.testing.assert_allclose(got["kp_uv"][FRAME][vt], ref["kp_uv"][FRAME][vt], atol=1e-3)
    assert (got["desc_pm1"][FRAME][vt] == ref["desc_pm1"][FRAME][vt]).mean() >= 0.995


@pytest.mark.parametrize("shape", [(64, 300), (7, 13), (512, 1000)])
def test_device_key_draws_equal_host_key(shape):
    """`uniform_on`/`bits_on` from the key's device words equal the host
    key's, bit for bit, and the numpy generator; so does `_sample_indices`."""
    for seed in (0, KEY, 2**32 - 1):
        key = prng.split(prng.PRNGKey(seed))[1]
        dev_key = prng.key_on(key, "cpu")
        assert dev_key.dtype == torch.int64 and tuple(dev_key.shape) == (2,)
        a = prng.uniform_on(key, shape, "cpu", minval=1e-6)
        b = prng.uniform_on(dev_key, shape, "cpu", minval=1e-6)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        np.testing.assert_array_equal(b.numpy(), prng.uniform(key, shape, np.float32, 1e-6, 1.0))
        assert torch.equal(prng.bits_on(key, shape, "cpu"), prng.bits_on(dev_key, shape, "cpu"))
        mask = torch.arange(shape[1]) % 3 != 0
        assert torch.equal(epipolar._sample_indices(key, shape[0], 6, mask),
                           epipolar._sample_indices(dev_key, shape[0], 6, mask))
    with pytest.raises(ValueError):
        prng.uniform_on(torch.zeros(2, dtype=torch.int32), (3, 3), "cpu")


def test_cond_eager_semantics():
    """A host bool or a 0-d tensor picks one branch and runs only it, with
    the operands, outside a capture."""
    calls = []

    def t(x, y):
        calls.append("t")
        return x + y, torch.zeros((), dtype=torch.int32)

    def f(x, y):
        calls.append("f")
        return x - y, torch.ones((), dtype=torch.int32)

    x, y = torch.tensor([1.0, 2.0]), torch.tensor([0.5, 0.5])
    for pred, want, flag in ((True, [1.5, 2.5], 0), (torch.tensor(False), [0.5, 1.5], 1),
                             (torch.tensor(True), [1.5, 2.5], 0), (False, [0.5, 1.5], 1)):
        calls.clear()
        out, n = graph.cond(pred, t, f, x, y)
        assert out.tolist() == want and int(n) == flag and len(calls) == 1
    assert not graph.capturing()


def test_step_functions_have_no_host_round_trip(course, vocab):
    """Every function of the card's two step programs (ingest, image
    ingest, `track_step`, the mapping block with host-decided parts,
    `pack_step` with a closer) under `sync_audit`: nothing reads the
    device on the host or copies host data to it, except K3's plain
    stand-ins (`torch.linalg.eigh` / `svd`), which are the kernel on a card.
    One run first fills the per-device constant caches, as the capture's
    warm-up run does. The audit itself catches each kind it names."""
    _, tv = vocab
    cfg = _cfg(tconf)
    img = torch.as_tensor(np.asarray(tsyn.textured_sequence(prng.PRNGKey(4), n_frames=1,
                                                            device="cpu")[0][0]))
    db = torch.zeros((KW["max_frames"], tv.n_words))
    lcfg = tlc.LoopClosureConfig(min_gap=3)
    i, slot = torch.tensor(FRAME), torch.tensor(FRAME)
    k, dist = torch.as_tensor(course["k"]), torch.zeros(5)

    def step():
        st = _ingest_port(course)
        tsess.image_ingest(st, img, i, slot, k, dist, cfg)
        t = tsess.track_step(st, i, torch.tensor(-1, dtype=torch.int32), _pnp_key(), cfg)
        for preds in ((True, True, True), (False, True, False), (False, False, False)):
            s, c0, c1, nf, nc = tsess.mapping_block(t.state, i, preds, cfg)
        stats = tsess.StepStats(t.ok, t.n_inliers, t.n_new_points, c0, c1, nf, nc,
                                t.is_keyframe, t.last_kf)
        tsess.pack_step(s, stats, db, i, tv, lcfg)

    with torch.inference_mode():
        step()
        inputs = [_ingest_port(course), _pnp_key()]  # host data made outside the audit
        with sync_audit(raise_on_sync=False) as audit:
            st = inputs[0]
            tsess.image_ingest(st, img, i, slot, k, dist, cfg)
            t = tsess.track_step(st, i, torch.full((), -1, dtype=torch.int32), inputs[1], cfg)
            for preds in ((True, True, True), (False, True, False), (False, False, False)):
                s, c0, c1, nf, nc = tsess.mapping_block(t.state, i, preds, cfg)
            tsess.pack_step(s, tsess.StepStats(t.ok, t.n_inliers, t.n_new_points, c0, c1, nf, nc,
                                               t.is_keyframe, t.last_kf), db, i, tv, lcfg)
    bad = [e for e in audit.events if not e[1].startswith("ops/small_eigh.py")]
    assert not bad, bad
    assert any(e[1].startswith("ops/small_eigh.py") for e in audit.events)
    x = torch.arange(4.0)
    for fn in (lambda: x.sum().item(), lambda: bool(x[0] > 1), lambda: x[x > 1],
               lambda: x[torch.tensor(1)], lambda: torch.tensor(2.0), lambda: x.tolist(),
               lambda: torch.linalg.eigh(torch.eye(3)),
               lambda: graph.cond(torch.tensor(True), lambda: 1, lambda: 2),
               lambda: x.clone().__setitem__(1, 5.0)):  # a copy to the card's element
        with pytest.raises(HostSyncError), sync_audit():
            fn()
    with sync_audit():
        y = x.clone()
        y[1] = torch.full((), 5.0)  # a device value stored by indexing
        graph.cond(True, lambda: 1, lambda: 2)


def test_lagged_stats_equal_immediate(course):
    """Two sessions over the course: one reads every outcome the moment its
    frame returns, the other only through the session's lagged processing
    (the ring of host rows is reused every `stat_lag + 1` frames): the same
    trajectory, keyframes and per-frame outcomes."""
    seq = tsyn.feature_sequence(prng.PRNGKey(0), n_frames=FRAME + 4, n_features=N_FEAT,
                                device="cpu")
    fields = tsess._I32_FIELDS + tsess._F32_FIELDS
    runs = []
    for eager_read in (True, False):
        sess = tsess.SlamSession(_cfg(tconf), seed=0, device="cpu")
        read = []
        for i, f in enumerate(seq.frames):
            st = sess.add_frame_features(f, seq.k, float(i))
            if eager_read:
                read.append([getattr(st, n) for n in fields])
        poses, valid, _ = sess.trajectory()
        if not eager_read:
            read = [[getattr(st, n) for n in fields] for st in sess.stats]
        runs.append((poses, valid, sess.keyframes, read))
    (p0, v0, k0, r0), (p1, v1, k1, r1) = runs
    np.testing.assert_array_equal(p0, p1)
    np.testing.assert_array_equal(v0, v1)
    assert k0 == k1 and len(k0) >= 1
    np.testing.assert_equal(r0, r1)
    assert sum(1 for r in r1 if r[0]) >= len(seq.frames) - 1
