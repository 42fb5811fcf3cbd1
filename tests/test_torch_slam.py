"""Parity of the port's state layer with the JAX reference: the numpy
state bridge, the deterministic scatter rules (the reference's CPU backend
keeps the LAST duplicate update; `.at[].set(mode="drop")` drops
out-of-range ones), segment_min, point allocation and frame ingest."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_slam_tpu.slam import state as jstate
from monocular_slam_tpu.slam.config import FrontendConfig as JFrontend
from monocular_slam_tpu.slam.config import SlamConfig as JConfig
from monocular_slam_tpu_torch.slam import state as tstate
from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
from monocular_slam_tpu_torch.utils import scatter
from port_util import np32
from port_util import one_torch_thread  # noqa: F401 (autouse)


def _cfgs():
    kw = dict(max_frames=8, max_points=300, image_wh=(320, 240))
    return (JConfig(frontend=JFrontend(n_features=50), **kw),
            SlamConfig(frontend=FrontendConfig(n_features=50), **kw))


def _np_state(st) -> dict:
    return {k: np.array(v) for k, v in st._asdict().items()}


def _assert_state_equal(port_state, ref: dict):
    got = tstate.state_to_numpy(port_state)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k].astype(got[k].dtype), err_msg=k)
    assert got["desc"].dtype == np.uint32


def test_state_roundtrip():
    jcfg, tcfg = _cfgs()
    ref = _np_state(jstate.empty_state(jcfg))
    _assert_state_equal(tstate.empty_state(tcfg), ref)
    rng = np.random.RandomState(0)
    ref["desc"] = rng.randint(0, 2**32, ref["desc"].shape, dtype=np.uint64).astype(np.uint32)
    ref["points"] = rng.randn(*ref["points"].shape).astype(np.float32)
    _assert_state_equal(tstate.state_from_numpy(ref), ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_set_last_matches_reference_scatter(seed):
    rng = np.random.RandomState(seed)
    dest = rng.randn(10, 3).astype(np.float32)
    idx = rng.randint(-2, 13, 40).astype(np.int32)  # duplicates and out-of-range
    vals = rng.randn(40, 3).astype(np.float32)
    # negative indices drop in the port; route them past the end for JAX
    j_idx = np.where(idx < 0, 99, idx)
    ref = jnp.asarray(dest).at[jnp.asarray(j_idx)].set(jnp.asarray(vals), mode="drop")
    got = scatter.set_last(torch.as_tensor(dest), torch.as_tensor(idx), torch.as_tensor(vals))
    np.testing.assert_array_equal(np32(got), np.asarray(ref))
    rows, cols = rng.randint(0, 5, 40), rng.randint(0, 4, 40)
    d2 = np.zeros((4, 4), np.int32)
    ref2 = jnp.asarray(d2).at[jnp.asarray(rows), jnp.asarray(cols)].set(jnp.arange(40, dtype=jnp.int32), mode="drop")
    got2 = scatter.set_last_2d(torch.as_tensor(d2), torch.as_tensor(rows), torch.as_tensor(cols),
                               torch.arange(40, dtype=torch.int32))
    np.testing.assert_array_equal(np32(got2), np.asarray(ref2))


def test_segment_min_and_topk_ties():
    import jax

    rng = np.random.RandomState(3)
    vals = rng.randint(0, 100, 200).astype(np.int32)
    seg = rng.randint(0, 30, 200).astype(np.int32)
    ref = jax.ops.segment_min(jnp.asarray(vals), jnp.asarray(seg), num_segments=35)
    got = scatter.segment_min(torch.as_tensor(vals), torch.as_tensor(seg), 35)
    np.testing.assert_array_equal(np32(got), np.asarray(ref).astype(np.int32))
    x = np.array([3, 1, 3, 2, 3, 0, 3], np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = scatter.topk_stable(torch.as_tensor(x), 3)
    np.testing.assert_array_equal(np32(ti), np.asarray(ri))  # lowest index first: [0, 2, 4]


def test_allocate_points_and_ingest():
    jcfg, tcfg = _cfgs()
    rng = np.random.RandomState(4)
    ref = _np_state(jstate.empty_state(jcfg))
    ref["point_valid"][rng.rand(300) < 0.5] = True  # a fragmented free list
    xyz = rng.randn(120, 3).astype(np.float32)
    want = rng.rand(120) < 0.7
    jst = jstate.SlamState(**{k: jnp.asarray(v) for k, v in ref.items()})
    js, jslots = jstate.allocate_points(jst, jnp.asarray(xyz), jnp.asarray(want))
    ts, tslots = tstate.allocate_points(tstate.state_from_numpy(ref), torch.as_tensor(xyz),
                                        torch.as_tensor(want))
    np.testing.assert_array_equal(np32(tslots), np.asarray(jslots))
    _assert_state_equal(ts, _np_state(js))

    N = 50
    uv = rng.uniform(0, 300, (N, 2)).astype(np.float32)
    scale = np.full(N, 1.2, np.float32)
    valid = rng.rand(N) > 0.3
    desc = rng.randint(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    pm1 = np.where(rng.rand(N, 256) > 0.5, 1, -1).astype(np.int8)
    k = np.array([250.0, 250.0, 160.0, 120.0], np.float32)
    for frame, slot in ((0, 3), (5, 3)):  # the second write evicts frame 0
        js = jstate.add_frame_features(js, frame, slot, jnp.asarray(uv), jnp.asarray(scale),
                                       jnp.asarray(valid), jnp.asarray(desc), jnp.asarray(pm1),
                                       jnp.asarray(k))
        ts = tstate.add_frame_features(ts, frame, slot, torch.as_tensor(uv), torch.as_tensor(scale),
                                       torch.as_tensor(valid), torch.as_tensor(desc.view(np.int32)),
                                       torch.as_tensor(pm1), torch.as_tensor(k))
        _assert_state_equal(ts, _np_state(js))


def test_cuda_session_without_gpu_raises():
    """No silent fall-back to the CPU: asking for CUDA without a card raises."""
    from monocular_slam_tpu_torch.slam.session import SlamSession

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError):
        SlamSession(tcfg, device="cuda")


def test_slot_eviction_matches_reference():
    """Feature-slot recycling (max_slots < max_frames): the oldest
    non-keyframe outside the protected window goes first, then the oldest
    keyframe; the same sequence as the reference session's allocator."""
    import dataclasses

    from monocular_slam_tpu.slam.session import SlamSession as JSession
    from monocular_slam_tpu_torch.slam.session import SlamSession

    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, max_slots=3, track=dataclasses.replace(jcfg.track, back_traverse=1))
    tcfg = dataclasses.replace(tcfg, max_slots=3, track=dataclasses.replace(tcfg.track, back_traverse=1))
    js, ts = JSession(jcfg), SlamSession(tcfg, device="cpu")
    js._keyframes, ts._keyframes = [1], [1]

    def outcome(sess, i):
        try:
            return sess._acquire_slot(i)
        except ValueError:  # every slot is inside the protected window
            return "full"

    seq_j = [outcome(js, i) for i in (0, 1, 2, 3, 5, 6, 7)]
    seq_t = [outcome(ts, i) for i in (0, 1, 2, 3, 5, 6, 7)]
    assert seq_t == seq_j
    assert "full" in seq_t and any(o != "full" and o[1] >= 0 for o in seq_t)
    slot, prev = seq_t[-1]
    ts._release_slot(slot, prev)
    assert ts._slot_frame[slot] == prev


def test_unported_cadence_raises(monkeypatch):
    """`BAConfig.keyframe_only=False`, the reference's per-frame cadence
    (local BA on every tracked frame, fuse every `fuse_every` and cull every
    `cull_every` frames), through both sessions on a feature course: the
    port runs each stage on exactly its frames, tracks the same frames,
    culls the same points per frame, and keeps an ATE within
    max(1.5 x reference, reference + 5 mm)."""
    import dataclasses

    import jax

    from monocular_slam_tpu.datasets import synthetic
    from monocular_slam_tpu.eval import ate as jate
    from monocular_slam_tpu.slam.session import SlamSession as JSession
    from monocular_slam_tpu_torch.ops import orb
    from monocular_slam_tpu_torch.slam import local_ba, mapping
    from monocular_slam_tpu_torch.slam.session import SlamSession

    ran = {"ba": [], "fuse": [], "cull": []}
    for name, mod, attr in (("ba", local_ba, "local_bundle_adjust"), ("fuse", mapping, "fuse"),
                            ("cull", mapping, "cull_points")):
        def counted(state, i, *a, _name=name, _orig=getattr(mod, attr), **kw):
            ran[_name].append(i)
            return _orig(state, i, *a, **kw)

        monkeypatch.setattr(mod, attr, counted)

    seq = synthetic.feature_sequence(jax.random.PRNGKey(2), n_frames=16, n_world_points=900,
                                     n_features=256, pix_noise=0.3, drop_prob=0.08)
    kw = dict(max_frames=16, max_points=3000)
    jcfg = JConfig(frontend=JFrontend(n_features=256), **kw)
    tcfg = SlamConfig(frontend=FrontendConfig(n_features=256), **kw)
    jcfg = dataclasses.replace(jcfg, ba=dataclasses.replace(jcfg.ba, keyframe_only=False))
    tcfg = dataclasses.replace(tcfg, ba=dataclasses.replace(tcfg.ba, keyframe_only=False))
    js, ts = JSession(jcfg, seed=1), SlamSession(tcfg, seed=1, device="cpu")
    k = np.asarray(seq.k, np.float32)
    for i, f in enumerate(seq.frames):
        js.add_frame_features(f, seq.k, seq.timestamps[i])
        arrs = [np.array(x) for x in f]
        ts.add_frame_features(orb.Features(*[torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32
                                                             else a) for a in arrs]),
                              k, float(seq.timestamps[i]))
    jp, jv, _ = js.trajectory()
    tp, tv, _ = ts.trajectory()
    np.testing.assert_array_equal(tv, jv)
    m = tcfg.mapping
    stepped = [s.frame for s in ts.stats[2:] if s.tracked]  # frames after the bootstrap pair
    assert ran["ba"] == stepped and len(stepped) >= 12
    assert ran["fuse"] == [i for i in stepped if i % m.fuse_every == 0]
    assert ran["cull"] == [i for i in stepped if i % m.cull_every == 0]
    assert [s.n_culled for s in ts.stats] == [s.n_culled for s in js.stats]
    assert sum(s.n_culled for s in ts.stats) > 0
    gt = np.asarray(seq.poses_gt)
    ref = jate.ate(jp[jv], gt[jv]).rmse
    assert jate.ate(tp[tv], gt[tv]).rmse <= max(1.5 * ref, ref + 0.005)


@pytest.fixture(scope="module")
def image_course():
    """Eight rendered 320x240 frames, the config, and the trajectory of a
    loop-closing session fed by `add_frame` (the reference run for the
    buffer and prewarm tests)."""
    from monocular_slam_tpu_torch.datasets import render

    imgs, _, k = render.render_sequence(seed=2, n_frames=8, wh=(320, 240), tex_size=512,
                                        device="cpu")
    cfg = SlamConfig(max_frames=16, max_points=2000, image_wh=(320, 240),
                     frontend=FrontendConfig(n_features=300))
    sess = _image_session(cfg)
    for i in range(imgs.shape[0]):
        sess.add_frame(imgs[i], k, i / 30.0)
    return imgs, k, cfg, sess.trajectory()


def _image_session(cfg):
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser
    from monocular_slam_tpu_torch.slam.session import SlamSession

    lc = LoopCloser(vocabulary.load_default(device="cpu"), cfg, device="cpu")
    return SlamSession(cfg, seed=0, loop_closer=lc, device="cpu")


def test_add_frame_from_buffer(image_course):
    """Frames taken from a uint8 (N, H, W) buffer on the session's device
    give the `add_frame` trajectory exactly; a buffer elsewhere raises."""
    imgs, k, cfg, (poses, valid, stamps) = image_course
    buf = imgs.to(torch.uint8)
    sess = _image_session(cfg)
    for i in range(buf.shape[0]):
        sess.add_frame_from_buffer(buf, i, k, i / 30.0)
    p, v, s = sess.trajectory()
    assert valid.sum() >= 6
    np.testing.assert_array_equal(v, valid)
    np.testing.assert_array_equal(p, poses)
    np.testing.assert_array_equal(s, stamps)
    with pytest.raises(ValueError):
        sess.add_frame_from_buffer(buf.to("meta"), 0, k)


def test_prewarm_keeps_the_trajectory(image_course):
    """`prewarm` (the zero-image extraction in both steering modes and the
    loop closer's functorch paths) returns its seconds and leaves state,
    generator and counters alone: the trajectory is bit-identical."""
    from monocular_slam_tpu_torch.slam import state as tstate

    imgs, k, cfg, (poses, valid, _) = image_course
    sess = _image_session(cfg)
    before = tstate.state_to_numpy(sess.state)
    gen_state = sess.gen.get_state()
    secs = sess.prewarm(image=True)
    assert secs > 0.0 and torch.equal(sess.gen.get_state(), gen_state)
    after = tstate.state_to_numpy(sess.state)
    assert all(np.array_equal(before[n], after[n]) for n in before)
    assert sess._next == 0 and not sess.stats and sess.reloc_attempts == 0
    for i in range(imgs.shape[0]):
        sess.add_frame(imgs[i], k, i / 30.0)
    p, v, _ = sess.trajectory()
    np.testing.assert_array_equal(v, valid)
    np.testing.assert_array_equal(p, poses)
