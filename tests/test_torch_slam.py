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


def test_unported_cadence_raises():
    import dataclasses

    from monocular_slam_tpu_torch.slam.session import SlamSession

    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError):
        SlamSession(dataclasses.replace(tcfg, ba=dataclasses.replace(tcfg.ba, keyframe_only=False)),
                    device="cpu")
