"""The port's profiling drivers (`monocular_slam_tpu_torch/benchmarks/
{step_profile,compile_profile}.py` and `loop_match_scale.py`'s direct-index
section) on the CPU at small sizes, against the JAX package's functions
(never the JAX drivers' `main()`s, which write into `benchmarks/`):

  - each writes exactly its reference driver's JSON keys, read from the
    committed `benchmarks/step_profile_tpu.json` and
    `compile_profile_tpu.json`, and, for the direct-index rows that no
    record holds, from the JAX driver's AST;
  - step_profile's chained session step, track and local BA, from the
    port's warm state, match the reference's functions chained from the
    same state (carried across with `slam/state.state_from_numpy`'s
    counterpart numpy arrays; the reference with x64 off, so that its draws
    are the port's float32 ones), with `test_torch_slice.py::
    test_track_step`'s tolerances: flags, inlier counts and associations
    exact, poses within 2e-3; fuse, cull and add_feats exactly;
  - compile_profile's nine programs run, and track, local BA, the session
    step, fuse, cull, overlap and add_feats on its 12-frame state match the
    reference's the same way;
  - the direct-index section draws the reference's descriptors from its
    keys, and K2's `Matches` (its plain version here) equal the dense
    route's.

Both sides run a cut configuration (200 features, 16 frames, a 3-frame BA
window at 3 LM iterations, 64 PnP hypotheses); the reference's functions
are jitted once each with the configuration static, so the two drivers'
calls share one compiled program per function."""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_slam_tpu.slam import config as jconf
from monocular_slam_tpu.slam import local_ba as jlba
from monocular_slam_tpu.slam import mapping as jmap
from monocular_slam_tpu.slam import session as jsess
from monocular_slam_tpu.slam import state as jstate
from monocular_slam_tpu.slam import tracker as jtrack
from monocular_slam_tpu_torch import benchmarks
from monocular_slam_tpu_torch.benchmarks import compile_profile, loop_match_scale, step_profile
from monocular_slam_tpu_torch.datasets import synthetic as tsyn
from monocular_slam_tpu_torch.slam import config as tconf
from monocular_slam_tpu_torch.slam import state as tstate
from monocular_slam_tpu_torch.utils import prng
from port_util import np32
from port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
N_FEAT = 200
FRAMES = 12  # the warm session's and compile_profile's frames; the stepped frame is 11
LINKS = 2


def _cfg(mod, **ba):
    return mod.SlamConfig(
        max_frames=16, max_points=3000,
        frontend=mod.FrontendConfig(n_features=N_FEAT, steer_mode="binned"),
        ba=mod.BAConfig(window=3, local_iters=3, **ba),
        track=mod.TrackConfig(pnp_iters=64))


# the reference's functions, jitted once (configuration static, frame traced)
J_STEP = jax.jit(jsess._session_step, static_argnums=(4, 5))
J_TRACK = jax.jit(jtrack.track, static_argnums=(3,))
J_BA = jax.jit(jlba.local_bundle_adjust, static_argnums=(2,))
J_FUSE = jax.jit(jmap.fuse, static_argnames=("radius_px", "max_hamming", "image_wh"))
J_CULL = jax.jit(jmap.cull_points, static_argnames=("min_obs", "grace"))
J_OVERLAP = jax.jit(jmap.frame_overlap)
J_ADD = jax.jit(jstate.add_frame_features)


def _jstate(st) -> jstate.SlamState:
    return jstate.SlamState(**{n: jnp.asarray(v) for n, v in tstate.state_to_numpy(st).items()})


def _np_state(st) -> dict:
    if isinstance(st, jstate.SlamState):
        return {n: np.array(v) for n, v in st._asdict().items()}
    return tstate.state_to_numpy(st)


def _assert_states(got, ref, exact: bool = False):
    """Associations, validity and counts exactly; poses to 2e-3 and valid
    points to 1e-2 (`test_torch_program._assert_states`), or every field
    exactly with `exact`."""
    got, ref = _np_state(got), _np_state(ref)
    for n in ("feat_point", "pose_valid", "point_valid", "n_points", "slot_of", "frame_of",
              "kp_valid", "n_frames"):
        np.testing.assert_array_equal(got[n], ref[n].astype(got[n].dtype), err_msg=n)
    if exact:
        for n in got:
            np.testing.assert_array_equal(got[n], ref[n].astype(got[n].dtype), err_msg=n)
        return
    np.testing.assert_allclose(got["poses"], ref["poses"], atol=2e-3)
    v = ref["point_valid"]
    np.testing.assert_allclose(got["points"][v], ref["points"][v], rtol=1e-2, atol=1e-3)


def _chain(fn, st, n=LINKS):
    with jax.enable_x64(False):
        for _ in range(n):
            st = fn(st)
    return st


def _dict_keys(path: Path, target: str) -> list:
    """The string keys of the dict literal assigned to `target` (source
    text of the subscript or name) in a JAX driver."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and ast.unparse(node.targets[0]) == target):
            return [k.value for k in node.value.keys]
    raise AssertionError(f"no dict literal assigned to {target} in {path}")


@pytest.fixture(scope="module")
def step_run():
    det = {}
    out = step_profile.run("cpu", n_frames=FRAMES, cfg=_cfg(tconf), n=LINKS, n_short=LINKS,
                           n_trivial=2, wh=(320, 240), details=det)
    return out, det


@pytest.fixture(scope="module")
def compile_run():
    from monocular_slam_tpu_torch.utils import cuda_build

    det = {}
    out = compile_profile.run("cpu", cfg=_cfg(tconf), n_frames=FRAMES,
                              build_dir=str(cuda_build.BUILD_DIR), details=det)
    return out, det


def test_step_profile_writes_the_reference_keys(step_run):
    out, det = step_run
    want = json.loads((ROOT / "benchmarks" / "step_profile_tpu.json").read_text())
    assert list(out) == list(want)
    assert all(np.isfinite(v) and v > 0 for k, v in out.items() if k != "device")
    assert out["device"] == "cpu"
    assert all(det[n]["replays"] == LINKS for n in ("track", "session_step", "extract"))


WARM_KEY = jax.random.PRNGKey(step_profile.TRACK_KEY)


@pytest.mark.parametrize("stage", ["session_step", "track", "local_ba_3it"])
def test_step_profile_chained_stage_like_reference(step_run, stage):
    _, det = step_run
    i, lkf = jnp.int32(FRAMES - 1), jnp.int32(FRAMES - 5)
    cfg = _cfg(jconf)
    fns = {
        "session_step": lambda st: J_STEP(st, i, lkf, WARM_KEY, cfg, True)[0],
        "track": lambda st: J_TRACK(st, i, WARM_KEY, cfg).state,
        "local_ba_3it": lambda st: J_BA(st, i, cfg).state,
    }
    ref = _chain(fns[stage], _jstate(det["warm_state"]))
    _assert_states(det[stage]["carry"], ref)


@pytest.mark.parametrize("stage", ["fuse", "cull", "add_feats"])
def test_step_profile_mapping_stage_exact(step_run, stage):
    _, det = step_run
    i = jnp.int32(FRAMES - 1)
    cfg = _cfg(jconf)
    m = cfg.mapping
    seq = tsyn.feature_sequence(prng.PRNGKey(0), n_frames=FRAMES, n_world_points=2500,
                                n_features=N_FEAT, pix_noise=0.3, drop_prob=0.08, device="cpu")
    f0 = {n: jnp.asarray(np32(v)) for n, v in seq.frames[0]._asdict().items()}
    k = jnp.asarray(np32(seq.k))
    fns = {
        "fuse": lambda st: J_FUSE(st, i, radius_px=m.fuse_radius_px,
                                  max_hamming=m.fuse_max_hamming, image_wh=cfg.image_wh).state,
        "cull": lambda st: J_CULL(st, i, min_obs=m.cull_min_obs, grace=m.cull_grace)[0],
        "add_feats": lambda st: J_ADD(st, 15, 15, f0["uv"], f0["scale"], f0["valid"],
                                      f0["desc"].view(jnp.uint32), f0["desc_pm1"], k),
    }
    ref = _chain(fns[stage], _jstate(det["warm_state"]))
    _assert_states(det[stage]["carry"], ref, exact=True)


def test_compile_profile_writes_the_reference_keys(compile_run):
    out, det = compile_run
    want = json.loads((ROOT / "benchmarks" / "compile_profile_tpu.json").read_text())
    assert list(out) == list(want)
    assert list(out["programs"]) == list(want["programs"])
    for name, r in out["programs"].items():
        assert list(r) == list(want["programs"][name])
        assert r["cold_s"] > 0 and r["steady_ms"] > 0, name
    assert det["track"]["replays"] == compile_profile.N_STEADY


def test_compile_profile_programs_like_reference(compile_run):
    _, det = compile_run
    st = _jstate(det["state"])
    cfg = _cfg(jconf)
    m = cfg.mapping
    key = jax.random.PRNGKey(1)
    i, j = jnp.int32(FRAMES - 1), jnp.int32(FRAMES - 7)
    with jax.enable_x64(False):
        trk = J_TRACK(st, i, key, cfg)
        got = det["track"]["outputs"]
        assert bool(got.ok) == bool(trk.ok)
        assert int(got.n_pnp_inliers) == int(trk.n_pnp_inliers)
        _assert_states(got.state, trk.state)
        _assert_states(det["local_ba"]["outputs"].state, J_BA(st, i, cfg).state)
        _assert_states(det["session_step"]["outputs"], J_STEP(st, i, j, key, cfg, True)[0])
        _assert_states(det["fuse"]["outputs"].state,
                       J_FUSE(st, i, radius_px=m.fuse_radius_px, max_hamming=m.fuse_max_hamming,
                              image_wh=cfg.image_wh).state, exact=True)
        cs, cn = J_CULL(st, i, min_obs=m.cull_min_obs, grace=m.cull_grace)
        _assert_states(det["cull"]["outputs"][0], cs, exact=True)
        assert int(det["cull"]["outputs"][1]) == int(cn)
        assert float(det["overlap"]["outputs"]) == float(J_OVERLAP(st, i, j))
    f = det["extract_640x480"]["outputs"]
    assert f.uv.shape == (N_FEAT, 2) and int(f.valid.sum()) > 0
    assert det["add_feats"]["outputs"].n_frames.shape == ()


def test_direct_index_draws_and_routes():
    """Section 4 at small sizes: the reference's keys for its descriptors
    (the sign of a normal from `fold_in(PRNGKey(0), M)` and from
    `split(PRNGKey(0), 2)[0]`), its JSON keys, and K2's route equal to the
    dense route."""
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(False):
        want_map = np.asarray(jnp.sign(jax.random.normal(jax.random.fold_in(key, 300),
                                                         (300, 256))).astype(jnp.int8))
        want_q = np.asarray(jnp.sign(jax.random.normal(jax.random.split(key, 2)[0],
                                                       (64, 256))).astype(jnp.int8))
    np.testing.assert_array_equal(
        loop_match_scale.threefry_pm1(prng.fold_in(prng.PRNGKey(0), 300), 300, "cpu").numpy(),
        want_map)
    np.testing.assert_array_equal(
        loop_match_scale.threefry_pm1(prng.split(prng.PRNGKey(0), 2)[0], 64, "cpu").numpy(),
        want_q)
    det = {}
    out = loop_match_scale.direct_index(64, (300,), "cpu", n=1, details=det)
    want = _dict_keys(ROOT / "benchmarks" / "loop_match_scale.py",
                      "out[f'direct_index_vs_full_{M}']")
    assert list(out) == ["direct_index_vs_full_300"]
    assert list(out["direct_index_vs_full_300"]) == want
    assert det[300]["kernel_equals_dense"]


def test_step_profile_replayed_chains_on_the_cpu():
    """`benchmarks.Replayed` on the CPU: each step feeds the last result
    back."""
    chain = benchmarks.Replayed(lambda x: x * 2.0, torch.ones(3), "cpu")
    for _ in range(3):
        chain.step()
    np.testing.assert_array_equal(chain.current().numpy(), np.full(3, 8.0, np.float32))
    chain.reset(torch.ones(3))
    chain.step()
    np.testing.assert_array_equal(chain.current().numpy(), np.full(3, 2.0, np.float32))


def test_replayed_keyed_extra_on_the_cpu():
    """`benchmarks.Replayed` with a key and extra outputs (the bench's fused
    step): fn gets the host key of the last `step(key)`, the carry chains,
    and `step` returns the extras."""
    from monocular_slam_tpu_torch.utils import prng

    def fn(x, key):
        return x + 1.0, torch.as_tensor(np.asarray(key).astype(np.int64))

    k0, k1 = prng.PRNGKey(3), prng.PRNGKey(4)
    chain = benchmarks.Replayed(fn, torch.zeros(2), "cpu", k0, extra=True)
    np.testing.assert_array_equal(chain.step().numpy(), np.asarray(k0))
    np.testing.assert_array_equal(chain.step(k1).numpy(), np.asarray(k1))
    np.testing.assert_array_equal(chain.current().numpy(), np.full(2, 2.0, np.float32))


def test_replayed_is_freed_without_the_cyclic_collector():
    """A dropped `benchmarks.Replayed` holds no reference cycle, so it is
    freed at once: a cycle would keep its program's graph, pinned words and
    events until a collection, which may fall inside a later capture."""
    import gc
    import weakref

    from monocular_slam_tpu_torch.utils import prng

    was = gc.isenabled()
    gc.disable()
    try:
        for key, extra in ((None, False), (prng.PRNGKey(3), True)):
            fn = ((lambda x, k: (x + 1.0, x)) if extra else (lambda x: x * 2.0))
            chain = benchmarks.Replayed(fn, torch.ones(2), "cpu", key, extra=extra)
            chain.step()
            ref = weakref.ref(chain)
            del chain
            assert ref() is None
    finally:
        if was:
            gc.enable()


@pytest.mark.parametrize("enabled", [True, False])
def test_gc_paused_restores_the_collector(enabled):
    """`graph.gc_paused` turns the cyclic collector off inside its block
    (where `graph.Program` captures) and leaves it as it found it, also
    when the block raises."""
    import gc

    from monocular_slam_tpu_torch.utils import graph

    was = gc.isenabled()
    try:
        gc.enable() if enabled else gc.disable()
        with graph.gc_paused():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
        with pytest.raises(ValueError), graph.gc_paused():
            raise ValueError("inside")
        assert gc.isenabled() == enabled
    finally:
        gc.enable() if was else gc.disable()
