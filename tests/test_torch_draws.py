"""The port's keyed draws against `jax.random` and the JAX functions that
draw, from the same key and with no uniforms injected:

  - `prng.bits_on` / `prng.uniform_on` (torch int64 ops, here on CPU
    tensors) bit for bit with 32-bit `jax.random.bits` / float32
    `jax.random.uniform` (whose scale XLA fuses into one multiply-add) and
    with the numpy `prng.random_bits` / `prng.uniform`;
  - `epipolar._sample_indices`: equal indices at the session's shapes and
    at odd ones, with masks down to fewer valid rows than the sample;
  - the RANSAC entries (`ransac_fundamental`, `solve_pnp_ransac` over its
    options, `ransac_sim3`, `ransac_sim3_reproj`): equal inliers, models
    within the tolerance stated beside each assertion;
  - `tracker.bootstrap`, `track` and `relocalize` from a key.

The JAX side runs with x64 off (`jax.enable_x64(False)`), as the JAX
package runs outside the tests: its default draw is then float32, the draw
the port makes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monocular_slam_tpu.datasets import synthetic
from monocular_slam_tpu.geometry import alignment as jal
from monocular_slam_tpu.geometry import epipolar as jepi
from monocular_slam_tpu.geometry import pnp as jpnp
from monocular_slam_tpu.geometry import sim3 as jsim3
from monocular_slam_tpu.slam import state as jstate
from monocular_slam_tpu.slam import tracker as jtrack
from monocular_slam_tpu.slam.config import FrontendConfig as JFrontend
from monocular_slam_tpu.slam.config import SlamConfig as JConfig
from monocular_slam_tpu_torch.geometry import alignment as tal
from monocular_slam_tpu_torch.geometry import epipolar as tepi
from monocular_slam_tpu_torch.geometry import pnp as tpnp
from monocular_slam_tpu_torch.slam import state as tstate
from monocular_slam_tpu_torch.slam import tracker as ttrack
from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
from monocular_slam_tpu_torch.utils import prng
from port_util import np32, random_poses, t32
from port_util import one_torch_thread  # noqa: F401 (autouse)

K = np.array([517.3, 516.5, 318.6, 255.3], np.float32)
SEEDS = [0, 3, 12345]
# the session's draws at n_features 1000 (PnP, bootstrap, Sim3) and odd ones
DRAW_SHAPES = [(512, 1000), (2000, 1000), (256, 1000), (7, 13), (3, 1)]


def x32(fn, *a, **kw):
    """A JAX call with x64 off; outputs as numpy."""
    with jax.enable_x64(False):
        return jax.tree_util.tree_map(np.asarray, fn(*a, **kw))


# --- the generator -----------------------------------------------------------------

@pytest.mark.parametrize("shape", DRAW_SHAPES + [(), (4, 3, 5)])
def test_uniform_on_bit_exact(shape):
    for seed in SEEDS:
        key = prng.PRNGKey(seed)
        jk = jax.random.PRNGKey(seed)
        for lo, hi in ((0.0, 1.0), (1e-6, 1.0), (-2.0, 3.5)):
            got = prng.uniform_on(key, shape, "cpu", minval=lo, maxval=hi).numpy()
            ref = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
            assert got.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, prng.uniform(key, shape, np.float32, lo, hi))


@pytest.mark.parametrize("shape", [(), (1,), (33,), (3, 5), (512, 100)])
def test_bits_on_bit_exact(shape):
    for seed in SEEDS:
        got = prng.bits_on(prng.PRNGKey(seed), shape, "cpu").numpy()
        ref = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape, dtype="uint32"))
        np.testing.assert_array_equal(got.astype(np.uint32), ref)
        np.testing.assert_array_equal(got.astype(np.uint32), prng.random_bits(prng.PRNGKey(seed),
                                                                              32, shape))


# --- Gumbel-top-k sampling -----------------------------------------------------------

@pytest.mark.parametrize("shape", DRAW_SHAPES)
@pytest.mark.parametrize("n_valid", ["all", "half", 8, 3, 0])
def test_sample_indices_equal(shape, n_valid):
    """Equal indices in every row. With fewer valid entries than the sample
    the masked entries tie at -1e30 and fill the sample in index order on
    both sides. Measured at these shapes: 0 rows differ (the log of XLA and
    torch's may differ in the last bit, but no two drawn uniforms are that
    close)."""
    n_hyp, n = shape
    size = min(8, n)
    rng = np.random.RandomState(n_hyp + n)
    if n_valid == "all":
        mask = np.ones(n, bool)
    elif n_valid == "half":
        mask = rng.rand(n) > 0.5
    else:
        mask = np.zeros(n, bool)
        mask[rng.choice(n, min(n_valid, n), replace=False)] = True
    for seed in SEEDS:
        ref = x32(jepi._sample_indices, jax.random.PRNGKey(seed), n_hyp, size, jnp.asarray(mask))
        got = tepi._sample_indices(prng.PRNGKey(seed), n_hyp, size, torch.as_tensor(mask))
        assert int((np32(got) != ref).any(-1).sum()) == 0


# --- the RANSAC entries ----------------------------------------------------------------

def _two_view_scene(rng, n=200, outliers=0.3, noise=0.4):
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (n, 3))
    T2 = random_poses(rng, 1, rot=0.1, trans=0.4)[0]

    def project(T):
        Xc = X @ T[:, :3].T + T[:, 3]
        return Xc[:, :2] / Xc[:, 2:] * K[:2] + K[2:]

    uv1 = project(np.eye(4)[:3]) + noise * rng.randn(n, 2)
    uv2 = project(T2) + noise * rng.randn(n, 2)
    bad = rng.rand(n) < outliers
    uv2[bad] = rng.uniform(0, 640, (bad.sum(), 2))
    return uv1.astype(np.float32), uv2.astype(np.float32), rng.rand(n) > 0.05


@pytest.mark.parametrize("seed", range(6, 14))
def test_ransac_fundamental_keyed(seed):
    """Same draws (the indices above), then float32 numerics on each side:
    the 8-point hypotheses come from 8 steps of inverse iteration on 9x9
    normal matrices, which XLA and torch round differently, so the best raw
    hypothesis' count (`best_score`) differs by up to 3 in 3 of these 8
    seeds. The inlier refit brings them back: equal counts in all 8, equal
    inlier sets in 7 (2 points differ at seed 13, measured); F (unit norm,
    up to sign) within 2e-4 where the sets are equal (measured <= 1.1e-4,
    the refit's 9x9 `eigh`)."""
    uv1, uv2, mask = _two_view_scene(np.random.RandomState(seed))
    rj = x32(jepi.ransac_fundamental, jax.random.PRNGKey(seed), jnp.asarray(uv1), jnp.asarray(uv2),
             jnp.asarray(mask), n_iters=300)
    rt = tepi.ransac_fundamental(prng.PRNGKey(seed), t32(uv1), t32(uv2), torch.as_tensor(mask),
                                 n_iters=300)
    assert int(rt.num_inliers) == int(rj.num_inliers) > 100
    n_diff = int((np32(rt.inliers) != rj.inliers).sum())
    assert n_diff <= 2
    if n_diff == 0:
        s = np.sign(np.sum(rj.F * np32(rt.F)))
        np.testing.assert_allclose(np32(rt.F) * s, rj.F, atol=2e-4)


def _pnp_scene(rng, n=300):
    X = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (n, 3)).astype(np.float32)
    T = random_poses(rng, 1, rot=0.2, trans=0.3)[0]
    Xc = X @ T[:, :3].T + T[:, 3]
    uv = Xc[:, :2] / Xc[:, 2:] * K[:2] + K[2:] + 0.5 * rng.randn(n, 2)
    bad = rng.rand(n) < 0.3
    uv[bad] = rng.uniform(0, 640, (bad.sum(), 2))
    T_near = T.copy()
    T_near[:, 3] += 0.05
    return X, uv.astype(np.float32), rng.rand(n) > 0.05, {"exact": T, "near": T_near, None: None}


@pytest.mark.parametrize("seed", [8, 11, 13])
@pytest.mark.parametrize("refine,lo_rounds,init,atol", [
    (True, 2, "near", 1e-5), (True, 2, None, 1e-5), (False, 2, "near", 1e-2),
    (True, 1, "exact", 1e-6), (False, 1, "exact", 1e-6), (True, 0, "exact", 1e-6),
    (False, 0, "exact", 1e-6),
])
def test_solve_pnp_ransac_keyed(seed, refine, lo_rounds, init, atol):
    """Equal inliers, counts and `ok` for every option. With two LO rounds
    (the tracker's setting) the refits settle on one consensus whatever
    the hypotheses' rounding; the pose agrees to 1e-5 after the GN polish
    (measured <= 1.8e-6) and to 1e-2 without it (measured <= 5.7e-3: the
    LO refit's 12x12 float32 `eigh`, ROADMAP Queue 3). With one LO round
    or none, the winner among the minimal hypotheses depends on their
    float32 rounding (up to 61 of 300 inliers differ at seed 13 with a
    near initial pose), so those options are held with the exact pose as
    `T_init`, which wins the pool on both sides."""
    X, uv, mask, inits = _pnp_scene(np.random.RandomState(seed))
    T_init = inits[init]
    kw = dict(n_iters=256, refine=refine, lo_rounds=lo_rounds)
    rj = x32(jpnp.solve_pnp_ransac, jax.random.PRNGKey(seed), jnp.asarray(X), jnp.asarray(uv),
             jnp.asarray(K), jnp.asarray(mask),
             T_init=None if T_init is None else jnp.asarray(T_init), **kw)
    rt = tpnp.solve_pnp_ransac(prng.PRNGKey(seed), t32(X), t32(uv), t32(K), torch.as_tensor(mask),
                               T_init=None if T_init is None else t32(T_init), **kw)
    np.testing.assert_array_equal(np32(rt.inliers), rj.inliers)
    assert int(rt.n_inliers) == int(rj.n_inliers) > 150 and bool(rt.ok) == bool(rj.ok)
    np.testing.assert_allclose(np32(rt.T), rj.T, atol=atol)


def _sim3_scene(rng, n=300, outliers=0.25):
    T_y = random_poses(rng, 1, rot=0.1, trans=0.3)[0]
    Yc = rng.uniform([-2, -1.5, 3], [2, 1.5, 7], (n, 3)).astype(np.float32)
    Y = (Yc - T_y[:, 3]) @ T_y[:, :3]
    S = jsim3.exp(jnp.asarray([0.05, -0.03, 0.08, 0.2, -0.1, 0.15, 0.1], jnp.float32))
    R, t, s = (np.asarray(a, np.float64) for a in jsim3.unpack(S))
    X = ((Y - t) @ R) / s
    T_x = np.concatenate([T_y[:, :3] @ R, ((T_y[:, :3] @ t + T_y[:, 3]) / s)[:, None]], 1)

    def project(T, P):
        Pc = P @ T[:, :3].T + T[:, 3]
        return Pc[:, :2] / Pc[:, 2:] * K[:2] + K[2:] + 0.5 * rng.randn(n, 2)

    uv_y, uv_x = project(T_y, Y), project(T_x, X)
    bad = rng.rand(n) < outliers
    X[bad] += rng.randn(bad.sum(), 3)
    mask = rng.rand(n) > 0.05
    return [a.astype(np.float32) for a in (X, Y, uv_x, uv_y, T_x, T_y)] + [mask]


@pytest.mark.parametrize("seed", range(2, 8))
def test_ransac_sim3_keyed(seed):
    """Euclidean gate: equal inliers, S within 1e-5 (measured <= 2.4e-6)."""
    X, Y, *_, mask = _sim3_scene(np.random.RandomState(seed))
    rj = x32(jal.ransac_sim3, jax.random.PRNGKey(seed), jnp.asarray(X), jnp.asarray(Y),
             jnp.asarray(mask), n_iters=128, thresh=0.05)
    rt = tal.ransac_sim3(prng.PRNGKey(seed), t32(X), t32(Y), torch.as_tensor(mask), n_iters=128,
                         thresh=0.05)
    np.testing.assert_array_equal(np32(rt.inliers), rj.inliers)
    assert int(rt.n_inliers) == int(rj.n_inliers) > 150
    np.testing.assert_allclose(np32(rt.S), rj.S, atol=1e-5)


@pytest.mark.parametrize("seed", range(2, 8))
def test_ransac_sim3_reproj_keyed(seed):
    """Reprojection gate: equal inliers and counts. S itself is held by its
    fit: the mean dual reprojection error over the inliers within 2e-3 px
    of the reference's S (measured <= 3.8e-4 px). The annealed GN polish on float32 `jacfwd`
    Jacobians keeps or drops its last stage on a count compare, so the two
    S can sit far apart along the scene's weak directions with the same
    inliers (up to 0.49 at seed 5, measured)."""
    X, Y, uv_x, uv_y, T_x, T_y, mask = _sim3_scene(np.random.RandomState(seed))
    geo = (X, Y, mask, uv_x, uv_y, K, K, T_x, T_y)
    kw = dict(n_iters=128, px_thresh=10.0, min_inliers=15)
    rj = x32(jax.jit(lambda key, *a: jal.ransac_sim3_reproj(key, *a, **kw)),
             jax.random.PRNGKey(seed), *[jnp.asarray(a) for a in geo])
    rt = tal.ransac_sim3_reproj(prng.PRNGKey(seed), *[torch.as_tensor(a) for a in geo], **kw)
    np.testing.assert_array_equal(np32(rt.inliers), rj.inliers)
    assert int(rt.n_inliers) == int(rj.n_inliers) > 150 and bool(rt.ok)
    inl = rt.inliers
    g = [torch.as_tensor(a) for a in (X, Y, uv_x, uv_y, K, K, T_x, T_y)]

    def mean_err(S):
        ex, ey, _ = tal._dual_reproj_err(S, *g)
        return float((ex[inl].mean() + ey[inl].mean()) / 2)

    assert abs(mean_err(rt.S) - mean_err(torch.as_tensor(rj.S))) < 2e-3


# --- the tracker's steps from a key --------------------------------------------------------

N_FEAT = 256


@pytest.fixture(scope="module")
def steps():
    """A synthetic feature course (x64 off), frames 0-3 ingested; the
    reference's bootstrap of (0, 1), its track of frame 2 on that, and a
    relocalization of frame 3 against frame 2 after its track. Returns
    both packages' configs, the keys and each step's input and output."""
    with jax.enable_x64(False):
        seq = synthetic.feature_sequence(jax.random.PRNGKey(4), n_frames=4, n_world_points=800,
                                         n_features=N_FEAT, pix_noise=0.3, drop_prob=0.05)
        kw = dict(max_frames=8, max_points=3000)
        jcfg = JConfig(frontend=JFrontend(n_features=N_FEAT), **kw)
        st = jstate.empty_state(jcfg)
        for i, f in enumerate(seq.frames):
            st = jstate.add_frame_features(st, i, i, f.uv, f.scale, f.valid, f.desc, f.desc_pm1,
                                           jnp.asarray(seq.k, jnp.float32))
        keys = [jax.random.PRNGKey(s) for s in (21, 22, 23)]
        out = {"pre_boot": {n: np.array(v) for n, v in st._asdict().items()}}
        boot = jtrack.bootstrap(st, keys[0], jcfg, 0, 1)
        out["boot"] = boot
        out["pre_track"] = {n: np.array(v) for n, v in boot.state._asdict().items()}
        tr = jtrack.track(boot.state, 2, keys[1], jcfg)
        out["track"] = tr
        lost = tr.state._replace(pose_valid=tr.state.pose_valid.at[3].set(False))
        out["pre_reloc"] = {n: np.array(v) for n, v in lost._asdict().items()}
        out["reloc"] = jtrack.relocalize(lost, 3, 2, keys[2], jcfg)
        out = jax.tree_util.tree_map(np.asarray, out)
    out["keys"] = [np.asarray(k) for k in keys]
    out["tcfg"] = SlamConfig(frontend=FrontendConfig(n_features=N_FEAT), **kw)
    return out


def _assert_state(got_state, ref_state, pose_atol, point_atol):
    """Integer and bool fields exactly, poses and points within the given
    tolerances, every other float field within 1e-6."""
    got = tstate.state_to_numpy(got_state)
    for n, v in ref_state._asdict().items():
        if n in ("poses", "points"):
            atol = pose_atol if n == "poses" else point_atol
            np.testing.assert_allclose(got[n], v, rtol=0, atol=atol, err_msg=n)
        elif v.dtype.kind == "f":
            np.testing.assert_allclose(got[n], v, rtol=0, atol=1e-6, err_msg=n)
        else:
            np.testing.assert_array_equal(got[n], v.astype(got[n].dtype), err_msg=n)


def test_bootstrap_keyed(steps):
    """Equal outcome, RANSAC inliers, new points and associations; poses
    within 1e-4 and points within 5e-3 (measured 1.7e-5 and 8.7e-4: the
    8-point refit's `eigh` and the two-view BA's free scale)."""
    rj = steps["boot"]
    rt = ttrack.bootstrap(tstate.state_from_numpy(steps["pre_boot"]), steps["keys"][0],
                          steps["tcfg"], 0, 1)
    assert bool(rt.ok) == bool(rj.ok) is True
    assert int(rt.n_inliers) == int(rj.n_inliers) and int(rt.n_points) == int(rj.n_points) > 100
    _assert_state(rt.state, rj.state, pose_atol=1e-4, point_atol=5e-3)


def test_track_keyed(steps):
    """Equal outcome, PnP inliers, new points and every association; the
    pose within 1e-4 (measured 2.1e-5), the new points within 3e-2
    (measured 7.1e-3: triangulated from poses that far apart)."""
    rj = steps["track"]
    rt = ttrack.track(tstate.state_from_numpy(steps["pre_track"]), 2, steps["keys"][1],
                      steps["tcfg"])
    assert bool(rt.ok) == bool(rj.ok) is True
    assert int(rt.n_pnp_inliers) == int(rj.n_pnp_inliers) > 50
    assert int(rt.n_new_points) == int(rj.n_new_points)
    _assert_state(rt.state, rj.state, pose_atol=1e-4, point_atol=3e-2)


def test_relocalize_keyed(steps):
    """Equal outcome, inliers and associations; the pose within 1e-3
    (measured 3.4e-4: the LO refit's `eigh`); points untouched."""
    rj = steps["reloc"]
    rt = ttrack.relocalize(tstate.state_from_numpy(steps["pre_reloc"]), 3, 2, steps["keys"][2],
                           steps["tcfg"])
    assert bool(rt.ok) == bool(rj.ok) is True
    assert int(rt.n_inliers) == int(rj.n_inliers) >= steps["tcfg"].track.reloc_min_inliers
    _assert_state(rt.state, rj.state, pose_atol=1e-3, point_atol=0.0)
