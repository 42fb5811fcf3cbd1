"""K1, K2 and the sessions on an NVIDIA GPU. Marked `cuda`: each test skips
on a machine without a card (`chip_smoke.py` runs the same checks at the
benchmark's full size on the card)."""

import numpy as np
import pytest
import torch

from monocular_slam_tpu_torch.ops import fast_score, features, pyramid

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from monocular_slam_tpu_torch.utils.device import apply_precision_policy

    apply_precision_policy()
    return torch.device("cuda")


def _image(dev, h, w, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    img = 40.0 * torch.rand((h, w), generator=g, device=dev)
    img[h // 5 : h // 5 + 20, w // 5 : w // 5 + 20] += 120.0
    return img


@pytest.mark.parametrize("hw", [(480, 640), (400, 533), (231, 309), (134, 179), (101, 173), (7, 5)])
def test_k1_matches_plain(cuda, hw):
    img = _image(cuda, *hw)
    before = fast_score.LAUNCHES
    nms_k, raw_k = fast_score.corner_maps(img, 20.0)
    torch.cuda.synchronize()
    assert fast_score.LAUNCHES == before + 1
    nms_p, raw_p = fast_score.corner_maps_plain(img, 20.0)
    torch.testing.assert_close(nms_k, nms_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(raw_k[3:-3, 3:-3], raw_p[3:-3, 3:-3], rtol=0, atol=1e-5)


def test_k1_all_levels_one_launch(cuda):
    """The 8 levels of a 640x480 frame in one launch, each level's maps as
    the plain version's; the one-level call on an odd shape."""
    levels = [x.contiguous() for x in pyramid.build_pyramid(_image(cuda, 480, 640, seed=5))]
    before = fast_score.LAUNCHES
    maps = fast_score.corner_maps_levels(levels, 20.0)
    torch.cuda.synchronize()
    assert fast_score.LAUNCHES == before + 1
    for img, (nms_k, raw_k), (nms_p, raw_p) in zip(
            levels, maps, fast_score.corner_maps_levels_plain(levels, 20.0)):
        assert nms_k.shape == img.shape
        torch.testing.assert_close(nms_k, nms_p, rtol=0, atol=1e-5)
        torch.testing.assert_close(raw_k[3:-3, 3:-3], raw_p[3:-3, 3:-3], rtol=0, atol=1e-5)
    odd = _image(cuda, 101, 173, seed=6)
    nms_k, raw_k = fast_score.corner_maps(odd, 20.0)
    nms_p, raw_p = fast_score.corner_maps_plain(odd, 20.0)
    assert fast_score.LAUNCHES == before + 2
    torch.testing.assert_close(nms_k, nms_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(raw_k[3:-3, 3:-3], raw_p[3:-3, 3:-3], rtol=0, atol=1e-5)


def test_k1_rejects_bad_input(cuda):
    with pytest.raises(ValueError):
        fast_score.corner_maps(torch.zeros(8, 8, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        fast_score.corner_maps(torch.zeros(8, 16, device=cuda).T)
    with pytest.raises(ValueError):
        fast_score.corner_maps(torch.zeros(2, 8, 8, device=cuda))


def test_extract_kernel_equals_plain(cuda):
    img = pyramid.resize_bilinear(_image(cuda, 480, 640, seed=3), (240, 320))
    fk = features.extract(img, n_features=500)
    fp = features.extract(img, n_features=500,
                          levels_maps_fn=fast_score.corner_maps_levels_plain)
    for a, b in zip(fk, fp):
        assert torch.equal(a, b)


def test_session_on_cuda(cuda):
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.eval import ate
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.session import SlamSession

    imgs, gt, k = render.render_sequence(seed=3, n_frames=12, wh=(320, 240), device=cuda)
    cfg = SlamConfig(max_frames=16, max_points=4000, image_wh=(320, 240),
                     frontend=FrontendConfig(n_features=600))
    sess = SlamSession(cfg, seed=0, device=cuda)
    before = fast_score.LAUNCHES
    for i in range(12):
        sess.add_frame(imgs[i], k, i / 30.0)
    assert fast_score.LAUNCHES - before == 12  # one K1 launch per frame, all levels
    poses, valid, _ = sess.trajectory()
    assert valid.sum() >= 10 and np.isfinite(poses).all()
    assert ate.ate(poses[valid], gt[valid]).rmse < 0.04


# --- K2 -------------------------------------------------------------------------


def _pm1(dev, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 2, (n, 256), generator=g, device=dev, dtype=torch.int8) * 2 - 1


@pytest.mark.parametrize("case", ["odd", "ties", "all_invalid", "single_valid", "one_query"])
def test_k2_matches_plain(cuda, case):
    from monocular_slam_tpu_torch.ops import hamming

    if case == "odd":
        a, b = _pm1(cuda, 97, 1), _pm1(cuda, 1235, 2)
        bv = torch.rand(1235, device=cuda) > 0.2
    elif case == "ties":
        a = _pm1(cuda, 300, 3)
        b = torch.cat([_pm1(cuda, 200, 4), a, a, a[:50]]).contiguous()
        bv = torch.ones(b.shape[0], dtype=torch.bool, device=cuda)
        bv[250] = False
    elif case == "all_invalid":
        a, b = _pm1(cuda, 33, 5), _pm1(cuda, 129, 6)
        bv = torch.zeros(129, dtype=torch.bool, device=cuda)
    elif case == "single_valid":
        a, b = _pm1(cuda, 40, 7), _pm1(cuda, 300, 8)
        bv = torch.zeros(300, dtype=torch.bool, device=cuda)
        bv[257] = True
    else:
        a, b = _pm1(cuda, 1, 9), _pm1(cuda, 5000, 10)
        bv = torch.ones(5000, dtype=torch.bool, device=cuda)
    before = hamming.LAUNCHES
    k = hamming.hamming_top2(a, b, bv)
    torch.cuda.synchronize()
    assert hamming.LAUNCHES == before + 1
    p = hamming.hamming_top2_plain(a, b, bv)
    for x, y in zip(k, p):
        assert x.dtype == torch.int32 and torch.equal(x, y)
    if case == "all_invalid":
        assert (k[0] == hamming.BIG).all() and (k[2] == 0).all()
    if case == "single_valid":
        assert (k[2] == 257).all() and (k[1] == hamming.BIG).all()


@pytest.mark.parametrize("case", ["batched", "split_ties", "one_query_batched", "small_db"])
def test_k2_batched_split_matches_plain(cuda, case):
    """A batch of databases, ties either side of a split boundary, N = 1
    and a database shorter than one 128-row tile: equal to the plain
    version in d1, d2 and idx."""
    from monocular_slam_tpu_torch.ops import hamming

    if case == "batched":
        a = _pm1(cuda, 1000, 20)
        b = torch.stack([_pm1(cuda, 1000, 21 + w) for w in range(5)])
        b[2, 500:700] = a[:200]
        bv = torch.rand(5, 1000, device=cuda) > 0.1
        bv[4] = False
    elif case == "split_ties":
        a = _pm1(cuda, 64, 30)
        b = _pm1(cuda, 256, 31)
        b[127] = a[0]
        b[128] = a[0]
        b[120:127] = a[1:8]
        b[129:136] = a[1:8]
        bv = torch.ones(256, dtype=torch.bool, device=cuda)
        assert hamming.splits(64, 256, 1, torch.cuda.get_device_properties(cuda).multi_processor_count) == 2
    elif case == "one_query_batched":
        a = _pm1(cuda, 1, 40)
        b = torch.stack([_pm1(cuda, 3000, 41), _pm1(cuda, 3000, 42)])
        b[1, 2999] = a[0]
        bv = torch.rand(2, 3000, device=cuda) > 0.3
        bv[1, 2999] = True
    else:
        a = _pm1(cuda, 70, 50)
        b = _pm1(cuda, 37, 51)
        b[36] = a[3]
        bv = torch.rand(37, device=cuda) > 0.2
        bv[36] = True
    before = hamming.LAUNCHES
    k = hamming.hamming_top2(a, b.contiguous(), bv)
    torch.cuda.synchronize()
    assert hamming.LAUNCHES == before + 1
    p = hamming.hamming_top2_plain(a, b, bv)
    for x, y in zip(k, p):
        assert x.dtype == torch.int32 and x.shape == y.shape and torch.equal(x, y)
    if case == "split_ties":
        assert int(k[2][0]) == 127 and int(k[0][0]) == int(k[1][0]) == 0
        assert torch.equal(k[2][1:8], torch.arange(120, 127, dtype=torch.int32, device=cuda))


def test_k2_rejects_bad_input(cuda):
    from monocular_slam_tpu_torch.ops import hamming

    a = _pm1(cuda, 8, 0)
    bv = torch.ones(8, dtype=torch.bool, device=cuda)
    bad = [
        (a.float(), a, bv), (a, a[:, :128].contiguous(), bv), (a, a, bv.int()),
        (a.t().contiguous().t(), a, bv), (a.cpu(), a, bv), (a, a, bv[:4]),
        (a[:, 1:].contiguous(), a[:, 1:].contiguous(), bv),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            hamming.hamming_top2_cuda(*args)


def test_k2_match_route(cuda):
    from monocular_slam_tpu_torch.ops import hamming, matching

    a = _pm1(cuda, 500, 11)
    b = torch.cat([a[:400], _pm1(cuda, 100, 12)])
    b = torch.where(torch.rand(b.shape, device=cuda) < 0.05, -b, b).contiguous()
    av = torch.rand(500, device=cuda) > 0.1
    bv = torch.rand(500, device=cuda) > 0.1
    before = hamming.LAUNCHES
    mk = matching.match(a, b, av, bv, use_kernel=True)
    assert hamming.LAUNCHES == before + 2  # forward pass and the cross-check pass
    md = matching.match(a, b, av, bv, use_kernel=False)
    assert hamming.LAUNCHES == before + 2
    assert torch.equal(mk.ok, md.ok) and int(mk.n_matches) > 300
    assert torch.equal(mk.idx[mk.ok], md.idx[md.ok])
    # the default route takes K2 for a single database of >= 4096 rows
    big = _pm1(cuda, matching.PALLAS_MIN_DB, 13)
    matching.match(a, big, av, torch.ones(big.shape[0], dtype=torch.bool, device=cuda))
    assert hamming.LAUNCHES == before + 4


def test_window_route_equals_dense_on_session_state(cuda):
    """The tracker's back-traverse window on a real session state: K2 (two
    launches) and the dense route give the same `Matches` on every row."""
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.ops import hamming
    from monocular_slam_tpu_torch.slam import tracker
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.session import SlamSession

    imgs, _, k = render.render_sequence(seed=3, n_frames=9, wh=(320, 240), device=cuda)
    cfg = SlamConfig(max_frames=16, max_points=4000, image_wh=(320, 240),
                     frontend=FrontendConfig(n_features=600))
    sess = SlamSession(cfg, seed=0, device=cuda)
    for i in range(9):
        sess.add_frame(imgs[i], k, i / 30.0)
    before = hamming.LAUNCHES
    _, _, mk = tracker._window_matches(sess.state, 8, cfg, use_kernel=True)
    assert hamming.LAUNCHES == before + 2
    _, _, md = tracker._window_matches(sess.state, 8, cfg, use_kernel=False)
    for f in ("idx", "dist", "ok", "n_matches"):
        assert torch.equal(getattr(mk, f), getattr(md, f)), f
    assert int(mk.n_matches.max()) > 50


def test_loop_closer_session_on_cuda(cuda):
    """A 320x240 loop-closing session on the card: detection every frame,
    relocalization through K2 after a blackout, finite poses."""
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.ops import hamming
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser, LoopClosureConfig
    from monocular_slam_tpu_torch.slam.session import SlamSession

    imgs, gt, k = render.render_sequence(seed=3, n_frames=20, wh=(320, 240), device=cuda)
    cfg = SlamConfig(max_frames=32, max_points=4000, image_wh=(320, 240),
                     frontend=FrontendConfig(n_features=600))
    lc = LoopCloser(vocabulary.load_default(), cfg, LoopClosureConfig(min_gap=5))
    sess = SlamSession(cfg, seed=0, loop_closer=lc)
    # longer than reloc_after + stat_lag, so the newest frame is still noise
    # when the failure streak is read
    noise = 255.0 * torch.rand((8, 240, 320), device=cuda)
    frames = torch.cat([imgs[:12], torch.floor(noise), imgs[12:]])
    hamming.LAUNCHES = 0
    for i in range(frames.shape[0]):
        sess.add_frame(frames[i], k, i / 30.0)
    poses, valid, _ = sess.trajectory()
    assert sess.reloc_attempts >= 1 and hamming.LAUNCHES >= 2
    assert np.isfinite(poses).all() and valid[:12].all()
    assert lc._db.abs().sum() > 0


def test_cg_solvers_on_cuda_match_cpu(cuda):
    """`cg_ba.bundle_adjust_cg` and `pose_graph.optimize_cg` on the card
    against the same float32 solves on the CPU (the card's segment sums are
    float atomics, so the last bits differ)."""
    from monocular_slam_tpu_torch.geometry import se3, sim3
    from monocular_slam_tpu_torch.optim import ba, cg_ba, pose_graph

    rng = np.random.RandomState(0)
    F, P = 8, 200
    X = rng.uniform(-2, 2, (P, 3)) + [0, 0, 6.0]
    xi = np.concatenate([np.zeros((F, 3)), np.stack([-0.3 * np.arange(F), 0.02 * np.arange(F),
                                                     0.05 * np.arange(F)], 1)], 1)
    xi[:, 4] += 0.12 * np.arange(F)
    poses = se3.exp(torch.as_tensor(xi, dtype=torch.float32)).numpy()
    cam, pt = np.repeat(np.arange(F), P), np.tile(np.arange(P), F)
    Xc = np.einsum("eij,ej->ei", poses[cam, :, :3], X[pt]) + poses[cam, :, 3]
    k = np.array([517.3, 516.5, 318.6, 255.3])
    uv = k[:2] * Xc[:, :2] / Xc[:, 2:] + k[2:] + 0.4 * rng.randn(F * P, 2)
    p0 = se3.compose(se3.exp(torch.as_tensor(0.02 * rng.randn(F, 6), dtype=torch.float32)),
                     torch.as_tensor(poses)).numpy()
    p0[:2] = poses[:2]
    fixed = np.arange(F) < 2
    args = [p0, X + 0.05 * rng.randn(P, 3), np.tile(k, (F, 1)), cam, pt, uv, np.ones(F * P),
            rng.rand(F * P) < 0.6, fixed]

    def prob(dev):
        return ba.BAProblem(*[torch.as_tensor(a if a.dtype.kind in "bi" else a.astype(np.float32),
                                              device=dev) for a in map(np.asarray, args)])

    rc = cg_ba.bundle_adjust_cg(prob("cpu"), n_iters=8, max_cg_iters=50)
    rg = cg_ba.bundle_adjust_cg(prob(cuda), n_iters=8, max_cg_iters=50)
    torch.testing.assert_close(rg.chi2_history.cpu(), rc.chi2_history, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(rg.poses.cpu(), rc.poses, rtol=0, atol=1e-4)
    assert float(rc.chi2_history[-1]) < 0.2 * float(rc.chi2_initial)

    n = 40
    step = np.concatenate([0.02 * rng.randn(n, 6), np.full((n, 1), 0.005)], 1)
    truth = sim3.exp(torch.as_tensor(np.cumsum(rng.randn(n, 7) * [0.05] * 6 + [0.0], 0),
                                     dtype=torch.float32))
    est = sim3.compose(sim3.exp(torch.as_tensor(np.cumsum(step, 0), dtype=torch.float32)), truth)
    meas = sim3.compose(truth[n - 1], sim3.inverse(truth[0]))[None]
    res = {}
    for dev in ("cpu", cuda):
        g = pose_graph.sequential_graph(est.to(dev), torch.ones(n, dtype=torch.bool, device=dev),
                                        [n - 1], [0], meas.to(dev), loop_weight=20.0)
        res[str(dev)] = pose_graph.optimize_cg(g, n_iters=10, huber_delta=1.0)
    rc, rg = res["cpu"], res[str(cuda)]
    assert int(rg.n_iters_run) == int(rc.n_iters_run)
    torch.testing.assert_close(rg.vertices.cpu(), rc.vertices, rtol=0, atol=1e-4)
    assert float(rc.chi2_history[-1]) < 0.2 * float(rc.chi2_initial)


def test_prewarm_and_buffer_on_cuda(cuda):
    """`prewarm` on the card builds K1 and K2 and launches K1 once per
    steering mode; frames from a uint8 buffer on the card track."""
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser
    from monocular_slam_tpu_torch.slam.session import SlamSession

    imgs, _, k = render.render_sequence(seed=3, n_frames=8, wh=(320, 240), device=cuda)
    cfg = SlamConfig(max_frames=16, max_points=4000, image_wh=(320, 240),
                     frontend=FrontendConfig(n_features=600))
    sess = SlamSession(cfg, seed=0, loop_closer=LoopCloser(vocabulary.load_default(), cfg))
    before = fast_score.LAUNCHES
    assert sess.prewarm(image=True) > 0
    assert fast_score.LAUNCHES == before + 2  # "auto" steering: both modes
    buf = imgs.to(torch.uint8)
    for i in range(8):
        sess.add_frame_from_buffer(buf, i, k, i / 30.0)
    poses, valid, _ = sess.trajectory()
    assert valid.sum() >= 7 and np.isfinite(poses).all()


def test_cli_on_cuda(cuda, tmp_path):
    """The CLI on the card: a 12-frame 320x240 course exported by the port,
    decoded natively, one K1 launch per frame and two K2 launches in every
    track call; the files it writes read back."""
    import contextlib
    import io
    import json

    from monocular_slam_tpu_torch import run
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.io import ply, trajectory

    root = render.export_tum(str(tmp_path / "course"), seed=3, n_frames=12, wh=(320, 240),
                             device=cuda)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run.main(["--dataset", root, "--end", "12", "--step", "1", "--features", "600",
                         "--max-frames", "16", "--max-points", "4000", "--out",
                         str(tmp_path / "out"), "--verbose"]) == 0
    lines = buf.getvalue().strip().splitlines()
    summary = json.loads(lines[-1])
    counts = json.loads(next(x for x in lines if x.startswith("[run] kernel launches"))
                        .split("launches ", 1)[1])
    assert summary["device"].startswith("cuda") and summary["tracked"] >= 10
    assert summary["ate_rmse"] < 0.04
    assert counts["fast_corner_maps_levels"] == 12 and counts["k2_per_track_min"] >= 2
    ts, poses = trajectory.read_tum(str(tmp_path / "out" / "trajectory.txt"))
    assert len(ts) == summary["tracked"] and np.isfinite(poses).all()
    assert ply.read_ply_points(str(tmp_path / "out" / "map.ply")).shape[0] == summary["map_points"]


# --- deterministic sums and the distributed solvers on the card ------------------------

def _cg_problem(dev, F=64, P=20000, obs=1500, seed=5):
    """A seeded float32 BA problem: F cameras on an arc, obs random points
    each (duplicate camera-point pairs included), 0.5 px noise."""
    from monocular_slam_tpu_torch.geometry import se3, so3
    from monocular_slam_tpu_torch.optim import ba

    rng = np.random.RandomState(seed)
    X = rng.uniform(-3, 3, (P, 3)) + [0.0, 0.0, 12.0]
    rot = torch.as_tensor([[0.0, 0.01 * i, 0.0] for i in range(F)], dtype=torch.float64)
    poses = se3.from_Rt(so3.exp(rot), torch.as_tensor([[-0.1 * i, 0.0, 0.0] for i in range(F)],
                                                      dtype=torch.float64))
    cam = np.repeat(np.arange(F), obs)
    pt = rng.randint(0, P, F * obs)
    Xc = se3.apply(poses[torch.as_tensor(cam)], torch.as_tensor(X[pt])).numpy()
    k = np.array([500.0, 500.0, 320.0, 240.0])
    uv = k[:2] * Xc[:, :2] / Xc[:, 2:] + k[2:] + 0.5 * rng.randn(F * obs, 2)
    fixed = np.zeros(F, bool)
    fixed[:2] = True
    p0 = se3.compose(se3.exp(torch.as_tensor(0.003 * rng.randn(F, 6))), poses)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return ba.BAProblem(f32(p0), f32(X + 0.05 * rng.randn(P, 3)), f32(np.tile(k, (F, 1))),
                        torch.as_tensor(cam, device=dev), torch.as_tensor(pt, device=dev), f32(uv),
                        torch.ones(F * obs, device=dev), torch.ones(F * obs, dtype=torch.bool, device=dev),
                        torch.as_tensor(fixed, device=dev))


def _drifted_graph(dev, n=2000, seed=6):
    from monocular_slam_tpu_torch.geometry import sim3, so3
    from monocular_slam_tpu_torch.optim import pose_graph

    ang = np.arange(n) * (2 * np.pi / (n / 2))
    verts = sim3.pack(so3.exp(torch.as_tensor(np.stack([0 * ang, ang, 0 * ang], -1), dtype=torch.float32)),
                      torch.as_tensor(np.stack([np.sin(ang) * 20, 0 * ang, np.cos(ang) * 20], -1),
                                      dtype=torch.float32), torch.ones(n)).to(dev)
    step = 0.01 * np.random.RandomState(seed).randn(n, 7)
    step[0] = 0.0
    est = sim3.compose(sim3.exp(torch.as_tensor(np.cumsum(step, 0), dtype=torch.float32, device=dev)),
                       verts)
    li = np.arange(n // 2, n, 20)
    lj = li - n // 2
    meas = sim3.compose(verts[li], sim3.inverse(verts[lj]))
    return pose_graph.sequential_graph(est, torch.ones(n, dtype=torch.bool, device=dev), li, lj, meas)


def test_segment_sum_repeats_on_cuda(cuda):
    """The planned float32 sum over 1.5M values into 1000 segments gives the
    same bits on every call and matches a float64 CPU sum to 1e-5 relative."""
    from monocular_slam_tpu_torch.utils import scatter

    g = torch.Generator(device=cuda).manual_seed(7)
    vals = torch.randn((1_500_000, 6), generator=g, device=cuda)
    seg = torch.randint(0, 1000, (1_500_000,), generator=g, device=cuda)
    plan = scatter.segments(seg, 1000)
    first = scatter.segment_sum(vals, plan)
    for _ in range(3):
        assert torch.equal(scatter.segment_sum(vals, plan), first)
    ref = torch.zeros((1000, 6), dtype=torch.float64).index_add_(0, seg.cpu(), vals.double().cpu())
    torch.testing.assert_close(first.double().cpu(), ref, rtol=1e-5, atol=1e-3)


def test_cg_solvers_repeat_bit_for_bit_on_cuda(cuda):
    """Two runs of one CG BA (96,000 edges) and of one CG pose graph (2000
    keyframes) on the card give the same bits."""
    from monocular_slam_tpu_torch.optim import cg_ba, pose_graph

    prob = _cg_problem(cuda)
    a, b = (cg_ba.bundle_adjust_cg(prob, n_iters=5, max_cg_iters=100) for _ in range(2))
    assert torch.equal(a.poses, b.poses) and torch.equal(a.points, b.points)
    assert torch.equal(a.chi2_history, b.chi2_history)
    g = _drifted_graph(cuda)
    a, b = (pose_graph.optimize_cg(g, n_iters=5, max_cg_iters=200) for _ in range(2))
    assert torch.equal(a.vertices, b.vertices) and float(a.chi2_history[-1]) < float(a.chi2_initial)


def test_loop_session_repeats_bit_for_bit_on_cuda(cuda):
    """A short loop-closing session (24 frames, global BA forced onto the
    CG route) run twice: the same trajectory, bit for bit."""
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser
    from monocular_slam_tpu_torch.slam.session import SlamSession

    imgs, _, k = render.render_sequence(seed=3, n_frames=24, wh=(320, 240), device=cuda)
    cfg = SlamConfig(max_frames=32, max_points=4000, image_wh=(320, 240),
                     frontend=FrontendConfig(n_features=600))
    voc = vocabulary.load_default()
    runs = []
    for _ in range(2):
        lc = LoopCloser(voc, cfg)
        sess = SlamSession(cfg, seed=0, loop_closer=lc)
        for i in range(24):
            sess.add_frame(imgs[i], k, i / 30.0)
        sess.flush()
        st = sess.state
        kfs = [f for f in sess._keyframes if bool(st.pose_valid[f])]
        pad = torch.zeros(st.poses.shape[0], dtype=torch.long, device=cuda)
        pad[: len(kfs)] = torch.as_tensor(kfs, device=cuda)
        with torch.inference_mode():
            gba = lc._gba_impl(st, pad, len(kfs), lc.global_ba_solver(cg=True))
        runs.append((sess.trajectory()[0], gba.poses.cpu(), gba.points.cpu()))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][2], runs[1][2])


@pytest.fixture(scope="module")
def nccl_world():
    """A one-rank NCCL process group in this process."""
    import socket

    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_nccl_world1_distributed_solvers_match(cuda, nccl_world):
    """At world size 1 through NCCL: the sharded CG BA against
    `bundle_adjust_cg` (chi2 histories to rtol 1e-5, poses to 1e-5), its
    dense route against `ba.bundle_adjust`, the sharded pose graph against
    `optimize_cg`; one (F, 6) all-reduce per PCG step and one for the
    reduced gradient of each LM iteration, counted."""
    import torch.distributed as dist

    from monocular_slam_tpu_torch.optim import ba, cg_ba, pose_graph
    from monocular_slam_tpu_torch.parallel import distributed, sharded_ba, sharded_pose_graph
    from monocular_slam_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1)
    assert dist.get_backend(mesh.get_group("model")) == "nccl"
    prob = _cg_problem(cuda)
    F = prob.poses.shape[0]
    single = cg_ba.bundle_adjust_cg(prob, n_iters=5, max_cg_iters=50)
    with distributed.record_collectives() as rec:
        shard = sharded_ba.distributed_bundle_adjust(prob, mesh, n_iters=5, solver="cg",
                                                     max_cg_iters=50)
    torch.testing.assert_close(shard.chi2_history, single.chi2_history, rtol=1e-5, atol=0)
    torch.testing.assert_close(shard.poses, single.poses, rtol=0, atol=1e-5)
    assert sum(c["elements"] == 6 * F for c in rec) == 5 * (50 + 1)
    small = _cg_problem(cuda, F=16, P=2000, obs=300)
    dense = sharded_ba.distributed_bundle_adjust(small, mesh, n_iters=5, solver="dense")
    ref = ba.bundle_adjust(small, n_iters=5)
    torch.testing.assert_close(dense.chi2_history, ref.chi2_history, rtol=1e-5, atol=0)
    torch.testing.assert_close(dense.poses, ref.poses, rtol=0, atol=1e-5)
    g = _drifted_graph(cuda, n=500)
    a = sharded_pose_graph.distributed_optimize(g, mesh, n_iters=5, max_cg_iters=100)
    b = pose_graph.optimize_cg(g, n_iters=5, max_cg_iters=100)
    torch.testing.assert_close(a.chi2_history, b.chi2_history, rtol=1e-5, atol=0)
    torch.testing.assert_close(a.vertices, b.vertices, rtol=0, atol=1e-5)
