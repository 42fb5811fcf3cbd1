"""K1, K2 and the sessions on an NVIDIA GPU. Marked `cuda`: each test skips
on a machine without a card (`chip_smoke.py` runs the same checks at the
benchmark's full size on the card)."""

import numpy as np
import pytest
import torch

from monocular_slam_tpu_torch.ops import fast_score, features, launches, pyramid

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
    before = launches.count("corner_maps")
    nms_k, raw_k = fast_score.corner_maps(img, 20.0)
    torch.cuda.synchronize()
    assert launches.count("corner_maps") == before + 1
    nms_p, raw_p = fast_score.corner_maps_plain(img, 20.0)
    torch.testing.assert_close(nms_k, nms_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(raw_k[3:-3, 3:-3], raw_p[3:-3, 3:-3], rtol=0, atol=1e-5)


def test_k1_all_levels_one_launch(cuda):
    """The 8 levels of a 640x480 frame in one launch, each level's maps as
    the plain version's; the one-level call on an odd shape."""
    levels = [x.contiguous() for x in pyramid.build_pyramid(_image(cuda, 480, 640, seed=5))]
    before = launches.count("corner_maps")
    maps = fast_score.corner_maps_levels(levels, 20.0)
    torch.cuda.synchronize()
    assert launches.count("corner_maps") == before + 1
    for img, (nms_k, raw_k), (nms_p, raw_p) in zip(
            levels, maps, fast_score.corner_maps_levels_plain(levels, 20.0)):
        assert nms_k.shape == img.shape
        torch.testing.assert_close(nms_k, nms_p, rtol=0, atol=1e-5)
        torch.testing.assert_close(raw_k[3:-3, 3:-3], raw_p[3:-3, 3:-3], rtol=0, atol=1e-5)
    odd = _image(cuda, 101, 173, seed=6)
    nms_k, raw_k = fast_score.corner_maps(odd, 20.0)
    nms_p, raw_p = fast_score.corner_maps_plain(odd, 20.0)
    assert launches.count("corner_maps") == before + 2
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
    before = launches.count("corner_maps")
    for i in range(12):
        sess.add_frame(imgs[i], k, i / 30.0)
    # one K1 launch per frame, all levels, plus one per captured image
    # program's warm-up run (the tracked part's and the untracked frames'
    # ingest)
    warmups = sum(1 for key in sess.capture_s if key[:2] in (("track", "image"), ("ingest", "image")))
    assert warmups >= 1
    assert launches.count("corner_maps") - before == 12 + warmups
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
    before = launches.count("hamming_top2")
    k = hamming.hamming_top2(a, b, bv)
    torch.cuda.synchronize()
    assert launches.count("hamming_top2") == before + 1
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
    before = launches.count("hamming_top2")
    k = hamming.hamming_top2(a, b.contiguous(), bv)
    torch.cuda.synchronize()
    assert launches.count("hamming_top2") == before + 1
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
    from monocular_slam_tpu_torch.ops import matching

    a = _pm1(cuda, 500, 11)
    b = torch.cat([a[:400], _pm1(cuda, 100, 12)])
    b = torch.where(torch.rand(b.shape, device=cuda) < 0.05, -b, b).contiguous()
    av = torch.rand(500, device=cuda) > 0.1
    bv = torch.rand(500, device=cuda) > 0.1
    before = launches.count("hamming_top2")
    mk = matching.match(a, b, av, bv, use_kernel=True)
    assert launches.count("hamming_top2") == before + 2  # forward pass and the cross-check pass
    md = matching.match(a, b, av, bv, use_kernel=False)
    assert launches.count("hamming_top2") == before + 2
    assert torch.equal(mk.ok, md.ok) and int(mk.n_matches) > 300
    assert torch.equal(mk.idx[mk.ok], md.idx[md.ok])
    # the default route takes K2 for a single database of >= 4096 rows
    big = _pm1(cuda, matching.PALLAS_MIN_DB, 13)
    matching.match(a, big, av, torch.ones(big.shape[0], dtype=torch.bool, device=cuda))
    assert launches.count("hamming_top2") == before + 4


def test_window_route_equals_dense_on_session_state(cuda):
    """The tracker's back-traverse window on a real session state: K2 (two
    launches) and the dense route give the same `Matches` on every row."""
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.slam import tracker
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.session import SlamSession

    imgs, _, k = render.render_sequence(seed=3, n_frames=9, wh=(320, 240), device=cuda)
    cfg = SlamConfig(max_frames=16, max_points=4000, image_wh=(320, 240),
                     frontend=FrontendConfig(n_features=600))
    sess = SlamSession(cfg, seed=0, device=cuda)
    for i in range(9):
        sess.add_frame(imgs[i], k, i / 30.0)
    before = launches.count("hamming_top2")
    _, _, mk = tracker._window_matches(sess.state, 8, cfg, use_kernel=True)
    assert launches.count("hamming_top2") == before + 2
    _, _, md = tracker._window_matches(sess.state, 8, cfg, use_kernel=False)
    for f in ("idx", "dist", "ok", "n_matches"):
        assert torch.equal(getattr(mk, f), getattr(md, f)), f
    assert int(mk.n_matches.max()) > 50


def test_loop_closer_session_on_cuda(cuda):
    """A 320x240 loop-closing session on the card: detection every frame,
    relocalization through K2 after a blackout, finite poses."""
    from monocular_slam_tpu_torch.datasets import render
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
    launches.reset()
    for i in range(frames.shape[0]):
        sess.add_frame(frames[i], k, i / 30.0)
    poses, valid, _ = sess.trajectory()
    assert sess.reloc_attempts >= 1 and launches.count("hamming_top2") >= 2
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
    steering mode in each of the two image programs it captures (the
    tracked part's and the untracked frames' ingest: a capture's warm-up
    run launches for real); frames from a uint8 buffer on the card
    track."""
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser
    from monocular_slam_tpu_torch.slam.session import SlamSession

    imgs, _, k = render.render_sequence(seed=3, n_frames=8, wh=(320, 240), device=cuda)
    cfg = SlamConfig(max_frames=16, max_points=4000, image_wh=(320, 240),
                     frontend=FrontendConfig(n_features=600))
    sess = SlamSession(cfg, seed=0, loop_closer=LoopCloser(vocabulary.load_default(), cfg))
    before = launches.count("corner_maps")
    assert sess.prewarm(image=True) > 0
    # "auto" steering: both modes, each in the tracked part and the ingest
    assert launches.count("corner_maps") == before + 4
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


@pytest.mark.parametrize("shape", [(512, 1000), (2000, 1000), (256, 1000), (7, 13)])
def test_keyed_draws_on_cuda_match_numpy(cuda, shape):
    """The session's RANSAC draws made on the card equal the numpy
    generator bit for bit, and `_sample_indices` picks the same indices on
    the card as on the CPU."""
    from monocular_slam_tpu_torch.geometry import epipolar
    from monocular_slam_tpu_torch.utils import prng

    for seed in (0, 3, 12345):
        key = prng.PRNGKey(seed)
        got = prng.uniform_on(key, shape, cuda, minval=1e-6, maxval=1.0).cpu().numpy()
        np.testing.assert_array_equal(got, prng.uniform(key, shape, np.float32, 1e-6, 1.0))
        mask = torch.as_tensor(np.random.RandomState(seed).rand(shape[1]) > 0.3)
        size = min(8, shape[1])
        np.testing.assert_array_equal(
            epipolar._sample_indices(key, shape[0], size, mask.to(cuda)).cpu().numpy(),
            epipolar._sample_indices(key, shape[0], size, mask).numpy())


# --- K3 and the step program -----------------------------------------------------


def _spd(dev, shape, n, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn(*shape, n + 2, n, generator=g, dtype=torch.float64)
    return (a.mT @ a).to(torch.float32).to(dev)


# every n from 1 to 12: the per-thread kernel (n <= 4; 32 matrices a block)
# and the warp kernel (n = 5..12; 4 matrices a block), odd n with the
# phantom index, batches that fill neither a warp nor a block; float64 too
K3_EIGH_CASES = [((1000,), 4, torch.float32), ((33,), 3, torch.float32), ((1,), 2, torch.float32),
                 ((2, 3), 1, torch.float32), ((7,), 4, torch.float64), ((5,), 5, torch.float32),
                 ((), 6, torch.float32), ((1,), 7, torch.float32), ((6,), 8, torch.float32),
                 ((5,), 9, torch.float32), ((), 10, torch.float32), ((7,), 11, torch.float32),
                 ((3,), 12, torch.float32), ((2,), 12, torch.float64)]


@pytest.mark.parametrize("shape,n,dtype", K3_EIGH_CASES)
def test_k3_eigh_matches_plain(cuda, shape, n, dtype):
    """K3's eigh against `torch.linalg.eigh`: eigenvalues within 1e-5 of the
    largest; eigenvectors |<v, v_plain>| >= 1 - 1e-5 where the eigengap
    exceeds 1e-3 of the largest eigenvalue; A V = V diag(w); each vector's
    largest-magnitude entry positive."""
    from monocular_slam_tpu_torch.ops import small_eigh

    A = _spd(cuda, shape, n, seed=n).to(dtype)
    before = launches.count("small_eigh")
    w, V = small_eigh.eigh(A)
    torch.cuda.synchronize()
    assert launches.count("small_eigh") == before + 1
    assert w.dtype == V.dtype == dtype
    wp, Vp = small_eigh.eigh_plain(A)
    scale = wp.abs().amax(-1, keepdim=True)
    assert float(((w - wp).abs() / scale).max()) <= 1e-5
    assert bool((w[..., 1:] >= w[..., :-1]).all())
    big = torch.gather(V, -2, V.abs().argmax(-2, keepdim=True))
    assert bool((big > 0).all())
    gap = torch.full_like(wp, float("inf"))
    if n > 1:
        d = wp[..., 1:] - wp[..., :-1]
        gap[..., 1:] = torch.minimum(gap[..., 1:], d)
        gap[..., :-1] = torch.minimum(gap[..., :-1], d)
    dots = (V * Vp).sum(-2).abs()
    sel = gap > 1e-3 * scale
    assert bool(sel.any()) and float(dots[sel].min()) >= 1 - 1e-5
    assert float((A @ V - V * w[..., None, :]).abs().max() / scale.max()) <= 1e-5
    with pytest.raises(ValueError):
        small_eigh.eigh(torch.zeros(2, 13, 13, device=cuda))


def _degenerate(kind, n, dev):
    g = torch.Generator(device="cpu").manual_seed(n)
    if kind == "identity":
        A = torch.eye(n, dtype=torch.float64)
    elif kind == "zero":
        A = torch.zeros(n, n, dtype=torch.float64)
    elif kind in ("rank1", "rank2"):
        x = torch.randn(int(kind[-1]), n, generator=g, dtype=torch.float64)
        A = x.mT @ x
    else:  # repeated eigenvalues
        Q, _ = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=torch.float64))
        d = torch.tensor([1.0, 1.0, 2.0, 2.0, 2.0, 3.0, 3.0, 3.0, 3.0, 5.0, 5.0, 6.0])[:n]
        A = (Q * d.double()) @ Q.mT
    return A.to(torch.float32).to(dev)


@pytest.mark.parametrize("kind", ["identity", "zero", "rank1", "rank2", "repeated"])
@pytest.mark.parametrize("n", [3, 4, 5, 12])
def test_k3_eigh_degenerate(cuda, kind, n):
    """Identity, zero, rank-1, rank-2 and repeated-eigenvalue inputs: values
    within 1e-5 of the largest of `torch.linalg.eigh`'s, A V = V diag(w),
    V orthonormal (a repeated eigenvalue's basis is any); identity and zero
    give V = I."""
    from monocular_slam_tpu_torch.ops import small_eigh

    A = _degenerate(kind, n, cuda)
    w, V = small_eigh.eigh(A)
    wp, _ = small_eigh.eigh_plain(A)
    scale = max(float(wp.abs().max()), 1.0)
    assert float((w - wp).abs().max()) <= 1e-5 * scale
    assert float((A @ V - V * w).abs().max()) <= 1e-5 * scale
    torch.testing.assert_close(V.mT @ V, torch.eye(n, device=cuda), rtol=0, atol=1e-5)
    if kind in ("identity", "zero"):
        assert torch.equal(V, torch.eye(n, device=cuda))


@pytest.mark.parametrize("n", [1, 4, 12])
def test_k3_eigh_nan_input(cuda, n):
    """A NaN matrix stops the sweeps at once (its off-diagonal mass is not
    finite) and writes every eigenvalue slot, all NaN."""
    from monocular_slam_tpu_torch.ops import small_eigh

    w, V = small_eigh.eigh(torch.full((3, n, n), float("nan"), device=cuda))
    torch.cuda.synchronize()
    assert bool(w.isnan().all())
    assert torch.equal(V, torch.eye(n, device=cuda).expand(3, n, n))


@pytest.mark.parametrize("batch", [1, 512])
def test_k3_svd3_matches_plain(cuda, batch):
    """K3's 3x3 SVD: singular values and the product U S Vt as the plain
    version's; U and V orthonormal; rank-1, rank-2 and zero matrices still
    give orthonormal bases (the completion); `project_to_so3` on the card a
    rotation."""
    from monocular_slam_tpu_torch.geometry import so3
    from monocular_slam_tpu_torch.ops import small_eigh

    g = torch.Generator(device="cpu").manual_seed(batch)
    M = torch.randn(batch, 3, 3, generator=g).to(cuda)
    U, S, Vt = small_eigh.svd3(M)
    Up, Sp, Vtp = small_eigh.svd3_plain(M)
    torch.testing.assert_close(S, Sp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close((U * S[..., None, :]) @ Vt, M, rtol=0, atol=1e-5)
    eye = torch.eye(3, device=cuda).expand(batch, 3, 3)
    torch.testing.assert_close(U.mT @ U, eye, rtol=0, atol=1e-5)
    torch.testing.assert_close(Vt @ Vt.mT, eye, rtol=0, atol=1e-5)
    r1 = torch.outer(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.5, -1.0, 2.0])).to(cuda)
    r2 = (torch.randn(3, 2, generator=g) @ torch.randn(2, 3, generator=g)).to(cuda)
    for low in (r1, r2, torch.zeros(3, 3, device=cuda)):
        Ul, Sl, Vtl = small_eigh.svd3(low)
        torch.testing.assert_close(Sl, small_eigh.svd3_plain(low)[1], rtol=0,
                                   atol=1e-5 * max(float(low.abs().max()), 1.0))
        torch.testing.assert_close(Ul.mT @ Ul, torch.eye(3, device=cuda), rtol=0, atol=1e-5)
        torch.testing.assert_close(Vtl @ Vtl.mT, torch.eye(3, device=cuda), rtol=0, atol=1e-5)
        torch.testing.assert_close((Ul * Sl[..., None, :]) @ Vtl, low, rtol=0, atol=1e-5)
    R = so3.project_to_so3(M)
    torch.testing.assert_close(R.mT @ R, eye, rtol=0, atol=1e-5)
    assert float((torch.linalg.det(R) - 1).abs().max()) < 1e-5


# --- pose_gn: motion-only BA's Gauss-Newton route as one kernel ---------------


def _pose_gn_check(args, **kw):
    """The kernel's and the plain route's results on the same call; the
    kernel launched exactly once; the agreement within `chip_smoke`'s
    tolerances (the card test's)."""
    import chip_smoke
    from monocular_slam_tpu_torch.optim import pose_ba

    before = launches.count("pose_gn")
    a = pose_ba.refine_pose(*args, solver="gn", **kw)
    torch.cuda.synchronize()
    assert launches.count("pose_gn") == before + 1
    b = pose_ba.refine_pose_plain(*args, solver="gn", **kw)
    assert (a.T.dtype, a.inliers.dtype, a.chi2.dtype, a.n_inliers.dtype) == (
        torch.float32, torch.bool, torch.float32, torch.int64)
    assert (a.T.shape, a.inliers.shape, a.chi2.shape, a.n_inliers.shape) == (
        b.T.shape, b.inliers.shape, b.chi2.shape, b.n_inliers.shape)
    agr = chip_smoke.pose_gn_agreement(a, b, args[1], args[2], args[3])
    assert not chip_smoke.pose_gn_fails(agr), agr
    return a, b, agr


@pytest.mark.parametrize("n", [1000, 2000])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("rounds", [2, 3])
def test_pose_gn_matches_plain(cuda, n, batch, rounds):
    """`pose_gn` against the plain route on the tracker's problems: rotations
    within 1e-5 rad, translations within 1e-5 of their length, inlier sets
    equal but for edges within 1e-4 of the gate, n_inliers counting them,
    chi2 within 1e-4; batch 1 as the tracker calls it, unbatched."""
    import chip_smoke

    T0, X, uv, k, w = chip_smoke.pose_gn_problem(batch, n, seed=31 * n + batch, device=cuda)
    args = (T0[0], X[0], uv[0], k, w[0]) if batch == 1 else (T0, X, uv, k, w)
    a, b, agr = _pose_gn_check(args, n_rounds=rounds)
    assert agr["chi2_rel"] <= 1e-4, agr
    assert bool((a.n_inliers > 0.5 * n).all())  # the refine converged: most edges inliers


@pytest.mark.parametrize("case", ["few_valid", "all_zero", "z_zero", "z_zero_active",
                                  "z_zero_gated", "singular"])
def test_pose_gn_edge_cases(cuda, case):
    """Fewer than min_points valid edges and all weights zero return T0 (and
    its chi2 and inliers); a masked edge whose point lies at depth ~0 in the
    camera changes nothing and is no inlier; an active edge at depth exactly
    0 (the world's origin moved onto the camera's plane, the point there)
    goes through `_safe_z`'s clamp: with no round its clamped residual
    (~1e10 px) enters the chi2 as on the plain route, and with no step a
    re-gate (at 1e4, which every other edge passes) drops it. A step with that edge active is left out: its weight times its
    Jacobian squared grows as 1/z^3 and swamps H in float32 on either route,
    so the two poses would agree only by chance. A system that is singular
    (points on the optical axis, the start at the identity, tau 0: H's rows
    for the rotation about and the shift along the axis are 0) leaves T0 as
    the plain route's NaN guard does."""
    import chip_smoke
    from monocular_slam_tpu_torch.geometry import se3

    T0, X, uv, k, w = (x[0] if x.dim() > 1 else x
                       for x in chip_smoke.pose_gn_problem(1, 1000, seed=77, device=cuda))
    kw = {"n_rounds": 3}
    if case == "few_valid":
        w = torch.zeros_like(w)
        w[:2] = 1.0
    elif case == "all_zero":
        w = torch.zeros_like(w)
    elif case == "z_zero":
        R, t = T0[:, :3], T0[:, 3]
        X = X.clone()
        X[5] = R.mT @ (torch.tensor([0.05, -0.03, 0.0], device=cuda) - t)
        w = w.clone()
        w[5] = 0.0
    elif case in ("z_zero_active", "z_zero_gated"):
        # the world's origin moved onto the camera's plane z = 0, the problem
        # otherwise as it was; edge 5's point at that origin
        R, t = T0[:, :3], T0[:, 3]
        c = t[2] * R[2]
        X = (X + c).contiguous()
        T0 = T0.clone()
        T0[:, 3] = t - R @ c
        T0[2, 3] = 0.0
        X[5] = 0.0
        w = w.clone()
        w[5] = 1.0
        kw = ({"n_rounds": 0} if case == "z_zero_active"
              else {"n_rounds": 2, "n_iters": 0, "chi2_gate": 1e4})
    else:
        g = torch.Generator(device="cpu").manual_seed(3)
        X = torch.zeros(1000, 3)
        X[:, 2] = 2.0 + 5.0 * torch.rand(1000, generator=g)
        uv = (k[2:].cpu() + torch.randn(1000, 2, generator=g)).to(cuda)
        X, w, T0 = X.to(cuda), torch.ones(1000, device=cuda), se3.identity(device=cuda).contiguous()
        kw["tau"] = 0.0
    a, b, agr = _pose_gn_check((T0, X, uv, k, w), **kw)
    assert bool(torch.isfinite(a.T).all())
    if case == "z_zero":
        assert not bool(a.inliers[5]) and agr["chi2_rel"] <= 1e-4
        return
    assert torch.equal(a.T, T0) and torch.equal(b.T, T0)
    torch.testing.assert_close(a.chi2, b.chi2, rtol=1e-5, atol=0)
    if case.startswith("z_zero"):
        assert not bool(a.inliers[5]) and not bool(b.inliers[5])
        assert (float(a.chi2) > 1e9) == (case == "z_zero_active"), float(a.chi2)


def test_pose_gn_in_a_captured_program(cuda):
    """`refine_pose` captured into a CUDA graph and replayed 3 times: the
    `pose_gn` counter rises by exactly 3 and each replay gives the eager
    call's result bit for bit (the block sums run in a fixed order)."""
    import chip_smoke
    from monocular_slam_tpu_torch.optim import pose_ba
    from monocular_slam_tpu_torch.utils import graph

    T0, X, uv, k, w = chip_smoke.pose_gn_problem(1, 1000, seed=5, device=cuda)
    args = (T0[0], X[0], uv[0], k, w[0])
    eager = pose_ba.refine_pose(*args, n_rounds=3, solver="gn")
    with torch.inference_mode():
        prog = graph.Program(lambda: pose_ba.refine_pose(*args, n_rounds=3, solver="gn"),
                             stream=torch.cuda.Stream(cuda))
    torch.cuda.synchronize()
    before = launches.count("pose_gn")
    for _ in range(3):
        out = prog.replay()
        torch.cuda.synchronize()
        for x, y in zip(out, eager):
            assert torch.equal(x, y)
    assert launches.count("pose_gn") == before + 3


def test_step_program_equals_eager_on_cuda(cuda):
    """A feature course through the captured step programs and through the
    same functions op by op on the card: equal tracked flags, keyframes
    and outcomes, poses within 1e-6; one host read of the mapping flags
    per tracked frame, and each tracked frame's K2 launches as the card
    counted them; two svd3 launches a tracked step."""
    from monocular_slam_tpu_torch.datasets import synthetic
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.session import SlamSession
    from monocular_slam_tpu_torch.utils import prng

    seq = synthetic.feature_sequence(prng.PRNGKey(0), n_frames=16, n_features=300, device=cuda)
    cfg = SlamConfig(max_frames=16, max_points=3000, frontend=FrontendConfig(n_features=300))
    runs = []
    for use_graphs in (True, False):
        sess = SlamSession(cfg, seed=0, device=cuda)
        sess._use_graphs = use_graphs
        for i, f in enumerate(seq.frames):
            sess.add_frame_features(f, seq.k, float(i))
        poses, valid, _ = sess.trajectory()
        runs.append((sess, poses, valid, sess.keyframes,
                     [(s.tracked, s.n_inliers, s.n_new_points, s.is_keyframe, s.n_fused,
                       s.n_culled, s.last_kf) for s in sess.stats]))
    (g, pg, vg, kg, sg), (e, pe, ve, ke, se) = runs
    np.testing.assert_array_equal(vg, ve)
    assert kg == ke and sg == se
    assert np.abs(pg[vg] - pe[vg]).max() <= 1e-6
    assert vg.sum() >= 14
    k2g = [c["hamming_top2"] for c in g.step_launches]
    k2e = [c["hamming_top2"] for c in e.step_launches]
    assert g.flag_reads == len(k2g) >= 13 and e.flag_reads == 0
    assert min(k2g) >= 2 and k2g[1:] == k2e[1:]
    # one svd3 per LO refit of the PnP (two rounds), scale and rotation alike
    assert [c["svd3"] for c in g.step_launches[1:]] == [2] * (len(k2g) - 1)
    assert [c["svd3"] for c in e.step_launches] == [2] * len(k2e)
    assert any(key[0] == "map" for key in g.capture_s)


def test_tracing_on_cuda(cuda):
    """An image course through two sessions on the card, tracing off and on:
    with tracing off no program holds a stamp, and with it on the track
    program holds its 3 stamps more and each mapping program 2 and one a
    part it runs, nothing else (device operations of one replay, by the
    profiler); the outcomes and poses are equal; every tracked frame's
    stamps are in order; and a replay of the track program's front end and
    tracker by the stamps is within 2% of its first to last device
    operation in the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from monocular_slam_tpu_torch.benchmarks import device_ops
    from monocular_slam_tpu_torch.datasets import render
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.session import SlamSession
    from monocular_slam_tpu_torch.utils import profiling

    imgs, _, k = render.render_sequence(seed=3, n_frames=12, wh=(320, 240), device=cuda)
    cfg = SlamConfig(max_frames=16, max_points=4000, image_wh=(320, 240),
                     frontend=FrontendConfig(n_features=600))
    runs = {}
    for trace in (False, True):
        sess = SlamSession(cfg, seed=0, device=cuda, trace=trace)
        sess.prewarm(image=True)
        for i in range(12):
            sess.add_frame(imgs[i].cpu().numpy(), k, i / 30.0)
        poses, valid, _ = sess.trajectory()
        runs[trace] = (sess, poses, valid, [
            (s.tracked, s.n_inliers, s.n_new_points, s.is_keyframe, s.n_fused, s.n_culled,
             s.last_kf, s.cand_j, s.cand_n, s.chi2_before, s.chi2_after) for s in sess.stats])
    (off, p_off, v_off, s_off), (on, p_on, v_on, s_on) = runs[False], runs[True]
    np.testing.assert_array_equal(v_off, v_on)
    np.testing.assert_array_equal(p_off, p_on)
    np.testing.assert_array_equal(np.array(s_off, np.float64), np.array(s_on, np.float64))
    assert v_on.sum() >= 10
    assert off.tracer is None and all(st.device_ms is None for st in off.stats)
    parts = [st.device_ms for st in on.stats if st.device_ms is not None]
    assert len(parts) >= 9
    for ms in parts:
        assert {"front_end", "tracker", "detect_pack"} <= set(ms) <= set(profiling.PARTS)
        assert all(v >= 0 for v in ms.values()), ms
    assert any("local_ba" in ms for ms in parts)
    assert set(off._graphs.programs) == set(on._graphs.programs)
    for key in off._graphs.programs:
        n_off = device_ops(off._graphs.programs[key].replay, cuda)
        n_on = device_ops(on._graphs.programs[key].replay, cuda)
        stamps = (3 if key[0] == "track" else 2 + sum(key[1]) if key[0] == "map" else 0)
        assert n_on - n_off == stamps, (key, n_off, n_on)
    # the track program's stamps against the profiler's first and last operation
    prog = next(p for key, p in on._graphs.programs.items() if key[0] == "track")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prog.replay()
        torch.cuda.synchronize()
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    lo = min(e.start_ns() for e in ev)
    hi = max(e.start_ns() + e.duration_ns() for e in ev)
    assert sorted(ev, key=lambda e: e.start_ns())[0].name().startswith("span_stamp")
    ms = profiling.stamp_ms(on.tracer.stamps.cpu().numpy())
    assert ms["front_end"] + ms["tracker"] == pytest.approx((hi - lo) * 1e-6, rel=0.02)


# --- the programs outside the tracked step ------------------------------------------


def _closer_session(cuda, use_graphs=True):
    """A session with a loop closer over the threefry revisit course's first
    14 frames (features), sized so that a keyframe bucket of 8 reaches a
    second bucket, the pose graph past 8 vertices takes its CG route
    (`POSE_GRAPH_DENSE_MAX` patched by the caller) and global BA takes its
    CG route (F * P = 64 * 65536 > 4e6)."""
    from monocular_slam_tpu_torch.datasets import synthetic
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.slam.config import FrontendConfig, SlamConfig
    from monocular_slam_tpu_torch.slam.loop_closer import LoopCloser, LoopClosureConfig
    from monocular_slam_tpu_torch.slam.session import SlamSession
    from monocular_slam_tpu_torch.utils import prng

    seq = synthetic.feature_sequence(prng.PRNGKey(1), n_frames=14, n_features=200,
                                     n_world_points=900, pix_noise=0.4, drop_prob=0.08,
                                     ang_step=0.14, device=cuda)
    desc = torch.cat([f.desc_pm1[f.valid] for f in seq.frames[:6]]).cpu().numpy()
    voc = vocabulary.train(desc, k=6, L=2, seed=0, device=cuda)
    cfg = SlamConfig(max_frames=64, max_points=65536, frontend=FrontendConfig(n_features=200))
    lc = LoopCloser(voc, cfg, LoopClosureConfig(min_gap=3, kf_bucket=8, sim3_iters=64,
                                                global_ba_iters=3), device=cuda)
    sess = SlamSession(cfg, seed=0, loop_closer=lc, device=cuda)
    sess._use_graphs = use_graphs
    sess.prewarm()
    return sess, seq


def _host_snapshot(sess):
    import copy

    lc = sess.loop_closer
    return ([x.clone() for x in sess._state], lc._db.clone(), sess.key.copy(),
            copy.deepcopy({n: getattr(lc, n) for n in ("loop_edges", "routes", "closures",
                                                         "corrected", "reverted",
                                                         "skipped_identity")}),
            copy.deepcopy({n: getattr(sess, n) for n in ("reloc_attempts", "reloc_successes",
                                                           "_kf_culled")}))


def _restore(sess, static, snap):
    tensors, db, key, lc_attrs, sess_attrs = snap
    sess._state = static
    for b, x in zip(static, tensors):
        b.copy_(x)
    sess.loop_closer._db.copy_(db)
    sess.key = key.copy()
    for n, v in lc_attrs.items():
        setattr(sess.loop_closer, n, list(v))
    for n, v in sess_attrs.items():
        setattr(sess, n, type(v)(v))


def _ab(sess, run):
    """`run(sess)` through the captured programs and again op by op from the
    same state: (outputs, state tensors, database) of both, and the program
    calls of the captured run."""
    static, snap = sess._state, _host_snapshot(sess)
    n0 = len(sess._calls)
    out_g = run(sess)
    torch.cuda.synchronize()
    got_g = ([x.clone() for x in sess._state], sess.loop_closer._db.clone())
    calls = sess.program_calls[n0:]
    _restore(sess, static, snap)
    sess._use_graphs = False
    try:
        out_e = run(sess)
        got_e = ([x.clone() for x in sess._state], sess.loop_closer._db.clone())
    finally:
        sess._use_graphs = True
        _restore(sess, static, snap)
    return out_g, out_e, got_g, got_e, calls


def _assert_same(a, b, what):
    from monocular_slam_tpu_torch.slam.state import SlamState

    (sa, dba), (sb, dbb) = a, b
    for n, x, y in zip(SlamState._fields, sa, sb):
        assert torch.equal(x, y), f"{what}: state field {n} differs"
    assert torch.equal(dba, dbb), f"{what}: database differs"


def test_closer_programs_equal_op_by_op_on_cuda(cuda, monkeypatch):
    """Each program outside the tracked step, replayed, against the same
    functions run op by op on the card from the same state, bit for bit in
    state, database and host outputs: the Sim3 (K2 and svd3 inside), the
    relocalization attempt (its scores program, then K2 and K3's eigh in
    each candidate's replay), FrameCulling with its row clearing, the loop
    correction at keyframe buckets 8 (dense pose graph) and 16 (the CG
    pose graph's captured LM step replayed 20 times), each followed by the
    CG global BA's LM step replayed; capturing bucket 16 drops bucket 8's
    correction programs."""
    from monocular_slam_tpu_torch.slam import loop_closer
    from monocular_slam_tpu_torch.utils import prng

    monkeypatch.setattr(loop_closer, "POSE_GRAPH_DENSE_MAX", 8)
    sess, seq = _closer_session(cuda)
    for i, f in enumerate(seq.frames):
        sess.add_frame_features(f, seq.k, float(i))
    sess.flush()
    lc = sess.loop_closer
    assert all(s.tracked for s in sess.stats)

    def sim3(s):
        S, n = s.loop_closer.compute_sim3(s.state, 13, 6, prng.PRNGKey(5))
        return None if S is None else S.clone(), n

    (Sg, ng), (Se, ne), a, b, calls = _ab(sess, sim3)
    assert ng == ne >= 15 and torch.equal(Sg, Se)
    _assert_same(a, b, "sim3")
    assert [c["kind"] for c in calls] == ["sim3"]
    assert calls[0]["launches"]["hamming_top2"] >= 1 and calls[0]["launches"]["svd3"] >= 1

    def reloc(s):
        s.state.pose_valid[13] = False  # the newest frame lost
        s._try_relocalize()
        return s.reloc_attempts, s.reloc_successes, bool(s.stats[-1].tracked)

    out_g, out_e, a, b, calls = _ab(sess, reloc)
    assert out_g == out_e and out_g[0] >= 1
    _assert_same(a, b, "relocalization")
    cands = [c for c in calls if c["kind"] == "relocalize"]
    assert [c["kind"] for c in calls][:1] == ["reloc_scores"] and len(cands) == out_g[0]
    assert all(c["launches"]["hamming_top2"] >= 1 and c["launches"]["small_eigh"] >= 1
               for c in cands)

    sess._keyframes = list(range(0, 14, 2))  # enough keyframes for a pass
    out_g, out_e, a, b, calls = _ab(sess, lambda s: s.cull_redundant_keyframes())
    assert out_g == out_e
    _assert_same(a, b, "culling")
    assert calls[0]["kind"] == "cull"

    S = sim3(sess)[0]
    for kfs, K_pad in (([0, 2, 4, 6], 8), (list(range(13)), 16)):
        def correct(s, kfs=kfs):
            state, applied = s.loop_closer.correct(s.state, 13, 2, S, keyframes=kfs)
            return applied, s.loop_closer._chi2_host, s.loop_closer.routes[-1]

        out_g, out_e, a, b, calls = _ab(sess, correct)
        assert out_g == out_e and out_g[0] is True, (out_g, out_e)
        assert out_g[2]["K_pad"] == K_pad and out_g[2]["global_ba"] == "cg"
        assert out_g[2]["pose_graph"] == ("dense" if K_pad == 8 else "cg")
        _assert_same(a, b, f"correction at K_pad {K_pad}")
        kinds = [c["kind"] for c in calls]
        assert kinds.count("gba") == 2 + lc.lc.global_ba_iters
        assert kinds.count("correct") == (1 if K_pad == 8 else 22)
    held = {key[1] for key in sess._graphs.programs if key[0] == "correct"}
    assert held == {16}, held


def test_bootstrap_program_equals_op_by_op_on_cuda(cuda):
    """Frames 0 and 1 through the ingest and bootstrap programs (captured in
    `prewarm`) and op by op: the same state and BoW rows, bit for bit; one
    host read of the bootstrap's outcome; K3's eigh and svd3 in its
    replay."""
    from monocular_slam_tpu_torch.utils import graph

    runs = []
    for use_graphs in (True, False):
        sess, seq = _closer_session(cuda, use_graphs)
        n0 = graph.Readback.reads
        for i in range(2):
            sess.add_frame_features(seq.frames[i], seq.k, float(i))
        torch.cuda.synchronize()
        runs.append((sess, graph.Readback.reads - n0))
    (g, rg), (e, re) = runs
    assert g.stats[1].tracked and e.stats[1].tracked and rg == re == 1
    for n, x, y in zip(g.state._fields, g.state, e.state):
        assert torch.equal(x, y), n
    assert torch.equal(g.loop_closer._db, e.loop_closer._db)
    assert any(key[0] == "bootstrap" for key in g.capture_s)
    boot = [c for c in g.program_calls if c["kind"] == "bootstrap"]
    assert len(boot) == 1
    assert boot[0]["launches"]["small_eigh"] >= 1 and boot[0]["launches"]["svd3"] >= 1


def test_bench_small_on_cuda(cuda, tmp_path):
    """`monocular_slam_tpu_torch.bench` on the card at a small size (12
    frames at 320x240, 500 features, 12 feature-path frames, 2 chained
    links): `bench.py`'s keys, K1 once a frame in each image pass (counted
    by the kernel from 0 after the pass's prewarm), K2 and K3 in every
    tracked step and in every replay of the fused step."""
    import ast
    from pathlib import Path

    from monocular_slam_tpu_torch import bench

    out, det = bench.run("cuda", n_feat=500, n_frames=12, wh=(320, 240), feature_frames=12,
                         world_points=600, n_rep=2, root=str(tmp_path / "tum"))
    tree = ast.parse((Path(__file__).resolve().parent.parent / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = next([k.value for k in n.args[0].keys] for n in ast.walk(main)
                if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "dumps")
    assert list(out) == keys
    for name, ps in det["passes"].items():
        assert ps["k1"] == ps["frames"] == 12, (name, ps)
        assert ps["step_min"]["hamming_top2"] >= 2 and ps["step_min"]["small_eigh"] >= 1, ps
        assert ps["step_min"]["svd3"] >= 1, ps
    fl = det["fused_launches"]
    assert fl["hamming_top2"] >= 4 and fl["small_eigh"] >= 2 and fl["svd3"] >= 2, fl
    assert out["rooflines"]["session_step"]["device_ops"] > 100


@pytest.mark.parametrize("kind", ["words", "readback", "program", "event", "pinned"])
def test_capture_is_not_broken_by_a_collection(cuda, kind):
    """One kind of CUDA resource handed, inside a `graph.Program` capture,
    to a new unreachable reference cycle, its only owner, with the
    collector's thresholds at 1: the capture pauses the collector, so the
    cycle outlives the capture, the replay is right, and the cycle is
    collected after it (`chip_profile.py capturegc` shows which captures a
    collection inside them breaks)."""
    import gc
    import weakref

    from monocular_slam_tpu_torch.utils import graph

    class Holder:
        pass

    h = Holder()
    if kind == "words":
        h.res = graph.Words(4, cuda)
        h.res.fill(np.arange(4))
    elif kind == "readback":
        h.res = graph.Readback(4, cuda).start()
    elif kind == "program":
        z = torch.zeros(8, device=cuda)
        h.res = graph.Program(lambda: z.add_(1), stream=torch.cuda.Stream(cuda))
    elif kind == "event":
        h.res = torch.cuda.Event()
        h.res.record()
    else:
        h.res = torch.arange(256, dtype=torch.float32).pin_memory()
        h.dev = torch.empty(256, device=cuda)
        h.dev.copy_(h.res, non_blocking=True)
    torch.cuda.synchronize()
    pending, ref, seen = [h], weakref.ref(h), {}
    del h
    x = torch.arange(64, dtype=torch.float32, device=cuda)

    def body():
        if graph.capturing():
            cycle = Holder()
            cycle.me, cycle.res = cycle, pending.pop()
            del cycle
            junk = [[i] for i in range(2000)]
            del junk
            seen["alive"] = ref() is not None
        return x * 2.0 + 1.0

    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        prog = graph.Program(body, stream=torch.cuda.Stream(cuda))
        y = prog.replay()
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*old)
    assert seen["alive"]
    assert torch.equal(y, x * 2.0 + 1.0)
    gc.collect()
    assert ref() is None
