"""The port's drivers (`monocular_slam_tpu_torch/bench.py` and
`monocular_slam_tpu_torch/benchmarks/{long_run,kitti_scale,loop_match_scale}.py`)
on the CPU at small sizes, against their JAX counterparts:

  - each writes exactly its reference driver's JSON keys, read from
    `bench.py`'s AST and from the committed `benchmarks/*_r0*.json` and
    `benchmarks/long_run_tpu.json`;
  - the bench's chained fused step (`tracker.track` + `local_bundle_adjust`
    at the feature path's last frame, link r keyed `fold_in(PRNGKey(7), r)`)
    from the port's warm feature-path state matches the reference's chain
    from the same state (carried across with `slam/state.state_from_numpy`;
    the reference with x64 off, so that its draws are the port's float32
    ones), with `test_torch_slice.py::test_track_step`'s tolerances: tracked
    flags, inlier and new-point counts, associations and point and pose
    validity exact, poses within 2e-3;
  - `ba_iters_per_sec` counts `cfg.ba.local_iters` LM iterations a call.

The course the bench exports is `render.export_tum(seed=11)`: the port's
export equals the reference exporter's output on the same frames
(`test_torch_host.py::test_export_tum_cross_loads`) and its frames are the
reference's threefry course (`test_torch_host.py`); here only the bench's
call of it is checked.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monocular_slam_tpu.slam import local_ba as jlba
from monocular_slam_tpu.slam import state as jstate
from monocular_slam_tpu.slam import tracker as jtrack
from monocular_slam_tpu.slam.config import FrontendConfig as JFrontend
from monocular_slam_tpu.slam.config import SlamConfig as JConfig
from monocular_slam_tpu_torch import bench
from monocular_slam_tpu_torch.benchmarks import kitti_scale, long_run, loop_match_scale
from monocular_slam_tpu_torch.slam import state as tstate
from monocular_slam_tpu_torch.slam.config import SlamConfig
from port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
# small sizes: a 12-frame 320x240 course (the smallest at which the image
# path bootstraps with 500 features), a 12-frame feature path, 2 links
SMALL = dict(n_feat=500, n_frames=12, wh=(320, 240), feature_frames=12, world_points=600,
             n_rep=2)


def _reference_keys(path: Path) -> list:
    """The keys of the dict literal `bench.py`'s `main` prints."""
    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no json.dumps of a dict literal in bench.py's main")


def _nested_keys(d: dict) -> dict:
    return {k: (sorted(v) if isinstance(v, dict) else None) for k, v in d.items()}


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    return bench.run("cpu", root=str(tmp_path_factory.mktemp("bench_tum")), **SMALL)


def test_bench_keys_are_bench_py(bench_run):
    """One JSON object with exactly `bench.py`'s top-level keys; the five
    roofline rows, the three without a cost model carrying no operation
    count, and `mfu` null."""
    out, det = bench_run
    assert list(out) == _reference_keys(ROOT / "bench.py")
    json.dumps(out)
    names = bench.roofline_names(SMALL["wh"], SMALL["n_feat"])
    assert sorted(out["rooflines"]) == sorted(["session_step", "local_ba", *names.values()])
    assert bench.roofline_names((640, 480), 1000) == {
        "matcher": "matcher_1kx1k", "fast": "fast_640x480", "extract": "extract_640x480"}
    for name in ("session_step", "local_ba", names["extract"]):
        row = out["rooflines"][name]
        assert row["flops"] is None and row["mfu"] is None and row["wall_ms"] > 0
    assert out["rooflines"][names["fast"]]["flops"] == 160 * 320 * 240
    assert out["mfu"] is None and out["device"] == "cpu"
    tracked, n = (int(x) for x in out["image_pipeline_tracked"].split("/"))
    assert n == SMALL["n_frames"] and tracked >= n - 2
    assert out["kernel_tracked"] == f"{SMALL['feature_frames']}/{SMALL['feature_frames']}"
    for name in ("value", "lc_fps", "ingest_overlapped_fps", "kernel_fps", "ba_iters_per_sec"):
        assert np.isfinite(out[name]) and out[name] > 0, name
    assert out["vs_baseline"] == out["value"] / bench.REFERENCE_FPS_ESTIMATE
    assert sorted(det["passes"]) == ["image", "loop_closer", "overlapped", "warmup"]
    np.testing.assert_array_equal(det["decoded"].shape, (SMALL["n_frames"], 240, 320))


def test_ba_iters_per_sec_counts_local_iters(bench_run):
    """`ba_iters_per_sec` is `cfg.ba.local_iters` over the seconds of one
    local BA call, the reference's `bench_ba_iters`, whose count is the
    same configuration field."""
    out, det = bench_run
    assert det["ba_local_iters"] == SlamConfig().ba.local_iters == JConfig().ba.local_iters
    assert out["ba_iters_per_sec"] == det["ba_local_iters"] / det["ba_s"]


def test_fused_chain_matches_reference(bench_run):
    """The bench's fused chain from the port's warm state against the
    reference's `frame_step` chain from the same state (see the module
    docstring for the tolerances)."""
    _, det = bench_run
    i, n_rep = det["fused_i"], det["n_rep"]
    pre = tstate.state_to_numpy(det["warm_state"])
    with jax.enable_x64(False):
        cfg = JConfig(max_frames=64, max_points=20000,
                      frontend=JFrontend(n_features=SMALL["n_feat"]))

        @jax.jit
        def frame_step(state, key):
            t = jtrack.track(state, i, key, cfg)
            b = jlba.local_bundle_adjust(t.state, i, cfg)
            return b.state, jnp.stack([t.ok.astype(jnp.int32), t.n_pnp_inliers.astype(jnp.int32),
                                       t.n_new_points.astype(jnp.int32)])

        key = jax.random.PRNGKey(bench.FUSED_KEY)
        cur = jstate.SlamState(**{n: jnp.asarray(v) for n, v in pre.items()})
        links = []
        for r in range(n_rep):
            cur, link = frame_step(cur, jax.random.fold_in(key, r))
            links.append(np.asarray(link).tolist())
        ref = {n: np.asarray(v) for n, v in cur._asdict().items()}
    assert det["fused_links"] == links and all(x[0] == 1 for x in links)
    got = tstate.state_to_numpy(det["fused_state"])
    for n in ("feat_point", "pose_valid", "point_valid", "n_points", "slot_of"):
        np.testing.assert_array_equal(got[n], ref[n].astype(got[n].dtype), err_msg=n)
    v = ref["pose_valid"]
    np.testing.assert_allclose(got["poses"][v], ref["poses"][v], atol=2e-3)


def test_bench_exports_the_reference_course(tmp_path, monkeypatch):
    """The bench's course is `export_tum(seed=11)` at the asked size (the
    reference's `export_tum(PRNGKey(11))`), re-exported when the cached
    directory's render version or size differs, and reused otherwise."""
    from monocular_slam_tpu_torch.datasets import render

    calls = []
    plain = render.export_tum

    def export(root, seed=0, **kw):
        calls.append((seed, kw["n_frames"], kw["wh"]))
        return plain(root, seed=seed, tex_size=256, **kw)

    monkeypatch.setattr(render, "export_tum", export)
    root = str(tmp_path / "c")
    seq = bench.bench_course(root, 3, (64, 48), "cpu")
    assert calls == [(bench.COURSE_SEED, 3, (64, 48))] and bench.COURSE_SEED == 11
    assert len(seq.frames) == 3 and tuple(seq.wh) == (64, 48)
    bench.bench_course(root, 3, (64, 48), "cpu")
    assert len(calls) == 1
    bench.bench_course(root, 4, (64, 48), "cpu")
    assert len(calls) == 2
    (tmp_path / "c" / "VERSION").write_text("0\n")
    bench.bench_course(root, 4, (64, 48), "cpu")
    assert len(calls) == 3


def test_long_run_writes_the_reference_fields(tmp_path):
    """`benchmarks.long_run` through its CLI on a short course: the fields
    of `benchmarks/long_run_tpu.json`, with its closure timing keys."""
    out = tmp_path / "out"
    assert long_run.main(["--frames", "10", "--slots", "8", "--wh", "320", "240",
                          "--features", "500", "--root", str(tmp_path / "tum"),
                          "--out", str(out), "--device", "cpu"]) == 0
    got = json.loads((out / "long_run_cpu.json").read_text())
    want = json.loads((ROOT / "benchmarks" / "long_run_tpu.json").read_text())
    assert list(got) == list(want)
    assert sorted(got["closure_timings_s"]) == sorted(want["closure_timings_s"])
    # at this width the orbit's 2.9 degrees a frame loses some frames: the
    # fields, not the tracking, are checked here (the card's long phase
    # holds the tracking at full width)
    assert got["frames"] == 10 and got["max_slots"] == 8 and 1 <= got["tracked"] <= 10
    assert got["frames_evicted"] >= 1 and got["resolution"] == "320x240"
    assert (out / "long_run_traj_cpu.npz").exists()


def test_kitti_scale_writes_the_reference_keys(tmp_path):
    """`benchmarks.kitti_scale` with the CPU yardstick at a small size: the
    keys of `kitti_scale_r05.json` at both levels; the solvers run and
    reduce chi2."""
    path = tmp_path / "k.json"
    assert kitti_scale.main(["--keyframes", "64", "--loops", "4", "--ba-frames", "8",
                             "--ba-points", "200", "--obs-per-frame", "60", "--iters", "3",
                             "--cpu-yardstick", "--device", "cpu", "--out", str(path)]) == 0
    got = json.loads(path.read_text())
    want = json.loads((ROOT / "benchmarks" / "kitti_scale_r05.json").read_text())
    assert _nested_keys(got) == _nested_keys(want)
    assert got["pose_graph_cg_10k"]["chi2_final"] < got["pose_graph_cg_10k"]["chi2_initial"]
    assert got["global_ba_cg"]["chi2_final"] < got["global_ba_cg"]["chi2_initial"]
    assert got["global_ba_cg"]["n_edges"] == 8 * 60


def test_loop_match_scale_writes_the_reference_keys():
    """`benchmarks.loop_match_scale` at a small size: the keys of
    `loop_match_scale_r02.json` at both levels for sections 1-3, then one
    `direct_index_vs_full_<M>` row per map size with the keys the JAX
    driver's section 4 writes (its AST: no committed record has them)."""
    got = loop_match_scale.run(db_frames=50, n_feat=64, map_points=300, device="cpu", n=2,
                               maps=(256, 512))
    want = json.loads((ROOT / "benchmarks" / "loop_match_scale_r02.json").read_text())
    rows = [k for k in got if k.startswith("direct_index_vs_full_")]
    assert rows == ["direct_index_vs_full_256", "direct_index_vs_full_512"] == list(got)[-2:]
    assert _nested_keys({k: v for k, v in got.items() if k not in rows}) == _nested_keys(want)
    assert got["map_scale_match"]["n_map_points"] == 300 and got["map_scale_match"]["ms"] > 0
    tree = ast.parse((ROOT / "benchmarks" / "loop_match_scale.py").read_text())
    section4 = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                    and ast.unparse(n.targets[0]) == "out[f'direct_index_vs_full_{M}']")
    for k in rows:
        assert list(got[k]) == [key.value for key in section4.keys]
        assert got[k]["n_map_points"] == int(k.rsplit("_", 1)[1])
