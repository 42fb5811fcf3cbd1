"""The distributed solvers of the port (`monocular_slam_tpu_torch/parallel/*`)
against the reference's (`monocular_slam_tpu/parallel/*`, on the conftest's 8
virtual devices) and against the port's own single-device routes.

The port's side runs on gloo ranks on the CPU: one world of 4 spawned for
this module (`port_util.spawn_world`), which runs every case once, on meshes
of 1, 2 and 4 ranks and on a (data 2, model 2) mesh. Inputs are the
reference tests' problems in float64 (the suite runs JAX with x64 on), the
same arrays on both sides. Tolerances are those of the reference's
`tests/test_sharded_ba.py`, `test_pose_graph_cg.py`, `test_golden_ba.py` and
`test_comm_volume.py`, stated in each test.
"""

import jax
import numpy as np
import pytest
import torch

from monocular_slam_tpu.optim import ba as jba
from monocular_slam_tpu.parallel import mesh as jmesh
from monocular_slam_tpu.parallel import sharded_ba as jsba
from monocular_slam_tpu.parallel import sharded_pose_graph as jspg
from monocular_slam_tpu_torch.optim import ba as tba
from monocular_slam_tpu_torch.optim import cg_ba as tcg
from monocular_slam_tpu_torch.optim import pose_graph as tpg
from monocular_slam_tpu_torch.parallel import sharded_ba as tsba
from monocular_slam_tpu_torch.parallel import sharded_pose_graph as tspg

from port_util import _port_graph, _port_problem, ba_problem_numpy, spawn_world
from port_util import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = "tests/fixtures/ba_problem.npz"
GOLDEN_EXPECTED = "tests/fixtures/ba_expected.npz"


@pytest.fixture(scope="module")
def inputs():
    from tests.test_ba import build_problem, make_scene
    from tests.test_cg_ba import make_problem
    from tests.test_comm_volume import _make_problem as comm_problem
    from tests.test_pose_graph_cg import loop_graph, make_drifted_loop

    poses, X, uv = make_scene(jax.random.PRNGKey(30), n_frames=8, n_points=200)
    problem = build_problem(poses, X, uv, 0.02, 0.05, jax.random.PRNGKey(31), pix_noise=0.3)
    sparse = make_problem(jax.random.PRNGKey(40), n_frames=16, n_points=600, vis=0.25)
    gt, est = make_drifted_loop()
    graph = loop_graph(gt, est)
    with np.load(GOLDEN) as d:
        golden = {f: d[f] for f in d.files}
    return {"problem": ba_problem_numpy(problem), "sparse": ba_problem_numpy(sparse),
            "golden": golden, "comm": ba_problem_numpy(comm_problem()),
            "graph": {f: np.array(getattr(graph, f)) for f in graph._fields[:7]},
            "jax": {"problem": problem, "graph": graph}}


@pytest.fixture(scope="module")
def world(inputs):
    """Every case on 4 gloo ranks, spawned once."""
    data = {k: v for k, v in inputs.items() if k != "jax"}
    return spawn_world(4, "parallel_cases", data)


@pytest.fixture(scope="module")
def reference(inputs):
    """The reference's sharded solvers on meshes of 2 and 4 of the 8 devices."""
    prob, graph = inputs["jax"]["problem"], inputs["jax"]["graph"]
    out = {}
    for n in (2, 4):  # auto: dense on 2 shards, cg on 4
        r = jsba.distributed_bundle_adjust(prob, jmesh.make_mesh(n), n_iters=10)
        out[f"auto{n}"] = {f: np.asarray(getattr(r, f)) for f in r._fields}
    r = jspg.distributed_optimize(graph, jmesh.make_mesh(2), n_iters=20, max_cg_iters=300,
                                  rtol=1e-13)
    out["pg2"] = {f: np.asarray(getattr(r, f)) for f in r._fields}
    return out


def _problem(inputs, name="problem"):
    return _port_problem(inputs[name])


# --- partitioning -----------------------------------------------------------------------

def test_partition_problem_matches_reference(inputs):
    """Same padding and the same edge layout per shard as the reference's,
    exactly, for 4 shards, on a problem with invalid edges."""
    sparse = inputs["sparse"]
    jp, jP = jsba.partition_problem(jba.BAProblem(**{f: jax.numpy.asarray(v)
                                                     for f, v in sparse.items()}), 4)
    tp, tP = tsba.partition_problem(_problem(inputs, "sparse"), 4)
    assert tP == jP
    for f in tba.BAProblem._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)
    slab = tp.points.shape[0] // 4
    e_max = tp.valid.shape[0] // 4
    owner = tp.pt_idx.numpy() // slab
    shard = np.arange(owner.shape[0]) // e_max
    v = tp.valid.numpy()
    assert int(v.sum()) == int(sparse["valid"].sum()) and (owner[v] == shard[v]).all()


def test_partition_edges_matches_reference(inputs):
    """The padded graph equals the reference's, and its padding edges carry
    the identity Sim3, so their residuals are finite."""
    jg = inputs["jax"]["graph"]
    jgp = jspg.partition_edges(jg, 4)
    tgp = tspg.partition_edges(_port_graph(inputs["graph"]), 4)
    for f in ("vertices", "i_idx", "j_idx", "meas", "weight", "valid", "fixed"):
        np.testing.assert_array_equal(getattr(tgp, f).numpy(), np.asarray(getattr(jgp, f)), err_msg=f)
    assert tgp.i_idx.shape[0] % 4 == 0 and int(tgp.valid.sum()) == int(np.asarray(jg.valid).sum())
    r = tpg.edge_residual(tgp.vertices[tgp.i_idx.long()], tgp.vertices[tgp.j_idx.long()], tgp.meas)
    assert bool(torch.isfinite(r).all())


# --- sharded BA -------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_matches_single_device(world, reference, inputs, n):
    """auto (dense on 2 ranks, CG on 4), 10 LM iterations: the port's single
    device `bundle_adjust` and the reference's sharded run on as many
    devices, final chi2 to rtol 1e-6, poses to 1e-6, points to 1e-5."""
    res = world[0][f"auto{n}"]
    single = tba.bundle_adjust(_problem(inputs), n_iters=10)
    for other in ({"chi2_history": single.chi2_history.numpy(), "poses": single.poses.numpy(),
                   "points": single.points.numpy()}, reference[f"auto{n}"]):
        np.testing.assert_allclose(res["chi2_history"][-1], other["chi2_history"][-1], rtol=1e-6)
        np.testing.assert_allclose(res["poses"], other["poses"], atol=1e-6)
        np.testing.assert_allclose(res["points"], other["points"], atol=1e-5)


def test_converges(world, inputs):
    """The 4-rank run ends below 5% of its initial chi2 (the reference's
    test_converges at 10 iterations here)."""
    res = world[0]["auto4"]
    assert res["chi2_history"][-1] < 0.05 * res["chi2_initial"]


def test_cg_matches_single_device_cg(world, inputs):
    """solver="cg" with 300 PCG steps to rtol 1e-13 on 4 ranks against the
    port's `bundle_adjust_cg`: chi2 histories to rtol 1e-6, poses to 1e-6."""
    res = world[0]["cg4_tight"]
    single = tcg.bundle_adjust_cg(_problem(inputs), n_iters=10, max_cg_iters=300, rtol=1e-13)
    np.testing.assert_allclose(res["chi2_history"], single.chi2_history.numpy(), rtol=1e-6)
    np.testing.assert_allclose(res["poses"], single.poses.numpy(), atol=1e-6)


def test_cg_matches_sharded_dense(world):
    """The sharded CG and dense routes on 4 ranks: final chi2 to rtol 1e-6,
    poses to 1e-5."""
    cg, dense = world[0]["cg4_tight"], world[0]["dense4"]
    np.testing.assert_allclose(cg["chi2_history"][-1], dense["chi2_history"][-1], rtol=1e-6)
    np.testing.assert_allclose(cg["poses"], dense["poses"], atol=1e-5)


def test_various_shard_counts(world):
    """1, 2 and 4 ranks (dense, dense, CG): final chi2 agree to rtol 1e-6."""
    finals = [world[0][f"shards{n}"]["chi2_history"][-1] for n in (1, 2, 4)]
    np.testing.assert_allclose(finals, finals[0], rtol=1e-6)


def test_2d_mesh_with_data_axis(world):
    """A (data 2, model 2) mesh: finite poses; both data rows give the same
    result."""
    rows = [world[r]["mesh22"] for r in range(4)]
    assert all(np.isfinite(r["poses"]).all() for r in rows)
    np.testing.assert_array_equal(rows[0]["poses"], rows[2]["poses"])


def test_converges_sparse_visibility(world):
    """The reference's sparse-visibility problem (25% of edges valid), 40 LM
    iterations of 60 PCG steps on 4 ranks: below 0.3x its initial chi2."""
    res = world[0]["sparse4"]
    assert res["chi2_history"][-1] < 0.3 * res["chi2_initial"]
    assert np.isfinite(res["poses"]).all()


def test_every_rank_holds_the_same_result(world):
    """Replicated results are bit-identical on every rank of a mesh."""
    members = {"auto2": 2, "auto4": 4, "dense4": 4, "cg4_tight": 4, "shards2": 2,
               "shards4": 4, "sparse4": 4, "golden4": 4, "pg2": 2}
    for case, n in members.items():
        for r in range(1, n):
            for f, a in world[0][case].items():
                np.testing.assert_array_equal(world[r][case][f], a, err_msg=f"{case} {f} rank {r}")


# --- golden fixture ---------------------------------------------------------------------

def test_golden_regression():
    """The port's `load_ba_problem(device="cpu")` and `bundle_adjust(n_iters=15)`
    on the golden fixture (float64) against its expected output, with
    `tests/test_golden_ba.py`'s bounds: pose and point L2 < 1e-4, final chi2
    to rtol 1e-6, initial chi2 to rtol 1e-9."""
    from monocular_slam_tpu_torch.io import snapshot

    prob = snapshot.load_ba_problem(GOLDEN, device="cpu")
    assert prob.poses.dtype == torch.float64 and prob.poses.device.type == "cpu"
    exp = np.load(GOLDEN_EXPECTED)
    res = tba.bundle_adjust(prob, n_iters=15)
    pose_diff = np.linalg.norm((res.poses.numpy() - exp["poses"]).reshape(len(exp["poses"]), -1),
                               axis=1)
    point_diff = np.linalg.norm(res.points.numpy() - exp["points"], axis=1)
    assert pose_diff.max() < 1e-4, pose_diff.max()
    assert point_diff.max() < 1e-4, point_diff.max()
    np.testing.assert_allclose(float(res.chi2_history[-1]), float(exp["chi2_final"]), rtol=1e-6)
    np.testing.assert_allclose(float(res.chi2_initial), float(exp["chi2_initial"]), rtol=1e-9)


def test_sharded_matches_golden(world):
    """The golden fixture on 4 ranks (auto: CG): poses within 1e-5."""
    exp = np.load(GOLDEN_EXPECTED)
    assert np.abs(world[0]["golden4"]["poses"] - exp["poses"]).max() < 1e-5


# --- sharded pose graph -----------------------------------------------------------------

def test_distributed_optimize_matches(world, reference, inputs):
    """The reference's drifted loop of 30 Sim3 vertices, 20 LM iterations of
    300 PCG steps to rtol 1e-13 on 2 ranks, against the reference's on 2
    devices and the port's `optimize_cg`: chi2 histories to rtol 1e-5,
    vertices to 1e-5 (the reference's test_matches_single_device)."""
    res = world[0]["pg2"]
    single = tpg.optimize_cg(_port_graph(inputs["graph"]), n_iters=20, max_cg_iters=300, rtol=1e-13)
    for other in ({"chi2_history": single.chi2_history.numpy(),
                   "vertices": single.vertices.numpy()}, reference["pg2"]):
        np.testing.assert_allclose(res["chi2_history"], other["chi2_history"], rtol=1e-5)
        np.testing.assert_allclose(res["vertices"], other["vertices"], atol=1e-5)
    assert res["chi2_history"][-1] < res["chi2_initial"]


# --- communication contract -------------------------------------------------------------

F_COMM, P_COMM = 32, 4096  # tests/test_comm_volume.py's shape, 256 observations per camera


@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_collective_sizes(world, solver):
    """Every collective of the LM program (2 iterations, 8 PCG steps), as
    counted by `distributed.record_collectives` on each of the 4 ranks: CG,
    each <= 100 F elements and below P and (6F)^2; dense, one of (6F)^2
    (the detector sees the cross term, so the CG bound is not vacuous)."""
    for r in range(4):
        sizes = [c["elements"] for c in world[r][f"comm_{solver}"]]
        assert sizes and sizes == [c["elements"] for c in world[0][f"comm_{solver}"]]
        if solver == "cg":
            assert max(sizes) <= 100 * F_COMM, sizes
            assert max(sizes) < min(P_COMM, (6 * F_COMM) ** 2)
        else:
            assert max(sizes) >= (6 * F_COMM) ** 2


def test_final_gather_counted_apart(world):
    """`distributed_bundle_adjust` issues the LM program's collectives, then
    one all-reduce of the zero-filled (P_pad, 3) points labelled "gather"
    (O(P), outside the LM loop and its contract)."""
    full, loop = world[0]["comm_full"], world[0]["comm_cg"]
    assert [c["label"] for c in full] == ["solve"] * len(loop) + ["gather"]
    assert [c["elements"] for c in full[:-1]] == [c["elements"] for c in loop]
    assert full[-1]["elements"] == P_COMM * 3


def test_put_global_takes_each_rank_its_slab(world):
    """Every rank holds the full array and slices its part: rows by model
    rank on a (1, 4) mesh, columns on the (2, 2) mesh (the reference's
    PartitionSpec(None, "model") with a data axis), all of it replicated."""
    x = np.arange(48).reshape(8, 6)
    for r in range(4):
        got = world[r]["placement"]
        np.testing.assert_array_equal(got["model4"], x[2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["model22"], x[:, 3 * (r % 2):3 * (r % 2) + 3])
        np.testing.assert_array_equal(got["replicated"], x)
