"""The port's distributed drivers (`monocular_slam_tpu_torch/benchmarks/
{scaling,multihost}.py`, `graft_entry.dryrun_multichip`) on the CPU at
small sizes, against the JAX package (never the JAX drivers' `main()`s):

  - scaling's and multihost's problems equal the reference drivers' arrays
    built from the same keys (float32 to 1e-6 of each array's largest
    value: the projections round differently by a few ulps; indices
    exactly; the reference with x64 off, as its drivers run);
  - scaling's dense and CG chi2 histories at 1 and 2 gloo ranks match
    `monocular_slam_tpu.parallel.sharded_ba.distributed_bundle_adjust` on
    the conftest's virtual CPU devices to rtol 1e-4, and each PCG step
    all-reduces `cg_comm_bytes_per_iter(F)` = 4 * 6 * F bytes
    (`distributed.record_collectives`);
  - multihost's two processes (`initialize()` from the MSLAM_* variables)
    report the reference driver's keys, chi2 down, equal reports, chi2
    within rtol 1e-4 of the reference's solve of its problem;
  - scaling writes the reference driver's keys (its AST) and
    `dryrun_multichip(2)` passes on two gloo ranks.

Sizes: F = 8 cameras, P = 300 points, 100 observations a camera, 5 LM
iterations."""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monocular_slam_tpu.geometry import camera, se3, so3
from monocular_slam_tpu.optim import ba as jba
from monocular_slam_tpu.parallel import mesh as jmesh
from monocular_slam_tpu.parallel import sharded_ba as jsharded
from monocular_slam_tpu_torch import graft_entry
from monocular_slam_tpu_torch.benchmarks import multihost, scaling
from port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
F, P, OBS, ITERS = 8, 300, 100, 5


def _poses(dx):
    return jnp.stack([se3.from_Rt(so3.exp(jnp.array([0.0, 0.02 * i, 0.0])),
                                  jnp.array([-dx * i, 0.0, 0.0])) for i in range(F)])


def _scaling_reference():
    """`benchmarks/scaling.py`'s problem (its code, at these sizes)."""
    key = jax.random.PRNGKey(0)
    X = jax.random.uniform(key, (P, 3), minval=-10, maxval=10) + jnp.array([0, 0, 20.0])
    k = jnp.array([500.0, 500.0, 320.0, 240.0])
    poses = _poses(0.3)
    pt_idx = jax.random.randint(jax.random.PRNGKey(1), (F * OBS,), 0, P)
    cam_idx = jnp.repeat(jnp.arange(F, dtype=jnp.int32), OBS)
    uv = camera.project(k, se3.apply(poses[cam_idx], X[pt_idx]))
    uv = uv + 0.5 * jax.random.normal(jax.random.PRNGKey(2), uv.shape)
    poses0 = se3.compose(
        se3.exp(0.005 * jax.random.normal(jax.random.PRNGKey(3), (F, 6))), poses
    ).at[0].set(poses[0])
    return jba.BAProblem(
        poses=poses0.astype(jnp.float32),
        points=(X + 0.05 * jax.random.normal(jax.random.PRNGKey(4), X.shape)).astype(jnp.float32),
        k=jnp.broadcast_to(k, (F, 4)).astype(jnp.float32), cam_idx=cam_idx, pt_idx=pt_idx,
        uv=uv.astype(jnp.float32), info=jnp.ones(F * OBS, jnp.float32),
        valid=jnp.ones(F * OBS, bool), fixed=jnp.zeros(F, bool).at[0].set(True))


def _multihost_reference():
    """`benchmarks/multihost.py`'s child problem (its code, at these sizes)."""
    kx, kn, kp = jax.random.split(jax.random.PRNGKey(0), 3)
    X = jax.random.uniform(kx, (P, 3), minval=-10, maxval=10) + jnp.array([0, 0, 20.0])
    k = jnp.array([500.0, 500.0, 320.0, 240.0])
    poses = _poses(0.2)
    cam_idx = jnp.repeat(jnp.arange(F, dtype=jnp.int32), OBS)
    pt_idx = jax.random.randint(kp, (F * OBS,), 0, P, dtype=jnp.int32)
    uv = camera.project(k, se3.apply(poses[cam_idx], X[pt_idx])) + 0.5 * jax.random.normal(
        kn, (F * OBS, 2))
    return jba.BAProblem(
        poses=se3.compose(se3.exp(0.01 * jax.random.normal(kn, (F, 6))), poses),
        points=X + 0.05 * jax.random.normal(kx, X.shape), k=jnp.broadcast_to(k, (F, 4)),
        cam_idx=cam_idx, pt_idx=pt_idx, uv=uv, info=jnp.ones(F * OBS),
        valid=jnp.ones(F * OBS, bool), fixed=jnp.zeros(F, bool).at[0].set(True))


def _assert_problem(port, ref):
    for f in ref._fields:
        got, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert got.shape == want.shape, f
        if want.dtype.kind == "f":  # to 1e-6 of the array's largest value
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f)


@pytest.mark.parametrize("which", ["scaling", "multihost"])
def test_problem_is_the_reference_drivers(which):
    with jax.enable_x64(False):
        ref = _scaling_reference() if which == "scaling" else _multihost_reference()
    port = (scaling if which == "scaling" else multihost).ba_problem(F, P, OBS, "cpu")
    _assert_problem(port, ref)


@pytest.fixture(scope="module")
def scaling_run():
    det = {}
    out = scaling.run(F, P, OBS, ITERS, shards=(1, 2), device="cpu", n_rep=1, details=det)
    return out, det


@pytest.fixture(scope="module")
def reference_histories():
    out = {}
    with jax.enable_x64(False):
        prob = _scaling_reference()
        for s in (1, 2):
            for solver in scaling.SOLVERS:
                r = jsharded.distributed_bundle_adjust(prob, jmesh.make_mesh(s), n_iters=ITERS,
                                                       solver=solver)
                out[s, solver] = (float(r.chi2_initial), np.asarray(r.chi2_history))
    return out


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("solver", scaling.SOLVERS)
def test_scaling_chi2_histories_match_reference(scaling_run, reference_histories, shards, solver):
    _, det = scaling_run
    c0, hist = reference_histories[shards, solver]
    for rank in det[shards]:
        r = rank[solver]
        np.testing.assert_allclose(r["chi2_initial"], c0, rtol=1e-4)
        np.testing.assert_allclose(r["chi2_history"], hist, rtol=1e-4)
        assert r["chi2_history"][-1] < r["chi2_initial"]


@pytest.mark.parametrize("shards", [1, 2])
def test_scaling_bytes_a_pcg_step(scaling_run, shards):
    _, det = scaling_run
    for rank in det[shards]:
        got = scaling.pcg_bytes(rank["cg"]["collectives"], F)
        assert got and set(got) == {scaling.cg_comm_bytes_per_iter(F)} == {4 * 6 * F}


def test_scaling_writes_the_reference_keys(scaling_run):
    out, _ = scaling_run
    tree = ast.parse((ROOT / "benchmarks" / "scaling.py").read_text())
    want = next(node.value for node in ast.walk(tree) if isinstance(node, ast.Assign)
                and ast.unparse(node.targets[0]) == "out" and isinstance(node.value, ast.Dict))
    assert list(out) == [k.value for k in want.keys]
    comm = next(v for k, v in zip(want.keys, want.values) if k.value == "cg_comm_model")
    assert list(out["cg_comm_model"]) == [k.value for k in comm.keys]
    assert out["cg_comm_model"]["bytes_per_cg_iter_per_direction"] == 4 * 6 * F
    assert list(out["results"]) == ["dense", "cg"]
    assert all(list(r) == ["1", "2"] and all(v > 0 for v in r.values())
               for r in out["results"].values())


def test_multihost_two_processes_like_reference():
    out = multihost.run(2, F, P, OBS, ITERS, device="cpu", timeout=240)
    assert out["ok"] and len(out["reports"]) == 2
    want = json.loads((ROOT / "benchmarks" / "multihost_r04.json").read_text())
    assert list(out) == list(want)
    a, b = out["reports"]
    assert [a["process_id"], b["process_id"]] == [0, 1]
    for r, w in ((a, want["reports"][0]), (b, want["reports"][1])):
        assert list(r) == list(w)
        assert r["process_count"] == 2 and r["mesh_model"] == 2 and r["multi"] is True
        for solver in ("dense", "cg"):
            assert list(r[solver]) == list(w[solver])
            assert r[solver]["chi2_final"] < r[solver]["chi2_initial"]
    with jax.enable_x64(False):
        prob = _multihost_reference()
        for solver in ("dense", "cg"):
            ref = jsharded.distributed_bundle_adjust(prob, jmesh.make_mesh(2), n_iters=ITERS,
                                                     solver=solver)
            for r in (a, b):
                np.testing.assert_allclose(r[solver]["chi2_initial"], float(ref.chi2_initial),
                                           rtol=1e-4)
                np.testing.assert_allclose(r[solver]["chi2_final"],
                                           float(ref.chi2_history[-1]), rtol=1e-4)
            assert (a[solver]["chi2_initial"], a[solver]["chi2_final"]) == (
                b[solver]["chi2_initial"], b[solver]["chi2_final"])


def test_dryrun_multichip_on_two_gloo_ranks():
    ranks = graft_entry.dryrun_multichip(2, "cpu")
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["backend"] == "gloo" and r["mesh"] == [1, 2]
        assert np.isfinite(r["chi2_history"]).all()
        assert r["chi2_history"][-1] <= r["chi2_initial"]
    np.testing.assert_array_equal(ranks[0]["poses"], ranks[1]["poses"])
