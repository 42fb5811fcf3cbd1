"""`ops/pose_gn` (motion-only BA's Gauss-Newton route as one kernel) on the
CPU: its launch counter, the wrapper's input checks and the route of
`pose_ba.refine_pose` (CPU tensors run the plain route, bit for bit). The
kernel itself runs only on a card: `tests/test_torch_cuda.py` holds it to
the plain route there."""

import pytest
import torch

import chip_smoke
from monocular_slam_tpu_torch.ops import launches, pose_gn
from monocular_slam_tpu_torch.optim import pose_ba
from port_util import one_torch_thread  # noqa: F401 (autouse)


def _problem(batch=1, n=300, seed=0):
    T0, X, uv, k, w = chip_smoke.pose_gn_problem(batch, n, seed=seed, device="cpu")
    return (T0[0], X[0], uv[0], k, w[0]) if batch == 1 else (T0, X, uv, k, w)


def test_pose_gn_has_a_launch_counter():
    assert "pose_gn" in launches.KERNELS
    assert len(set(launches.KERNELS)) == len(launches.KERNELS)


def _bad(case):
    T0, X, uv, k, w = _problem()
    if case == "n_mismatch":
        uv = uv[:-1]
    elif case == "pose_3x3":
        T0 = T0[:, :3].contiguous()
    elif case == "float64":
        X = X.double()
    elif case == "noncontiguous":
        X = torch.cat([X, X], -1)[:, ::2]
    elif case == "batch_mismatch":
        T0 = T0.expand(2, 3, 4).contiguous()
    elif case == "k_shape":
        k = k[:3]
    elif case == "too_many_edges":
        n = pose_gn.MAX_N + 1
        X, uv, w = (x[:1].expand(n, *x.shape[1:]).contiguous() for x in (X, uv, w))
    return T0, X, uv, k, w


@pytest.mark.parametrize("case", ["n_mismatch", "pose_3x3", "float64", "noncontiguous",
                                  "batch_mismatch", "k_shape", "too_many_edges", "cpu"])
def test_pose_gn_rejects_bad_input(case):
    """Every input the kernel does not take raises ValueError before a
    launch; on a machine with no card the same holds for CPU tensors."""
    args = _bad(case)
    with pytest.raises(ValueError):
        pose_gn.refine_pose(*args, n_iters=10, n_rounds=3, chi2_gate=5.991, tau=1e-5,
                            min_points=3, huber_delta=pose_ba.THRESH_HUBER)


@pytest.mark.parametrize("opts", [dict(n_rounds=2), dict(n_rounds=3),
                                  dict(n_rounds=3, chi2_gate=3.0, tau=1e-3, min_points=20)])
def test_cpu_route_is_the_plain_route(monkeypatch, opts):
    """CPU tensors through `refine_pose(solver="gn")` give the plain route's
    result bit for bit, and never reach the kernel's wrapper."""
    def refused(*a, **kw):
        raise AssertionError("the CPU route reached ops.pose_gn")

    monkeypatch.setattr(pose_gn, "refine_pose", refused)
    args = _problem(batch=2, seed=3)
    a = pose_ba.refine_pose(*args, solver="gn", **opts)
    b = pose_ba.refine_pose_plain(*args, solver="gn", **opts)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
