"""The port's deterministic float segment sums (`utils/scatter.segment_sum`
on a sorted `Segments` plan) against the route they replace, float
`index_add_` / `index_put_(accumulate=True)`, on the CPU. The CPU's
`index_add_` adds in index order, one value after another, and so does the
plan, so the two agree bit for bit; on the card only the plan repeats run to
run (`tests/test_torch_cuda.py` checks that there). Also: the solvers'
`reduce` hook, and the snapshot loaders' card default."""

import numpy as np
import pytest
import torch

from monocular_slam_tpu_torch.optim import ba as tba
from monocular_slam_tpu_torch.optim import cg_ba as tcg
from monocular_slam_tpu_torch.optim import lm as tlm
from monocular_slam_tpu_torch.optim import pose_graph as tpg
from monocular_slam_tpu_torch.utils import scatter

from port_util import one_torch_thread  # noqa: F401 (autouse)


def _old_segment_sum(vals, seg, num):
    """The route before the plans: a float `index_add_` into a dump row."""
    seg = seg.long()
    safe = torch.where((seg >= 0) & (seg < num), seg, num)
    out = torch.zeros((num + 1,) + tuple(vals.shape[1:]), dtype=vals.dtype)
    out.index_add_(0, safe, vals)
    return out[:num]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("inner", [(), (6,), (6, 6)])
def test_segment_sum_equals_index_add(dtype, inner):
    """Bit-identical to the old route, with duplicate, dropped (-1 and num)
    and empty segments; one plan reused for two value arrays; a plan that
    also drops the rows outside `keep`, whose values are zero."""
    rng = np.random.RandomState(len(inner))
    num, E = 37, 5000
    seg = torch.as_tensor(rng.randint(-2, num + 2, E))
    seg[seg == 5] = 6  # segment 5 stays empty
    plan = scatter.segments(seg, num)
    for _ in range(2):
        vals = torch.as_tensor(rng.randn(E, *inner) * 10.0 ** rng.uniform(-3, 3, (E,) + (1,) * len(inner)),
                               dtype=dtype)
        new = scatter.segment_sum(vals, plan)
        assert torch.equal(new, _old_segment_sum(vals, seg, num))
        assert torch.equal(new, scatter.segment_sum(vals, seg, num))
        assert new.shape == (num,) + inner and not new[5].any()
        # a plan that drops rows whose values are zero gives the same bits
        keep = torch.as_tensor(rng.rand(E) > 0.3)
        zeroed = torch.where(keep.reshape((E,) + (1,) * len(inner)), vals, 0.0)
        assert torch.equal(scatter.segment_sum(zeroed, scatter.segments(seg, num, keep)),
                           _old_segment_sum(zeroed, seg, num))


def test_segment_sum_edge_cases():
    """No values; integers (exact, through `index_add_`)."""
    out = scatter.segment_sum(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.long), 4)
    assert out.shape == (4, 3) and not out.any()
    ids = torch.tensor([0, 2, 2, 9, -1])
    assert scatter.segment_sum(torch.ones(5, dtype=torch.int32), ids, 3).tolist() == [1, 0, 2]


def _ba_problem(seed=0, F=5, P=30, E=400, dtype=torch.float64):
    """A random BA problem with duplicate (camera, point) edges."""
    from port_util import random_poses

    rng = np.random.RandomState(seed)
    poses = torch.as_tensor(random_poses(rng, F, rot=0.1, trans=0.3), dtype=dtype)
    X = torch.as_tensor(rng.uniform(-1, 1, (P, 3)) + [0, 0, 5], dtype=dtype)
    cam = torch.as_tensor(rng.randint(0, F, E))
    pt = torch.as_tensor(rng.randint(0, P, E))
    k = torch.tensor([[300.0, 300.0, 160.0, 120.0]], dtype=dtype).repeat(F, 1)
    from monocular_slam_tpu_torch.geometry import camera, se3

    uv = camera.project(k[cam], se3.apply(poses[cam], X[pt])) + torch.as_tensor(rng.randn(E, 2),
                                                                              dtype=dtype)
    fixed = torch.zeros(F, dtype=torch.bool)
    fixed[0] = True
    return tba.BAProblem(poses, X + 0.05, k, cam, pt, uv, torch.ones(E, dtype=dtype),
                         torch.as_tensor(rng.rand(E) > 0.1), fixed)


def test_dense_cross_term_equals_index_put():
    """`ba.scatter_pose_point` (one plan over the (camera, point) pairs)
    against the old `index_put_(accumulate=True)`, with duplicate pairs:
    bit-identical; the Schur matvec the same with the linearization's plans
    and with plans made afresh."""
    prob = _ba_problem()
    lin = tba._linearize_graph(prob, prob.poses, prob.points, tba.THRESH_HUBER_FULL_BA)
    F, P = prob.poses.shape[0], prob.points.shape[0]
    cam, pt = prob.cam_idx.long(), prob.pt_idx.long()
    old = torch.zeros((F, P, 6, 3), dtype=torch.float64)
    old.index_put_((cam, pt), lin["W_e"], accumulate=True)
    assert torch.equal(tba.scatter_pose_point(prob, lin["W_e"])[0],
                       old.permute(0, 2, 1, 3).reshape(F * 6, P * 3))
    # the linearization's block sums through its plans equal the old route's
    from monocular_slam_tpu_torch.optim import residuals

    r, Jp, Jl = residuals.linearize(prob.poses[cam], prob.points[pt], prob.k[cam], prob.uv)
    w, _ = tba._edge_weights(prob, r, tba.THRESH_HUBER_FULL_BA)
    rw = (r * w[:, None])[..., None]
    wJp = Jp * w[:, None, None]
    assert torch.equal(lin["Hpp"], _old_segment_sum(
        (wJp[..., :, None] * Jp[..., None, :]).sum(-3), cam, F))
    assert torch.equal(lin["bl"], _old_segment_sum(-(Jl * rw).sum(-2), pt, P))


def _loop_graph(n=12, seed=2):
    from monocular_slam_tpu_torch.geometry import sim3

    rng = np.random.RandomState(seed)
    verts = sim3.exp(torch.as_tensor(0.3 * rng.randn(n, 7)))
    meas = sim3.exp(torch.as_tensor(0.1 * rng.randn(3, 7)))
    return tpg.sequential_graph(verts, torch.ones(n, dtype=torch.bool), extra_i=[n - 1, 5, 7],
                                extra_j=[0, 1, 1], extra_meas=meas)


def test_pose_graph_sums_equal_old_route():
    """The dense H and b of `_linearize`, and the block b, D and matvec of
    the matrix-free path, against the old `index_put_` / `index_add_` sums:
    bit-identical."""
    g = _loop_graph()
    F = g.vertices.shape[0]
    ii, jj = g.i_idx.long(), g.j_idx.long()
    H, b, _ = tpg._linearize(g, g.vertices, huber_delta=1.0)
    Ji, Jj = tpg.edge_jacobians(g.vertices[ii], g.vertices[jj], g.meas)
    r = tpg.edge_residual(g.vertices[ii], g.vertices[jj], g.meas)
    w, _ = tpg._edge_weights(g, r, 1.0)
    Hold = torch.zeros((F, F, 7, 7), dtype=torch.float64)
    Hij = torch.einsum("eai,eaj,e->eij", Ji, Jj, w)
    Hold.index_put_((ii, ii), torch.einsum("eai,eaj,e->eij", Ji, Ji, w), accumulate=True)
    Hold.index_put_((jj, jj), torch.einsum("eai,eaj,e->eij", Jj, Jj, w), accumulate=True)
    Hold.index_put_((ii, jj), Hij, accumulate=True)
    Hold.index_put_((jj, ii), Hij.transpose(-1, -2), accumulate=True)
    bold = torch.zeros((F, 7), dtype=torch.float64)
    bold.index_add_(0, ii, -torch.einsum("eai,ea,e->ei", Ji, r, w))
    bold.index_add_(0, jj, -torch.einsum("eai,ea,e->ei", Jj, r, w))
    assert torch.equal(H, Hold.permute(0, 2, 1, 3)) and torch.equal(b, bold)

    lin = tpg._linearize_blocks(g, g.vertices, 1.0)
    Dold = torch.zeros((F, 7, 7), dtype=torch.float64)
    Dold.index_add_(0, ii, torch.einsum("eai,eaj,e->eij", Ji, Ji, w))
    Dold.index_add_(0, jj, torch.einsum("eai,eaj,e->eij", Jj, Jj, w))
    assert torch.equal(lin["b"], bold) and torch.equal(lin["D"], Dold)
    x = torch.as_tensor(np.random.RandomState(3).randn(F, 7))
    free = ~g.fixed
    lam = torch.tensor(1e-3, dtype=torch.float64)
    xf = torch.where(free[:, None], x, 0.0)
    ge = lin["w"][:, None] * (torch.einsum("eai,ei->ea", lin["Ji"], xf[ii])
                              + torch.einsum("eai,ei->ea", lin["Jj"], xf[jj]))
    yold = torch.zeros_like(x)
    yold.index_add_(0, ii, torch.einsum("eai,ea->ei", lin["Ji"], ge))
    yold.index_add_(0, jj, torch.einsum("eai,ea->ei", lin["Jj"], ge))
    yold = torch.where(free[:, None], yold + lam * xf, 0.0) + torch.where(free[:, None], 0.0, x)
    assert torch.equal(tpg._hessian_matvec(g, lin, lam, free, x), yold)


def test_solvers_repeat_bit_for_bit():
    """Two runs of the CG BA and of the CG pose graph give the same bits."""
    prob = _ba_problem(seed=4, dtype=torch.float32)
    a, b = (tcg.bundle_adjust_cg(prob, n_iters=4, max_cg_iters=20) for _ in range(2))
    assert torch.equal(a.poses, b.poses) and torch.equal(a.points, b.points)
    g = _loop_graph()
    a, b = (tpg.optimize_cg(g, n_iters=4, max_cg_iters=20) for _ in range(2))
    assert torch.equal(a.vertices, b.vertices)


@pytest.mark.parametrize("loader", ["load_state", "load_ba_problem"])
def test_snapshot_loaders_default_to_the_card(tmp_path, loader):
    """Without `device` the snapshot loaders put the arrays on the card;
    without one they raise instead of falling back to the CPU."""
    from monocular_slam_tpu_torch.io import snapshot

    path = str(tmp_path / "s.npz")
    if loader == "load_ba_problem":
        snapshot.save_ba_problem(path, _ba_problem())
    else:
        from monocular_slam_tpu_torch.slam.config import SlamConfig
        from monocular_slam_tpu_torch.slam.state import empty_state

        snapshot.save_state(path, empty_state(SlamConfig(max_frames=4, max_points=50), device="cpu"))
    fn = getattr(snapshot, loader)
    assert fn(path, device="cpu")[0].device.type == "cpu"
    if torch.cuda.is_available():
        assert fn(path)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            fn(path)


def _counting_reduce(calls):
    """An identity `reduce` that records the shapes of every call."""

    def reduce(*tensors, op="sum"):
        calls.append([tuple(t.shape) for t in tensors])
        return tlm.no_reduce(*tensors, op=op)

    return reduce


@pytest.mark.parametrize("route", ["schur_dense", "schur_cg", "pose_graph_cg"])
def test_solves_reduce_hook(route):
    """The single-device solves with an identity `reduce` that records its
    calls (the distributed solvers pass an all-reduce over their group
    there): the same bits as without one, and the sums the sharded routes
    exchange, one (F, 6) or (F, 7) vector per PCG step."""
    calls = []
    red = _counting_reduce(calls)
    if route == "pose_graph_cg":
        g = _loop_graph()
        F = g.vertices.shape[0]
        a = tpg.optimize_cg(g, n_iters=3, max_cg_iters=20)
        b = tpg.optimize_cg(g, n_iters=3, max_cg_iters=20, reduce=red)
        assert torch.equal(a.vertices, b.vertices) and torch.equal(a.chi2_history, b.chi2_history)
        # each linearization sums chi2, b and D in one call; each LM
        # iteration adds 20 PCG steps and the candidate's chi2
        assert calls[0] == [(), (F, 7), (F, 7, 7)]
        assert len(calls) == 1 + 3 * (1 + 20 + 1)
        assert calls.count([(F, 7)]) == 3 * 20 and calls.count([()]) == 3
        return
    prob = _ba_problem()
    F = prob.poses.shape[0]
    lin = tba._linearize_graph(prob, prob.poses, prob.points, tba.THRESH_HUBER_FULL_BA)
    lam = torch.tensor(1e-3, dtype=torch.float64)
    if route == "schur_dense":
        a = tba._schur_solve(prob, lin, lam)
        b = tba._schur_solve(prob, lin, lam, reduce=red)
        assert calls == [[(F, 6)], [(6 * F, 6 * F)]]
    else:
        a = tcg.make_cg_solve_fn(30)(prob, lin, lam)
        b = tcg.make_cg_solve_fn(30, reduce=red)(prob, lin, lam)
        assert calls[:2] == [[(F, 6)], [(F, 6, 6)]] and calls[2:] == [[(F, 6)]] * 30
    assert all(torch.equal(x, y) for x, y in zip(a, b))
