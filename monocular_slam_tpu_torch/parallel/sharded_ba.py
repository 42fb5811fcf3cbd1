"""Distributed global bundle adjustment: the landmark-sharded Schur reduction
(counterpart of `monocular_slam_tpu/parallel/sharded_ba.py`).

  - map points are partitioned into contiguous slabs, one per rank on the
    mesh's "model" axis; every BA edge lives with the rank that owns its
    landmark, so Hll and the landmark back-substitution are local;
  - pose blocks are replicated: Hpp, the reduced gradient and the Schur
    cross term are summed over the "model" group (`distributed.all_reduce`,
    the counterpart of `jax.lax.psum`);
  - every rank solves the same reduced pose system: the sums are identical
    on every rank, so no broadcast is needed;
  - the LM loop runs a fixed number of iterations, each decision a
    `torch.where`, so every rank issues the same collectives in the same
    order (no branch on a rank-local value).

The solves are the single-device ones (`ba._schur_solve`,
`cg_ba.make_cg_solve_fn`) on the rank's slab, with `distributed.all_reduce`
over the group as their `reduce`. Communication per LM iteration: dense,
one sum of the (F*6)^2 cross term plus O(F); CG, one (F, 6) sum per PCG
step plus O(F*36) per linearization. Neither depends on the number of
landmarks. The points come back in their original order with one sum of
the zero-filled (P_pad, 3) array, outside the LM loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from monocular_slam_tpu_torch.geometry import se3
from monocular_slam_tpu_torch.optim import ba as ba_mod
from monocular_slam_tpu_torch.optim import cg_ba, lm
from monocular_slam_tpu_torch.parallel.distributed import all_reduce
from monocular_slam_tpu_torch.parallel.mesh import model_axis


class ShardedBAResult(NamedTuple):
    poses: torch.Tensor
    points: torch.Tensor  # in ORIGINAL point order
    chi2_initial: torch.Tensor
    chi2_history: torch.Tensor
    n_iters_run: torch.Tensor


def partition_problem(prob: ba_mod.BAProblem, n_shards: int):
    """Pad points to a multiple of n_shards; group the valid edges by owning
    landmark slab (in their original order) and pad each group to the same
    length e_max >= 1 (cam 0, pt 0, uv 0, info 0, invalid). Points keep
    their ids: slabs are id ranges. Returns (padded problem, P)."""
    P_ = prob.points.shape[0]
    P_pad = -(-P_ // n_shards) * n_shards
    slab = P_pad // n_shards
    dev = prob.points.device
    owner = torch.clamp(torch.div(prob.pt_idx.long(), slab, rounding_mode="floor"), 0, n_shards - 1)
    key = torch.where(prob.valid, owner, n_shards)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(n_shards + 1, dtype=torch.long, device=dev)
    counts.index_add_(0, key, torch.ones_like(key))
    e_max = max(int(counts[:n_shards].max()), 1)  # the one host read: set-up, not solve
    start = torch.cat([counts.new_zeros(1), counts.cumsum(0)[:-1]])
    k_sorted = key[order]
    slot = k_sorted * e_max + torch.arange(key.shape[0], device=dev) - start[k_sorted]
    dest = torch.where(k_sorted < n_shards, slot, n_shards * e_max)  # dropped: a dump row

    def pad_field(a, fill):
        out = torch.full((n_shards * e_max + 1,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                         device=dev)
        out[dest] = a[order]
        return out[:-1]

    pts = torch.zeros((P_pad, 3), dtype=prob.points.dtype, device=dev)
    pts[:P_] = prob.points
    new = prob._replace(
        points=pts, cam_idx=pad_field(prob.cam_idx, 0), pt_idx=pad_field(prob.pt_idx, 0),
        uv=pad_field(prob.uv, 0.0), info=pad_field(prob.info, 0.0),
        valid=pad_field(prob.valid, False),
    )
    return new, P_


def _sharded_lm(poses, points_l, k, cam_idx_l, pt_idx_l, uv_l, info_l, valid_l, fixed, *,
                group, shard: int, n_iters: int, delta: float, tau: float, slab: int,
                solver: str = "dense", max_cg_iters: int = 100, cg_rtol: float = 1e-8):
    """One rank's LM program; everything suffixed _l is the rank's block."""
    dtype, dev = poses.dtype, poses.device
    psum = partial(all_reduce, group)
    # edge pt ids -> slab coordinates; foreign edges are invalid by
    # construction (partition_problem groups edges with their owner)
    pt_local = pt_idx_l.long() - shard * slab
    valid_l = valid_l & (pt_local >= 0) & (pt_local < slab)
    pt_local = torch.clamp(pt_local, 0, slab - 1)
    cam = cam_idx_l.long()
    local_prob = ba_mod.BAProblem(poses, points_l, k, cam, pt_local, uv_l, info_l, valid_l, fixed)

    def lin_graph(poses_c, points_c):
        lin = ba_mod._linearize_graph(local_prob, poses_c, points_c, delta)
        lin["chi2"], lin["Hpp"], lin["bp"] = psum(lin["chi2"], lin["Hpp"], lin["bp"])
        return lin

    solve = (partial(ba_mod._schur_solve, reduce=psum) if solver == "dense"
             else cg_ba.make_cg_solve_fn(max_cg_iters, cg_rtol, reduce=psum))

    lin0 = lin_graph(poses, points_l)
    hll_max = psum(torch.diagonal(lin0["Hll"], dim1=-2, dim2=-1).max().reshape(1), op="max")
    diag0 = torch.cat([torch.diagonal(lin0["Hpp"], dim1=-2, dim2=-1).reshape(-1), hll_max])
    st = lm.LMState(lm.init_lambda(diag0, tau), torch.tensor(2.0, dtype=dtype, device=dev),
                    lin0["chi2"], torch.tensor(0, dtype=torch.int32, device=dev),
                    torch.tensor(False, device=dev))
    poses_c, points_c = poses, points_l
    chi2_h = []
    for _ in range(n_iters):
        lin = lin_graph(poses_c, points_c)
        dxp, dxl, _ = solve(local_prob, lin, st.lam)
        poses_n = se3.compose(se3.exp(dxp), poses_c)
        points_n = points_c + dxl
        chi2_n, dxl2, dxl_bl = psum(ba_mod._chi2_graph(local_prob, poses_n, points_n, delta),
                                    (dxl * dxl).sum(), (dxl * lin["bl"]).sum())
        dx2 = (dxp * dxp).sum() + dxl2
        db = (dxp * lin["bp"]).sum() + dxl_bl
        rho = (lin["chi2"] - chi2_n) / (st.lam * dx2 + db + 1e-30)
        accept = (chi2_n < lin["chi2"]) & torch.isfinite(chi2_n)
        lam_n, nu_n = lm.lm_step_accept(st.lam, st.nu, rho, accept)
        stall = accept & (lin["chi2"] - chi2_n < 1e-6 * lin["chi2"])
        # a frozen run computes the step, issues its collectives, keeps nothing
        keep = accept & ~st.done
        poses_c = torch.where(keep, poses_n, poses_c)
        points_c = torch.where(keep, points_n, points_c)
        st = lm.LMState(torch.where(st.done, st.lam, lam_n), torch.where(st.done, st.nu, nu_n),
                        torch.where(keep, chi2_n, torch.where(st.done, st.chi2, lin["chi2"])),
                        st.it + 1, st.done | stall)
        chi2_h.append(st.chi2)
    return poses_c, points_c, lin0["chi2"], torch.stack(chi2_h), st.it


def distributed_bundle_adjust(prob: ba_mod.BAProblem, mesh: DeviceMesh,
                              n_iters: int = ba_mod.FULL_BA_ITER,
                              delta: float = ba_mod.THRESH_HUBER_FULL_BA, tau: float = 1e-5,
                              solver: str = "auto", max_cg_iters: int = 100,
                              cg_rtol: float = 1e-8) -> ShardedBAResult:
    """Global BA with landmarks sharded over the mesh's "model" axis: every
    rank of the mesh calls it with the same problem; each partitions it,
    runs the LM program on its slab and gets the full result.

    solver="dense": the replicated (F*6)^2 Cholesky, whose per-iteration
    collective is the whole (F*6, F*6) cross term; solver="cg": matrix-free
    block-Jacobi PCG (`optim/cg_ba.py`), one (F, 6) sum per PCG step;
    solver="auto": dense on <= 2 shards (all mesh ranks), cg beyond, the
    reference's measured crossover."""
    if solver == "auto":
        solver = "dense" if mesh.size() <= 2 else "cg"
    fn, args, P_orig = build_sharded_fn(prob, mesh, n_iters=n_iters, delta=delta, tau=tau,
                                        solver=solver, max_cg_iters=max_cg_iters, cg_rtol=cg_rtol)
    poses, points_l, chi2_0, chi2_h, it = fn(*args)
    group, shard, n_shards = model_axis(mesh)
    slab = points_l.shape[0]
    # the slabs back in original order: one sum of the zero-filled array
    full = torch.zeros((slab * n_shards, 3), dtype=points_l.dtype, device=points_l.device)
    full[shard * slab:(shard + 1) * slab] = points_l
    full = all_reduce(group, full, label="gather")
    return ShardedBAResult(poses, full[:P_orig], chi2_0, chi2_h, it)


def build_sharded_fn(prob: ba_mod.BAProblem, mesh: DeviceMesh, n_iters: int = ba_mod.FULL_BA_ITER,
                     delta: float = ba_mod.THRESH_HUBER_FULL_BA, tau: float = 1e-5,
                     solver: str = "dense", max_cg_iters: int = 100, cg_rtol: float = 1e-8):
    """(fn, args, P) for this rank's LM program: `fn(*args)` returns (poses,
    the rank's point slab, chi2_initial, chi2_history, n_iters_run). Split
    out so that tests can run it under `distributed.record_collectives` and
    check the communication contract."""
    group, shard, n_shards = model_axis(mesh)
    pprob, P_orig = partition_problem(prob, n_shards)
    slab = pprob.points.shape[0] // n_shards
    e_l = pprob.cam_idx.shape[0] // n_shards
    edges = slice(shard * e_l, (shard + 1) * e_l)
    fn = partial(_sharded_lm, group=group, shard=shard, n_iters=n_iters, delta=delta, tau=tau,
                 slab=slab, solver=solver, max_cg_iters=max_cg_iters, cg_rtol=cg_rtol)
    args = (pprob.poses, pprob.points[shard * slab:(shard + 1) * slab], pprob.k,
            pprob.cam_idx[edges], pprob.pt_idx[edges], pprob.uv[edges], pprob.info[edges],
            pprob.valid[edges], pprob.fixed)
    return fn, args, P_orig
