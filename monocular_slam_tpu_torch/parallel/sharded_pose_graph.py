"""Distributed Sim(3) pose-graph optimization: edge-sharded CG (counterpart
of `monocular_slam_tpu/parallel/sharded_pose_graph.py`).

  - edges (odometry and loop closures) are split into contiguous slabs over
    the mesh's "model" axis; each rank linearizes its slab (the 7x7
    Jacobians are the operation-heavy part);
  - vertices (F, 3, 5) are replicated;
  - each PCG matvec sums over the rank's edges and then ONE (F, 7) vector
    over the group; the block-Jacobi preconditioner's (F, 7, 7) blocks, the
    gradient and chi2 are summed once per linearization. Communication is
    O(F), independent of the edge count.

The solver is `pose_graph.optimize_cg` on the rank's edge slab, with
`distributed.all_reduce` over the group as its `reduce`.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.distributed.device_mesh import DeviceMesh

from monocular_slam_tpu_torch.geometry import sim3
from monocular_slam_tpu_torch.optim import pose_graph as pg
from monocular_slam_tpu_torch.parallel.distributed import all_reduce
from monocular_slam_tpu_torch.parallel.mesh import model_axis


def partition_edges(g: pg.PoseGraph, n_shards: int) -> pg.PoseGraph:
    """Pad the edge arrays to a multiple of n_shards with invalid edges.
    Padding edges carry the identity Sim3 as their measurement: their weight
    is 0, but the residual's log still runs, and a zero (scale-0)
    measurement would give NaNs that no weight cancels."""
    E = g.i_idx.shape[0]
    E_pad = -(-E // n_shards) * n_shards

    def pad(a, fill):
        out = torch.full((E_pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
        out[:E] = a
        return out

    meas = pad(g.meas, 0.0)
    meas[E:] = sim3.identity(dtype=g.meas.dtype, device=g.meas.device)
    return g._replace(i_idx=pad(g.i_idx, 0), j_idx=pad(g.j_idx, 0), meas=meas,
                      weight=pad(g.weight, 0.0), valid=pad(g.valid, False),
                      robust=None if g.robust is None else pad(g.robust, False))


def distributed_optimize(g: pg.PoseGraph, mesh: DeviceMesh, n_iters: int = 20, tau: float = 1e-5,
                         max_cg_iters: int = 100, rtol: float = 1e-8) -> pg.PoseGraphResult:
    """Pose-graph LM with edges sharded over the mesh's "model" axis (no
    robust kernel, as the reference's). Every rank of the mesh calls it
    with the same graph and gets the full result; `n_iters_run` counts the
    LM iterations before the stall rule froze the loop."""
    group, shard, n_shards = model_axis(mesh)
    gp = partition_edges(g, n_shards)
    e_l = gp.i_idx.shape[0] // n_shards
    sl = slice(shard * e_l, (shard + 1) * e_l)
    g_l = pg.PoseGraph(gp.vertices, gp.i_idx[sl], gp.j_idx[sl], gp.meas[sl], gp.weight[sl],
                       gp.valid[sl], gp.fixed)
    return pg.optimize_cg(g_l, n_iters=n_iters, tau=tau, max_cg_iters=max_cg_iters, rtol=rtol,
                          reduce=partial(all_reduce, group))
