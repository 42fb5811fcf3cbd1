"""Matrix-free preconditioned-CG bundle adjustment for large graphs
(counterpart of `monocular_slam_tpu/optim/cg_ba.py`).

The dense Schur path (`optim/ba.py:_schur_solve`) materializes the
pose-landmark cross term as an (F*6, P*3) matrix. This module solves the
same damped, gauge-masked Schur system

    S dxp = b_red,   S = Hpp_d - W Hll_d^-1 W^T

without forming S: each product with S is two edge gathers, two segment
sums and batched 6x3 / 3x3 products, O(E) work and memory. The
preconditioner is block Jacobi on the exact 6x6 diagonal blocks of S.

`pcg` runs a fixed number of steps; once the residual converges (or turns
non-finite) the remaining steps compute and discard, every decision a
`torch.where` on a device flag, so a solve never syncs with the host. The
segment sums follow the linearization's sorted plans (`utils/scatter.py`),
so a solve gives the same bits on every run, on the card too.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from monocular_slam_tpu_torch.optim import ba as ba_mod
from monocular_slam_tpu_torch.optim.ba import _small_mv
from monocular_slam_tpu_torch.optim.lm import no_reduce
from monocular_slam_tpu_torch.utils.linalg import inv3x3
from monocular_slam_tpu_torch.utils.scatter import segment_sum


class CGStats(NamedTuple):
    n_iters: torch.Tensor  # steps run before the freeze
    rel_residual: torch.Tensor  # final ||r|| / ||b||


def _gauge_mask(x, free):
    """Zero the rows of x (F, 6) that belong to gauge-fixed poses."""
    return torch.where(free[:, None], x, 0.0)


def _wt_mv(W_e, x_e):
    """W_e^T x_e per edge: (E, 6, 3), (E, 6) -> (E, 3)."""
    return (W_e * x_e[..., None]).sum(-2)


def schur_matvec(prob: ba_mod.BAProblem, lin, Hll_inv, lam, free, x, reduce=no_reduce):
    """y = S x, x and y (F, 6); fixed poses act as identity rows. `reduce`
    sums the cross term's camera sums over the ranks that share the
    landmarks (`parallel/sharded_ba.py`)."""
    cam, pt = prob.cam_idx.long(), prob.pt_idx.long()
    xf = _gauge_mask(x, free)
    t1 = _small_mv(lin["Hpp"], xf) + lam * xf
    s_p = segment_sum(_wt_mv(lin["W_e"], xf[cam]), lin["pt_seg"])
    y_p = _small_mv(Hll_inv, s_p)
    t2 = reduce(segment_sum(_small_mv(lin["W_e"], y_p[pt]), lin["cam_seg"]))
    return _gauge_mask(t1 - t2, free) + torch.where(free[:, None], 0.0, x)


def schur_diag_blocks(prob: ba_mod.BAProblem, lin, Hll_inv, lam, reduce=no_reduce):
    """The 6x6 diagonal blocks of the damped Schur complement,
    D_f = Hpp_d[f] - sum_{e: cam(e) = f} W_e Hll_d^-1[pt(e)] W_e^T."""
    W = lin["W_e"]
    WHW_e = torch.matmul(torch.matmul(W, Hll_inv[prob.pt_idx.long()]), W.transpose(-1, -2))
    eye6 = torch.eye(6, dtype=W.dtype, device=W.device)
    return lin["Hpp"] + lam * eye6 - reduce(segment_sum(WHW_e, lin["cam_seg"]))


def pcg(matvec, precond_apply, b, max_iters: int, rtol: float):
    """Preconditioned conjugate gradient from x = 0 with a fixed trip count
    and freeze-on-converge. Returns (x, CGStats)."""
    bnorm = torch.sqrt((b * b).sum()) + 1e-30
    x = torch.zeros_like(b)
    r = b
    p = z = precond_apply(r)
    rz = (r * z).sum()
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    for _ in range(max_iters):
        Ap = matvec(p)
        pAp = (p * Ap).sum()
        alpha = rz / torch.where(pAp == 0, 1e-30, pAp)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = precond_apply(r_n)
        rz_n = (r_n * z_n).sum()
        beta = rz_n / torch.where(rz == 0, 1e-30, rz)
        p_n = z_n + beta * p
        rel = torch.sqrt((r_n * r_n).sum()) / bnorm
        x, r, p, rz = (torch.where(done, a, a_n) for a, a_n in ((x, x_n), (r, r_n), (p, p_n), (rz, rz_n)))
        it = it + (~done).to(torch.int32)
        done = done | (rel < rtol) | ~torch.isfinite(rel)
    return x, CGStats(it, torch.sqrt((r * r).sum()) / bnorm)


def make_cg_solve_fn(max_cg_iters: int = 100, rtol: float = 1e-8, reduce=no_reduce):
    """solve_fn(prob, lin, lam) -> (dxp, dxl, b_red) for
    `ba.bundle_adjust(..., solve_fn=...)`: block-Jacobi PCG on the Schur
    complement in place of the dense Cholesky. With `reduce`, `prob` holds
    one rank's landmarks and their edges, `lin`'s pose blocks are already
    summed over the ranks, and each camera sum is summed over them too: one
    (F, 6) `reduce` per PCG step."""

    def solve(prob: ba_mod.BAProblem, lin, lam):
        dt, dev = lin["Hpp"].dtype, lin["Hpp"].device
        prob = prob._replace(cam_idx=prob.cam_idx.long(), pt_idx=prob.pt_idx.long())
        cam, pt = prob.cam_idx, prob.pt_idx
        cam_seg, pt_seg = lin["cam_seg"], lin["pt_seg"]
        free = ~prob.fixed
        Hll_inv = inv3x3(lin["Hll"] + lam * torch.eye(3, dtype=dt, device=dev))

        # b_red = bp - W Hll^-1 bl, gauge-masked (the dense path's reduction)
        yb_p = _small_mv(Hll_inv, lin["bl"])
        wy = reduce(segment_sum(_small_mv(lin["W_e"], yb_p[pt]), cam_seg))
        b_red = _gauge_mask(lin["bp"] - wy, free)

        # fixed poses take an identity block; zero-observation poses keep
        # lam I from the damping. A singular block gives NaN (and a rejected
        # LM step), as the reference's `jnp.linalg.inv` does, without a sync.
        eye6 = torch.eye(6, dtype=dt, device=dev)
        D = torch.where(free[:, None, None],
                        schur_diag_blocks(prob, lin, Hll_inv, lam, reduce), eye6)
        D_inv, info = torch.linalg.inv_ex(D)
        D_inv = torch.where((info == 0)[:, None, None], D_inv, float("nan"))
        matvec = partial(schur_matvec, prob, lin, Hll_inv, lam, free, reduce=reduce)
        dxp, _ = pcg(matvec, lambda r: _gauge_mask(_small_mv(D_inv, r), free), b_red,
                     max_cg_iters, rtol)

        # landmarks by back-substitution: dxl = Hll^-1 (bl - W^T dxp)
        rhs_l = lin["bl"] - segment_sum(_wt_mv(lin["W_e"], dxp[cam]), pt_seg)
        return dxp, _small_mv(Hll_inv, rhs_l), b_red

    return solve


def bundle_adjust_cg(prob: ba_mod.BAProblem, n_iters: int = ba_mod.FULL_BA_ITER,
                     delta: float = ba_mod.THRESH_HUBER_FULL_BA, tau: float = 1e-5,
                     max_cg_iters: int = 100, rtol: float = 1e-8) -> ba_mod.BAResult:
    """The LM loop of `ba.bundle_adjust` with the dense Schur Cholesky
    replaced by matrix-free block-Jacobi PCG: memory O(E + F + P)."""
    return ba_mod.bundle_adjust(prob, n_iters=n_iters, delta=delta, tau=tau,
                                solve_fn=make_cg_solve_fn(max_cg_iters, rtol))
