"""Levenberg-Marquardt trust-region schedule shared by the solvers
(counterpart of `monocular_slam_tpu/optim/lm.py`, g2o's LM rules). All
updates are branch-free tensor ops, so a solver loop adds no host syncs."""

from __future__ import annotations

from typing import NamedTuple

import torch


class LMState(NamedTuple):
    lam: torch.Tensor
    nu: torch.Tensor
    chi2: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor


def init_lambda(H_diag: torch.Tensor, tau: float = 1e-5) -> torch.Tensor:
    return tau * H_diag.max()


def gain_ratio(chi2_old, chi2_new, dx, b, lam):
    denom = (dx * (lam * dx + b)).sum() + 1e-30
    return (chi2_old - chi2_new) / denom


def lm_step_accept(lam, nu, rho, accepted):
    factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam_new = torch.where(accepted, lam * factor, lam * nu)
    nu_new = torch.where(accepted, torch.full_like(nu, 2.0), nu * 2.0)
    return lam_new, nu_new


def no_reduce(*tensors, op: str = "sum"):
    """The sum (or maximum) of partial results over the ranks that share a
    problem, for one process: each tensor as it is. The distributed solvers
    pass `parallel.distributed.all_reduce` over their group in its place;
    both return a tuple, or the one tensor."""
    return tensors if len(tensors) > 1 else tensors[0]
